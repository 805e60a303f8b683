"""Dataset registry (counterpart of `simplerecon_tpu/data/registry.py`):
`get_dataset(name, split_file, single_debug_scan_id)` returns the dataset
class and the scan list.

"synthetic" is the rasterized room (no files); the others read scans from
disk in their dataset's layout, decoding images with `data/codec.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

from simplerecon_tpu_torch.data import io as dio


def _classes():
    from simplerecon_tpu_torch.data.arkit import ArkitDataset
    from simplerecon_tpu_torch.data.colmap import ColmapDataset
    from simplerecon_tpu_torch.data.scannet import ScannetDataset
    from simplerecon_tpu_torch.data.scanniverse import ScanniverseDataset
    from simplerecon_tpu_torch.data.seven_scenes import SevenScenesDataset
    from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
    from simplerecon_tpu_torch.data.vdr import VDRDataset
    return {
        "scannet": ScannetDataset,
        "7scenes": SevenScenesDataset,
        "vdr": VDRDataset,
        "arkit": ArkitDataset,
        "colmap": ColmapDataset,
        "scanniverse": ScanniverseDataset,
        "synthetic": SyntheticDataset,
    }


def get_dataset(dataset_name: str,
                split_filepath: Optional[str] = None,
                single_debug_scan_id: Optional[str] = None,
                verbose: bool = True) -> Tuple[Type, List[str]]:
    """Returns (dataset_class, scan_names)."""
    classes = _classes()
    if dataset_name not in classes:
        raise ValueError(f"unknown dataset {dataset_name!r}; "
                         f"available: {sorted(classes)}")
    scans: List[str] = []
    if split_filepath:
        scans = dio.readlines(split_filepath)
    if single_debug_scan_id is not None:
        scans = [s for s in scans if s == single_debug_scan_id] \
            or [single_debug_scan_id]
    if verbose:
        print(f"dataset: {dataset_name}, {len(scans)} scans")
    return classes[dataset_name], scans
