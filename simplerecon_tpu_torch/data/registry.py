"""Dataset registry (counterpart of `simplerecon_tpu/data/registry.py`):
`get_dataset(name, split_file, single_debug_scan_id)` returns the dataset
class and the scan list.

"synthetic" (the rasterized room, no files) is ported. The file-backed
readers of the JAX package need an image decoder and wait for ROADMAP
Queue 1, item 3; asking for one raises `NotImplementedError`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

from simplerecon_tpu_torch.data import io as dio

# the JAX package's file-backed datasets, not ported yet
WAITING = ("scannet", "7scenes", "vdr", "arkit", "colmap", "scanniverse")


def _classes():
    from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
    return {"synthetic": SyntheticDataset}


def get_dataset(dataset_name: str,
                split_filepath: Optional[str] = None,
                single_debug_scan_id: Optional[str] = None,
                verbose: bool = True) -> Tuple[Type, List[str]]:
    """Returns (dataset_class, scan_names)."""
    if dataset_name in WAITING:
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported: its file reader waits "
            "for ROADMAP Queue 1, item 3")
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
