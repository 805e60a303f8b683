"""CLI: precompute per-scan `valid_frames.txt` files.

Counterpart of `simplerecon_tpu/scripts/precompute_valid_frames.py`:

    python -m simplerecon_tpu_torch.scripts.precompute_valid_frames \
        --data_config_file configs/data/scannet_default_train.yaml \
        --num_workers 16
"""

from __future__ import annotations

from functools import partial
from multiprocessing import Pool

from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.options import OptionsHandler


def process_scan(scan, opts, dataset_class):
    dataset = dataset_class(
        dataset_path=opts.dataset_path, split=opts.split,
        mv_tuple_file_suffix=None,
        tuple_info_file_location=opts.tuple_info_file_location or None)
    valid = dataset.get_valid_frame_ids(opts.split, scan,
                                        store_computed=True)
    print(f"{scan}: {len(valid)} valid frames")
    return scan, len(valid)


def main(opts):
    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    worker = partial(process_scan, opts=opts, dataset_class=dataset_class)
    if opts.num_workers <= 1:
        for scan in scans:
            worker(scan)
    else:
        with Pool(opts.num_workers) as pool:
            pool.map(worker, scans)


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
