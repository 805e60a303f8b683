"""CLI: generate train/test multi-view tuple files.

Counterpart of `simplerecon_tpu/scripts/generate_tuples.py`; writes
`<tuple_info_file_location or dataset_path/tuples>/<split><suffix>`:

    python -m simplerecon_tpu_torch.scripts.generate_tuples \
        --data_config_file configs/data/scannet_default_test.yaml \
        --num_workers 16
"""

from __future__ import annotations

import functools
import os

from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.data.tuple_generation import crawl
from simplerecon_tpu_torch.options import OptionsHandler


def main(opts):
    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)

    # a partial, not a closure, so that worker processes can unpickle it;
    # the image size picks a scan's colour cached at that size
    dataset_factory = functools.partial(
        dataset_class, dataset_path=opts.dataset_path, split=opts.split,
        mv_tuple_file_suffix=None,
        tuple_info_file_location=opts.tuple_info_file_location or None,
        image_height=opts.image_height, image_width=opts.image_width)

    lines = crawl(scans, dataset_factory, opts.frame_tuple_type,
                  opts.num_images_in_tuple or opts.model_num_views,
                  opts.split, num_workers=opts.num_workers)

    out_dir = opts.tuple_info_file_location or os.path.join(
        opts.dataset_path, "tuples")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir,
                            f"{opts.split}{opts.mv_tuple_file_suffix}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} tuples to {out_path}")
    return out_path


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
