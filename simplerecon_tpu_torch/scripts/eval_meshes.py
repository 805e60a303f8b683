"""Scores reconstructed meshes against GT meshes (counterpart of
`simplerecon_tpu/scripts/eval_meshes.py`): for each scan,
`<results>/meshes/<res>cm_<depth>m/<scan>.ply` against the dataset's GT
mesh, both sampled at a fixed seed: accuracy, completeness, chamfer,
precision, recall and F-score at 5 cm, per scan and averaged, written to
`<results>/scores/mesh_metrics.json`.

    python -m simplerecon_tpu_torch.scripts.eval_meshes \
        --config_file ... --data_config_file ...

Runs on the host; needs no card.
"""

from __future__ import annotations

import os

from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.fusion.mesh import read_ply
from simplerecon_tpu_torch.options import Options, OptionsHandler
from simplerecon_tpu_torch.utils.mesh_metrics import evaluate_mesh
from simplerecon_tpu_torch.utils.metrics import ResultsAverager


def main(opts: Options) -> ResultsAverager:
    results_path = os.path.join(opts.output_base_path, opts.name,
                                opts.dataset, opts.frame_tuple_type)
    mesh_dir = os.path.join(results_path, "meshes",
                            f"{int(opts.fusion_resolution * 100)}cm"
                            f"_{opts.fusion_max_depth}m")
    scores_dir = os.path.join(results_path, "scores")
    os.makedirs(scores_dir, exist_ok=True)

    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    dataset = dataset_class(
        dataset_path=opts.dataset_path, split=opts.split,
        mv_tuple_file_suffix=None,
        tuple_info_file_location=opts.tuple_info_file_location or None)

    averager = ResultsAverager(opts.name, "mesh metrics")
    for scan in scans:
        pred_path = os.path.join(mesh_dir, f"{scan}.ply")
        gt_path = dataset.get_gt_mesh_path(opts.dataset_path, opts.split,
                                           scan)
        if not os.path.exists(pred_path):
            print(f"{scan}: missing predicted mesh {pred_path}")
            continue
        if not os.path.exists(gt_path):
            print(f"{scan}: missing GT mesh {gt_path}")
            continue
        pv, pf = read_ply(pred_path)
        gv, gf = read_ply(gt_path)
        metrics = evaluate_mesh(pv, pf, gv, gf, seed=0)
        averager.update_results(metrics)
        print(f"{scan}: " + ", ".join(f"{k}={v:.4f}"
                                      for k, v in metrics.items()))

    averager.compute_final_average()
    averager.output_json(os.path.join(scores_dir, "mesh_metrics.json"))
    averager.pretty_print_results(print_running_metrics=False)
    return averager


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
