"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero, and only a run that passes them all prints the last line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the CUDA kernels from `simplerecon_tpu_torch/csrc`, timed,
   and of the eval path's native host libraries (`native/`, g++);
3. the fused sweep kernel against its plain PyTorch version at the hero
   shape (b=1, k=7, 96x128, c=16, d=64) and at a small odd shape, in
   float32 (TF32 off) and bf16, and at hero b=8 and b=16 (the training
   step's batch) in bf16, with CUDA-event times of both and the
   kernel's TFLOP/s and share of its bound; bf16 is also held against
   the float32 plain version;
4. the hero model (384x512, 8 views, 64 planes, bf16, seeded random
   weights) through `OnlineSession` over a 12-frame posed stream: outputs
   finite and of the right shapes, one kernel launch per answered frame,
   per-request latency;
5. the card against the CPU in float32 at a reduced size (192x256, hero
   widths): the kernel path against the plain path, same weights;
6. the sweep's backward kernel (K2, with the scatter that sums its d_src)
   against its plain PyTorch version at the hero shape (b=1) and the
   small odd shape, in float32 (TF32 off) and bf16, and at hero b=16 in
   bf16; bf16 judged against both the float32 and the bf16 plain
   backward; CUDA-event times of both, the kernel's TFLOP/s and share of
   its bound; all eight gradients, d_src included, bit-identical over two
   calls; the scatter alone against its plain version on seeded sample
   gradients of the same shape, with the cameras of both
   `testing.GEOMETRIES` (far apart, and as in training), bit-identical
   over two calls, the SHA-256 digest of d_src, how many (block, plane)
   pairs summed in a block's shared-memory window and how many went
   straight to device memory, its time and bound, and at b=16 one
   `index_add_` call on the same taps;
7. hero training on the card: 384x512, 8 views, 64 planes, bf16, batch
   16, one fixed seeded batch; 3 warm-up and 5 timed steps through
   `parallel/train.py::train_step`: losses and gradient norms finite,
   the loss lower than at the first step, K1, K2 and the scatter each
   launched once a step, parameters changed; median step time, peak
   memory, and a `torch.profiler` split of the device time over two
   more steps; then the same steps at a tenth of the learning rate, for
   the loss series;
8. the card against the CPU in float32 at 192x256 (hero widths): six
   training steps from the same init, batch and flip coins, with the
   first step's loss and the gradients of the sweep MLP, the first
   matching conv and a decoder head compared; then one step from a
   perturbed init (`spread_outputs_`), held to the spread that moving
   the input images by one float32 ulp causes on each device;
9. the dot-product sweep kernel (K1-dot) against its plain version at the
   small odd shape and hero b=1 in float32 (TF32 off) and bf16, and at
   hero b=8 and b=16 in bf16, bf16 also against the plain version on the
   unrounded float32 features; CUDA-event times of both and the bound;
   K1-dot's d_cur mode against its plain version, bit-identical over two
   calls, its time and bound; the dot backward (d_cur by that mode, d_src
   by the scatter) bit-identical over two calls, the scatter in its dot
   mode against its plain version in both geometries (digests and paths
   as in phase 6), and at b=16 the dot backward's time and the
   scatter's; over phases 6 and 9 both of the scatter's paths must run;
10. the stem pool kernels (K3-fwd, K3-bwd) against the plain chain and
   its autograd at `testing.POOL_CASES` (an odd shape, an odd H with
   16-byte rows, a width no column tile divides, a map off a 16-byte
   boundary, the encoder's b=1 shape) and the encoder's b=16 shape, in
   float32 and in the dtype the bf16 encoder hands the pool, on ReLU'd
   inputs with ties: values, identical gradient routing, times and
   bounds, and which staging path (16-byte or element-wise) each case
   took: both must run;
11. the dot-product model (bf16, `matching_pool_impl="pallas"`,
   `fast_cost_volume=True`) through `OnlineSession` over the 12-frame
   stream: outputs finite and of the right shapes, K1-dot and K3-fwd
   launched once per answered frame, K1, K2, K3-bwd and the scatter
   never; latency, then the hero and the dot model again in turns, and a
   profiled stream of each (device busy time, kernels and top host ops
   per request);
12. dot-product training, b16 bf16, one fixed batch, 3 warm-up and 5
   timed steps: finite losses and gradient norms, every parameter
   changed, K1-dot, its d_cur mode, K3-fwd, K3-bwd and the scatter once a
   step, K1 and K2 never, and no plain warp (`sweep_warp`) inside the dot
   backward; median step time, peak memory and a profiler split of
   device time that names the dot backward's share;
13. the card against the CPU in float32 at 192x256 (dot widths): the
   forward as in phase 5, and the first training step's loss, gradient
   norm and gradients of the first matching conv and a decoder head as
   in phase 8;
14. the hero model's inference-only kernels, K5 (metadata + MLP over a
   warped stack, backend "pallas_v1") and K4 (the full-width fused warp,
   "pallas_full"), against their plain versions at the small odd shape
   (N not a multiple of 64), at hero b=1 in float32 (TF32 off) and bf16,
   and at hero b=8 in bf16 (K5 at the 32 planes of one of its two
   launches there); CUDA-event times of both and the bound (in bf16 both
   run their MLP on the tensor cores, as K1 does);
15. the hero model (bf16, seeded weights with `spread_outputs_`) served
   through `OnlineSession` over the 12-frame stream with each of its
   three sweeps, "pallas" (K1), "pallas_v1" (the plain warp and K5) and
   "pallas_full" (K4), in turns: outputs finite and of the right shapes,
   K5 launched once per answer and plane chunk, K4 once per answer, K1
   only for "pallas", K2 never; request latency; the three sweeps' depth
   maps on the same frames against each other within a bf16 tolerance;
   then a b=8 forward of each, its time per frame and launches;
16. the card against the CPU in float32 at 192x256, as in phase 5, for
   "pallas_v1" and "pallas_full";
17. the eval CLI (`scripts/test.py`) as a user runs it: the hero YAML
   (bf16, b16, 384x512, 8 views, 64 planes, `xla_fused`), the 48-frame
   synthetic scene (41 tuples in batches of 16, 16, 9), metrics, TSDF
   fusion at 4 cm and 3 m, a PLY, cached depths: K1 launched once a
   batch and no other kernel, finite metrics JSONs and mesh; loader wait,
   forward ms per frame by CUDA events, metrics, TSDF, marching cubes and
   PLY times;
18. the scene's 48 GT depths fused on the card against the JAX
   package's grid, mesh counts and F1 against the room mesh
   (`testing.GT_FUSION`), with the TSDF's ms per frame;
19. the eval CLI on the card against the CPU in float32 at 192x256 (hero
   widths, 9 frames, seeded weights through a checkpoint): cached
   depths, metrics and meshes within `testing.EVAL_TOL`;
20. the training CLI (`scripts/train.py`) as a user runs it: the hero
   YAML (bf16, b16, 384x512, 8 views, 64 planes, `xla_fused`) on the
   synthetic scene, 12 steps, a log every 4 and a validation every 6
   over 1 batch: K1, K2 and the scatter once a step and K1 once a
   validation batch, no other kernel and no plain sweep; finite losses,
   the JSON-lines records with the JAX CLI's keys, panel PNGs that
   parse, rotation keeping `step_6` and `step_12`, `best/`; steps per
   second, the median step against phase 7's bare step, the loader
   wait, the ms of a checkpoint write and of a validation, peak memory;
21. resume and finetune: `step_6` restored into a fresh state gives the
   saved parameters, buffers, AdamW moments, counters and generator bit
   for bit; a run resumed from it goes on at step 7 and writes
   `step_12`; `--load_weights_from_checkpoint` loads its weights with a
   fresh optimizer;
22. the grand loop, short (`scripts/grand_loop.py --steps 100`, its own
   64x96, 4 views, 32 planes, b4): training, the eval CLI with fusion
   and the mesh's score chain together; finite summary numbers, a PLY;
23. the hero model with `matching_norm="group"`: one b16 bf16 step runs
   K1, K2 and the scatter once each, then two passes from one state
   give the same gradient bits;
24. the image codec on the card's host: `native/image_codec.cpp` built,
   the fixtures of `tests/data_torch/` (JPEGs at 4:4:4, 4:2:2 with
   restart markers, 4:2:0 and grey, a 968x1296 JPEG, 480x640 PNGs at 8
   and 16 bits) decoded to the SHA-256 digests of Pillow's decode; decode
   ms of the 968x1296 JPEG and the PNGs;
25. the eval CLI over a scan on disk: the 48-frame synthetic scene
   written in ScanNet's layout (`testing.write_scannet_scan`: 384x512
   colour PNGs, 480x640 millimetre depth PNGs, poses, intrinsics) with
   phase 17's 41 tuples; the port's `generate_tuples` writes its dense
   tuples; `scripts/test.py --dataset scannet` with the hero YAML and
   phase 17's seeded weights: K1 once a batch and no other kernel,
   finite metrics and a PLY, cached depths within `testing.EVAL_TOL` of
   phase 17's (and whether they are the same bits); loader wait per
   batch, decode ms per frame;
26. the scan's 48 depths read back through the ScanNet reader and fused
   on the card as in phase 18: F1 against the room mesh within 0.01 of
   phase 18's;
27. the training CLI over the scan: the port's `generate_tuples` with
   the train type, then `scripts/train.py --dataset scannet` at full
   width for 4 steps (batch 16, or the scan's tuple count when fewer):
   K1, K2 and the scatter once a step, no other kernel and no plain
   sweep, finite losses;
28. the hero model with the UNet matching encoder
   (`--matching_encoder_type unet_encoder`: mnasnet_100 and an FPN) at
   full width: the 12-frame stream through `OnlineSession` (K1 once an
   answer, nothing else; b1 ms), three b16 bf16 training steps (K1, K2
   and the scatter once a step; finite losses; step ms), two passes from
   one state with the same gradient bits, and card against CPU at
   192x256 float32 as phase 5;
29. `scripts/pc_fusion.py` as a user runs it: the hero YAML on the
   48-frame scene (41 tuples in batches of 16, 16, 9; K1 once a batch,
   nothing else), fusion thresholds loosened to 0.5 m and one agreeing
   frame (random weights predict rough depths), a PLY with points; the
   same predicted depths through the consistency pass on the card and
   on the CPU: keep masks differing at no more than 1e-4 of the pixels,
   voxel clouds of sizes within 0.1%; the pass's ms by CUDA events;
30. `scripts/visualize_live_meshing.py` on the same scene at b1 into a
   fresh directory (no cached depth): K1 once a keyframe (41), two mp4s
   that OpenCV reads back with one frame a keyframe that has a mesh,
   frames in [0, 1]; ms a keyframe;
31. `scripts/generate_gt_min_max_cache.py`, then
   `scripts/visualize_scene_depth_output.py` over phase 17's cached
   depths: no kernel, 41 frames whose sides are multiples of 16, an mp4
   that reads back;
32. the hero b16 bf16 training step through
   `parallel/train.py::ddp_train_step` at world size 1 over NCCL: losses,
   gradient norm, every gradient, parameter and buffer the same bits as
   `train_step`'s; step ms of both;
33. two ranks sharing the card over gloo (NCCL takes one rank a card):
   the hero at full width, global batch 16 (8 a rank), bf16, 2 steps
   (`testing.run_ddp_steps`): K1, K2 and the scatter once per rank per
   step, the ranks' parameters and buffers the same bits, the result
   within DDP_SHARED_TOL of the single-process mean of the two b8 halves
   (and whether it is the same bits); step ms and peak memory per rank;
34. the training CLI with `--num_devices 2` on the shared card (4 steps,
   `backend="gloo"`): K1, K2 and the scatter once per rank per step, K1
   once more for rank 0's validation batch, the JSON lines, a checkpoint
   the single-device restore reads; then the eval CLI with
   `--data_parallel_eval` over ["cuda:0", "cuda:0"] on the 41-frame
   scene: K1 once a shard, depths within DP_EVAL_L2_TOL of phase 17's;
35. a `.sens` file's colour exported at 480x640, every JPEG the bytes
   Pillow writes (`tests/data_torch/jpeg_encode.json`), and an
   ios-logger capture written on the machine through
   `scripts/preprocess_ios_logger.py`; ms a frame of each.
Phases 7, 12, 23 and 28 end with two forward-and-backward passes from
one state whose gradients must be the same bits. The run prints the
time of phases 20-23, of phases 24-27, of phases 28-31, of phases 32-35
and its total.

The line before the last is the kernel report as JSON (the seven
kernels that replace the TPU kernels, the scatter that sums K2's d_src
and K1-dot's d_cur mode; K1, K2, the scatter (K2's mode, the training
geometry), K1-dot, its d_cur mode and K3 at the shapes their training
path gives them, K4 and K5 at hero b=8 inference); the last line is
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

import contextlib
import copy
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device; none is available")

# the port is imported only once a card is known to be there
from simplerecon_tpu_torch.models.depth_model import \
    build_depth_model  # noqa: E402
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder  # noqa: E402
from simplerecon_tpu_torch.online import \
    OnlineSession, make_batch  # noqa: E402
from simplerecon_tpu_torch.ops import (  # noqa: E402
    _build, cuda_cv, early_sweeps, launch_counts, pool)
from simplerecon_tpu_torch.ops import cost_volume as cv_ops  # noqa: E402
from simplerecon_tpu_torch.parallel import mesh, train  # noqa: E402
from simplerecon_tpu_torch import native  # noqa: E402
from simplerecon_tpu_torch import tracing  # noqa: E402
from simplerecon_tpu_torch.data import codec, synthetic  # noqa: E402
from simplerecon_tpu_torch.data.io import readlines  # noqa: E402
from simplerecon_tpu_torch.data.scannet import ScannetDataset  # noqa: E402
from simplerecon_tpu_torch.data.sens_reader import SensorData  # noqa: E402
from simplerecon_tpu_torch.data.synthetic import make_room_mesh  # noqa: E402
from simplerecon_tpu_torch.fusion.fusers import OurFuser  # noqa: E402
from simplerecon_tpu_torch.fusion.mesh import read_ply  # noqa: E402
from simplerecon_tpu_torch.options import OptionsHandler  # noqa: E402
from simplerecon_tpu_torch.scripts import determinism  # noqa: E402
from simplerecon_tpu_torch.fusion import point_cloud  # noqa: E402
from simplerecon_tpu_torch.models.matching_encoder import \
    UNetMatchingEncoder  # noqa: E402
from simplerecon_tpu_torch.scripts import \
    generate_gt_min_max_cache  # noqa: E402
from simplerecon_tpu_torch.scripts import pc_fusion  # noqa: E402
from simplerecon_tpu_torch.scripts import \
    visualize_live_meshing as live_meshing  # noqa: E402
from simplerecon_tpu_torch.scripts import \
    visualize_scene_depth_output as depth_video  # noqa: E402
from simplerecon_tpu_torch.scripts import generate_tuples  # noqa: E402
from simplerecon_tpu_torch.scripts import test as eval_cli  # noqa: E402
from simplerecon_tpu_torch.scripts import grand_loop  # noqa: E402
from simplerecon_tpu_torch.scripts import \
    preprocess_ios_logger  # noqa: E402
from simplerecon_tpu_torch.scripts import train as train_cli  # noqa: E402
from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from simplerecon_tpu_torch.utils.checkpoint import \
    save_weights  # noqa: E402
from simplerecon_tpu_torch.utils.mesh_metrics import \
    evaluate_mesh  # noqa: E402
from simplerecon_tpu_torch.testing import (  # noqa: E402
    GEOMETRIES, GT_FUSION, POOL_CASES, SCAN_ID, SWEEP_GRAD_NAMES,
    TUPLE_SUFFIX, compare_cached_depths, compare_meshes, compare_metrics,
    compare_scan_depths, dot_case,
    dot_options, hero_options, plane_ratio, synthetic_gt_bounds,
    synthetic_gt_frames, pool_case, pool_cotangent, posed_stream,
    compare_depth_maps, compare_ranks, relative_errors, run_ddp_steps,
    scatter_case,
    shard_mean_steps,
    shifted, spread_outputs_, stack_case, sweep_case, sweep_cotangent,
    synthetic_tuples, train_batch, warp_case, write_ios_capture,
    write_scannet_scan, write_sens, write_tuples)

KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# K1 in bf16 against the float32 plain version, relative L2: bf16 rounds
# the 202-channel input and both hidden layers (2^-9 relative each)
K1_BF16_L2_TOL = 2e-2
SIGNAL_FRACTION = 0.02   # card vs CPU: max |diff| <= 2% of the CPU map's std
MIN_STD = 1e-2
# K2 against its plain version (tests/test_torch_port_gpu.py gives the
# reasons): float32 max-relative at the odd shape; relative L2 per
# gradient against the float32 plain backward; bf16 kernel against the
# bf16 plain backward (the same rounding points)
BWD_MAX_TOL = 1e-4
BWD_L2_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.1}
BWD_SAME_ROUNDING_TOL = 2e-2
# card against CPU for float32 training steps: the first step's loss and
# grad norm, and the relative L2 distance of each compared gradient
# (float32 sums in another order through train-mode batch norms,
# max-pool ties and leaky-ReLU slopes; on these inputs the CPU alone, 8
# threads against 1, moves them by up to 1.5e-3). The second step's loss
# is held at 1e-3: Adam's first update is about lr * sign(grad), and a
# gradient near zero takes either sign. Later steps drift apart, as
# they do between two CPU thread counts, and are only printed.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3
TRAIN_LOSS2_RTOL = 1e-3
TRAIN_GRAD_TOL = 2e-2
# from a perturbed init the gradient is ill-conditioned: scaling the
# input images by (1 + 2^-23) moves it by the "ulp spread"; the card is
# held to ULP_FACTOR times the larger of the two devices' spreads
ULP_FACTOR = 2.0
TRAIN_STEPS, WARMUP_STEPS, TRAIN_BATCH = 8, 3, 16
CHECK_STEPS, CHECK_BATCH = 6, 2
HERO_SWEEP = (7, 96, 128, 16, 64)   # k, h, w, c, d of the hero sweep
STEM = (64, 192, 256)               # c, h, w at the stem pool, per view
HERO_COMPARED = ("cost_volume.mlp.net.0.weight",
                 "matching_model.net.0.weight",
                 "depth_decoder.convs.output_0.1.weight")
DOT_COMPARED = HERO_COMPARED[1:]
# K1-dot against its plain version: neither rounds inside (both sample
# the compute-dtype maps in float32 and dot in float32), so the same
# tolerance holds in both dtypes; bf16 against the plain version on the
# unrounded float32 features, relative L2: the features' one rounding
# (2^-9 relative)
DOT_TOL = 1e-4
DOT_BF16_L2_TOL = 2e-2
# the scatter against its plain version, which sums the same fixed-point
# integers over taps from a projection whose float32 sums run in another
# order (tests/test_torch_port_gpu.py): max |diff| <= SCATTER_TOL *
# max(1, max |plain|)
SCATTER_TOL = 1e-4
# K1-dot's d_cur mode against its plain version: the same float32
# products of the same bf16 or float32 features, summed in another order
# over taps whose coordinates round differently (tests/
# test_torch_port_gpu.py): max |diff| <= DCUR_TOL * max(1, max |plain|)
DCUR_TOL = 1e-4
# K3 (tests/test_torch_port_gpu.py gives the reasons): float32 max
# |kernel - plain| <= POOL_TOL * max(1, max |plain|); bf16 elementwise
# within POOL_BF16_REL of the float32 chain on the same values
POOL_TOL = 1e-5
POOL_BF16_REL = 2.0 ** -8
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores, float32
# CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# the hero model's three sweeps against each other in bf16 (phase 15):
# the relative L2 distance of the s0 log-depth maps to the spread of the
# K1 map, and the share of pixels whose lowest-cost depth (an argmax over
# the planes) agrees. The sweeps round at different points (K1 dots
# unrounded samples, K5 rounded ones, K4 rounds its y-tap weights), each
# by up to 2^-9 relative, and the bf16 encoder and decoder carry the
# difference on: measured 4.6e-2 and 98.8% on an H100 80GB HBM3 at 700 W
# (this phase's output). A wrong sweep is off by O(1).
SWEEPS_L2_TOL = 0.1
SWEEPS_LOWEST_AGREE = 0.9
# each wrapper's launch counter, by the kernel's name in PERF.md
COUNTERS = {"K1": cuda_cv.fused_sweep, "K2": cuda_cv.fused_sweep_bwd,
            "scatter": cuda_cv.sweep_scatter,
            "K1-dot": cuda_cv.dot_sweep,
            "K1-dot d_cur": cuda_cv.dot_sweep_dcur,
            "K3-fwd": pool.max_blur_pool,
            "K3-bwd": pool.max_blur_pool_bwd,
            "K5": early_sweeps.fused_feature_volume,
            "K4": early_sweeps.fused_warp_feature_volume}


def reset_launches():
    tracing.reset_counters()


def launched(fn) -> int:
    """The launches the wrapper `fn` has counted since the last reset."""
    return launch_counts()[fn.__name__]


def launches() -> dict:
    return {name: launched(fn) for name, fn in COUNTERS.items()}


def assert_launches(counts: dict, expected: dict):
    """Every kernel named in `expected` launched that often; every other
    kernel never."""
    want = {name: expected.get(name, 0) for name in COUNTERS}
    assert counts == want, (counts, want)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol (its nested names are
    length-prefixed), with <bf16> or <float> for a template on the
    dtype."""
    i = 3 if mangled.startswith("_ZN") else 2
    while True:
        digits = re.match(r"\d+", mangled[i:])
        if digits is None:
            return mangled
        j = i + digits.end()
        name = mangled[j:j + int(digits.group())]
        i = j + len(name)
        if name.endswith("_kernel"):
            args = mangled[i:]
            return (name + ("<bf16>" if args.startswith("I13__nv_bfloat16")
                            else "<float>" if args.startswith("If") else "")
                    + ((" (d_cur)" if name.startswith("fused_sweep_dot")
                        else " (dot)")
                       if "Lb1E" in args.split("Ev")[0] else ""))


def phase_build():
    lib, seconds = _build.build()
    cuda_cv_lib = _build.load_library()
    for entry in ("fused_sweep_mlp", "fused_sweep_mlp_bwd", "sweep_scatter",
                  "fused_sweep_dot", "fused_sweep_dot_cur_grad",
                  "max_blur_pool_fwd", "max_blur_pool_bwd",
                  "fused_feature_volume", "fused_warp_feature_volume"):
        assert getattr(cuda_cv_lib, entry) is not None, entry
    print(f"[build] {lib.name}: nvcc {seconds:.2f} s")
    for name in ("rasterizer", "marching_cubes"):   # the eval path's host
        t0 = time.perf_counter()                     # kernels
        native_lib = native.load_library(name)
        print(f"[build] {native_lib._name}: g++ and load "
              f"{time.perf_counter() - t0:.2f} s")
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        # per kernel: "Compiling entry function '<mangled>'", then its
        # spill line, then its register line
        entry, spills = "?", ""
        for line in ptxas.read_text().splitlines():
            if "Compiling entry" in line:
                entry = kernel_name(line.split("'")[1])
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"[build] ptxas: {entry}: {line.split(':', 1)[-1]
                                                 .strip()}; {spills}")
    return seconds


def phase_kernel(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    fp32_bf16 = (torch.float32, torch.bfloat16)
    for name, shape, dtypes in (
            ("odd", (2, 3, 13, 21, 8, 5), fp32_bf16),
            ("hero_b1", (1,) + HERO_SWEEP, fp32_bf16),
            ("hero_b8", (8,) + HERO_SWEEP, (torch.bfloat16,)),
            (f"hero_b{TRAIN_BATCH}", (TRAIN_BATCH,) + HERO_SWEEP,
             (torch.bfloat16,))):
        for dtype in dtypes:
            args = sweep_case(*shape, dtype=dtype, device=device, seed=1)
            before = launched(cuda_cv.fused_sweep)
            with torch.no_grad():
                got = cuda_cv.fused_sweep(*args)
                want = cuda_cv.fused_sweep_reference(*args)
            torch.cuda.synchronize()
            assert launched(cuda_cv.fused_sweep) == before + 1
            b, k, h, w, c, d = shape
            assert got.shape == (b, d, h * w), got.shape
            assert torch.isfinite(got).all()
            err = (got - want).abs().max().item()
            tol = KERNEL_TOL[dtype] * max(1.0, want.abs().max().item())
            with torch.no_grad():
                ms = cuda_ms(lambda: cuda_cv.fused_sweep(*args), reps=20)
                plain_ms = cuda_ms(
                    lambda: cuda_cv.fused_sweep_reference(*args), reps=5)
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            bound = bound_ms(shape, dtype, backward=False)
            print(f"[kernel] {tag}: shape {shape} max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}) kernel {ms:.3f} ms "
                  f"plain {plain_ms:.3f} ms; "
                  + rate_line(shape, dtype, False, ms, bound))
            assert err <= tol, (tag, err, tol)
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    want = cuda_cv.fused_sweep_reference(
                        *[a.float() for a in args])
                rel = ((got - want).norm() / want.norm()).item()
                print(f"[kernel] {tag} vs float32 plain: L2-rel {rel:.2e} "
                      f"(tol {K1_BF16_L2_TOL:.0e})")
                assert rel <= K1_BF16_L2_TOL, (tag, rel)
            report[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound=bound)
    return report


def check_answers(answers, opts):
    """Every answer's depth maps finite and of the right shapes, with the
    lowest-cost depth and the boolean source mask at 1/4 resolution."""
    h, w = opts.image_height, opts.image_width
    for out in answers:
        for i in range(4):
            for key in (f"log_depth_pred_s{i}_bhw1", f"depth_pred_s{i}_bhw1"):
                assert out[key].shape == (1, h >> (i + 1), w >> (i + 1), 1)
                assert np.isfinite(out[key]).all(), key
        assert out["lowest_cost_bhw"].shape == (1, h // 4, w // 4)
        assert out["overall_mask_bhw"].shape == (1, h // 4, w // 4)
        assert out["overall_mask_bhw"].dtype == bool


def serve(opts, model, tag: str) -> tuple:
    """The 12-frame posed stream through `OnlineSession`, with the launch
    counters set to 0 just before: (answers, per-request ms, launches)."""
    session = OnlineSession(opts, model)
    frames = posed_stream(12, opts.image_height, opts.image_width, seed=2)
    reset_launches()
    latencies, answers = [], []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = session.process_frame(frame)
        if out is not None:
            latencies.append((time.perf_counter() - t0) * 1e3)
            answers.append(out)
    counts = launches()
    assert len(answers) >= 3, len(answers)
    check_answers(answers, opts)
    print(f"[{tag}] {len(frames)} frames, {len(answers)} answered, "
          f"kernel launches {counts}; request latency ms "
          f"median {statistics.median(latencies):.2f} "
          f"(first {latencies[0]:.2f}, all "
          f"{', '.join(f'{x:.2f}' for x in latencies)}); "
          f"overall_mask mean {answers[-1]['overall_mask_bhw'].mean():.3f}")
    return answers, latencies, counts


def phase_hero(device) -> int:
    opts = hero_options()
    model = build_depth_model(opts, device=device, seed=0)
    assert model.compute_dtype == torch.bfloat16
    answers, _, counts = serve(opts, model, "hero")
    assert_launches(counts, {"K1": len(answers)})
    return counts["K1"]


def phase_card_vs_cpu(device, opts, tag: str):
    """The model of `opts` (float32, reduced size) on the card and on the
    CPU, same weights and frames: volume and log-depth maps within 2% of
    the CPU map's std."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model = spread_outputs_(build_depth_model(opts, device="cpu", seed=5),
                                seed=5)
    gpu_model = build_depth_model(opts, device=device, seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    frames = posed_stream(8, opts.image_height, opts.image_width, seed=3)
    results = {}
    for dev_tag, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        cur, src = make_batch(frames[7], frames[:7], opts.matching_scale,
                              next(model.parameters()).device)
        captured = {}
        hook = model.cost_volume.register_forward_hook(
            lambda mod, args, out: captured.update(volume=out[0]))
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model(cur, src, return_mask=True)
        out = {k: v.cpu() for k, v in out.items()}
        out["cost_volume_bhwd"] = captured["volume"].cpu()
        hook.remove()
        print(f"[{tag}] {dev_tag} forward {time.perf_counter() - t0:.2f} s")
        results[dev_tag] = out
    for key in ["cost_volume_bhwd"] + [f"log_depth_pred_s{i}_bhw1"
                                       for i in range(4)]:
        ref, got = results["cpu"][key], results["gpu"][key]
        std = ref.std().item()
        err = (got - ref).abs().max().item()
        print(f"[{tag}] {key}: max_abs_err {err:.3e} std {std:.3e} "
              f"ratio {err / std:.2e}")
        assert std >= MIN_STD, (key, std)
        assert err <= SIGNAL_FRACTION * std, (key, err, std)
    agree = (results["cpu"]["overall_mask_bhw"]
             == results["gpu"]["overall_mask_bhw"]).float().mean().item()
    print(f"[{tag}] overall_mask agreement {agree:.5f}")


def sweep_work(shape, dtype, backward: bool) -> tuple:
    """(operations, bytes) that one call of K1 (or K2) must do at `shape`:
    the MLP products per (pixel, plane) (K2: the recomputed forward, then
    d_w2, d_w1, d_h0, d_w0, and d_x over the sampled, reference and dot
    rows), and each input read and output written once."""
    b, k, h, w, c, d = shape
    n, hid = h * w, cuda_cv.HIDDEN
    cin = cuda_cv.mlp_in_channels(k, c)
    fwd = 2 * (cin * hid + hid * hid + hid)
    cells = b * d * n
    esize = torch.tensor([], dtype=dtype).element_size()
    feats = (b * k * n * c + b * n * c) * esize
    weights = (cin * hid + hid * hid + hid) * esize
    if not backward:
        return fwd * cells, feats + weights + cells * 4
    bwd = fwd + 2 * hid + 2 * (hid * hid) * 2 + 2 * cin * hid \
        + 2 * ((k + 1) * c + k) * hid
    grads = (b * k * n * c + b * n * c) * 4 + (cin * hid + hid * hid
                                               + 3 * hid + 1) * 4
    return bwd * cells, feats + 2 * weights + cells * 4 + grads


def work_bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    """The least time the card could take for `flops` operations at
    `peak_flops` and `nbytes` of device memory traffic, in ms, and what
    bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def bound_ms(shape, dtype, backward: bool) -> tuple:
    """K1's (or K2's) bound at `shape`: its MLP runs at the peak of the
    inputs' type."""
    return work_bound(*sweep_work(shape, dtype, backward), PEAK_FLOPS[dtype])


def rate_line(shape, dtype, backward: bool, ms: float, bound: tuple) -> str:
    """K1's (or K2's) achieved rate at `shape` and its share of the
    bound, for a kernel time of `ms`."""
    flops = sweep_work(shape, dtype, backward)[0]
    return (f"{flops / ms / 1e9:.2f} TFLOP/s, {bound[0] / ms:.4f} of the "
            f"bound ({bound[0]:.4f} ms by {bound[1]})")


def dot_sweep_work(shape, dtype) -> tuple:
    """(operations, bytes, tap bytes) of one K1-dot call at `shape`. The
    operations are the least the function needs per (view, plane, pixel):
    the projection (9 FMAs), c dot FMAs for each of the four taps and 4
    to weight them (mask * sum_t w_t <tap_t, cur>), and about 16 more
    (divide, tap weights, mask). Bytes: each input read and the float32
    output written once. Tap bytes: the four taps' c channels a sample,
    read through L1 and L2."""
    b, k, h, w, c, d = shape
    n = h * w
    esize = torch.tensor([], dtype=dtype).element_size()
    samples = b * d * n * k
    nbytes = ((b * k * n * c + b * n * c) * esize + b * d * n * 4
              + (2 * b * k * 16 + b * 16 + b * d) * 4)
    return (samples * (2 * (9 + 4 * c + 4) + 16), nbytes,
            samples * 4 * c * esize)


def dcur_work(shape, dtype) -> tuple:
    """(operations, bytes) of one call of K1-dot's d_cur mode at `shape`:
    per (view, plane, pixel) the projection (9 FMAs), m * w_q for the four
    taps (5 products), c FMAs for each tap and about 16 more operations
    (divide, tap weights, mask); each input (the source maps, g) read and
    d_cur (b, N, c) float32 written once."""
    b, k, h, w, c, d = shape
    n = h * w
    esize = torch.tensor([], dtype=dtype).element_size()
    samples = b * d * n * k
    nbytes = (b * k * n * c * esize + b * d * n * 4 + b * n * c * 4
              + (2 * b * k * 16 + b * 16 + b * d) * 4)
    return samples * (2 * (9 + 4 * c) + 5 + 16), nbytes


def pool_work(shape, dtype, backward: bool) -> tuple:
    """(operations, bytes) of one K3 call on an NCHW input of `shape`:
    three compares per 2x2 window and the 16-tap blur (or its transpose,
    and one add a routed window) per output; the forward reads x and
    writes out, the backward reads x and g and writes dx."""
    b, c, h, w = shape
    ho, wo = pool.output_size(h, w)
    planes = b * c
    windows, outs, ins = (planes * (h - 1) * (w - 1), planes * ho * wo,
                          planes * h * w)
    esize = torch.tensor([], dtype=dtype).element_size()
    if not backward:
        return windows * 3 + outs * 32, (ins + outs) * esize
    return windows * 4 + outs * 32, (2 * ins + outs) * esize


def scatter_work(shape, dtype, dot: bool) -> tuple:
    """(operations, bytes) of one scatter call at a sweep `shape`: per
    (sample, tap, channel) with a nonzero tap weight two products, the
    conversion and the add (the dot mode one product more per sample
    and channel), and each input read and d_src written once (K2's sample
    gradients (b, k, d, N, c); the dot model's g and cur)."""
    b, k, h, w, c, d = shape
    n = h * w
    esize = torch.tensor([], dtype=dtype).element_size()
    samples = b * k * d * n
    ops = samples * c * (4 * 4 + (1 if dot else 0))
    inputs = (b * d * n * 4 + b * n * c * esize if dot
              else samples * c * esize)
    geometry = (b * k * 16 + b * 16 + b * d + 1) * 4
    return ops, inputs + geometry + b * k * n * c * 4


def index_add_ms(args, grads, reps: int) -> float:
    """CUDA-event ms of one `index_add_` call that sums the same
    contributions (precomputed rows and float32 values of all four taps,
    from the plain version's projection) into d_src: the PyTorch call
    that the scatter stands in for."""
    proj, invK, planes, _, h, w = args
    samples = "d_s_bkdNc" in grads
    pix, mask = cuda_cv._project(proj, invK, planes, h, w)
    if samples:
        d_s = grads["d_s_bkdNc"].float()
    else:
        d_s = ((mask * grads["g_bdN"][:, None])[..., None]
               * grads["cur_bNc"].float()[:, None, None])
    b, k, _, n, c = d_s.shape
    size = d_s.numel() // c
    idx = torch.empty(4 * size, dtype=torch.int64, device=d_s.device)
    vals = torch.empty((4 * size, c), dtype=torch.float32, device=d_s.device)
    for t, (rows, wgt) in enumerate(cuda_cv._taps(pix, h, w)):
        idx[t * size:(t + 1) * size] = rows.reshape(-1)
        vals[t * size:(t + 1) * size] = (d_s * wgt[..., None]).reshape(-1, c)
    del d_s, pix, mask, rows, wgt
    out = torch.zeros((b * k * n, c), dtype=torch.float32, device=idx.device)
    ms = cuda_ms(lambda: out.index_add_(0, idx, vals), reps=reps, warmup=1)
    del idx, vals, out
    torch.cuda.empty_cache()
    return ms


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    data = t.detach().cpu().contiguous().flatten().view(torch.uint8)
    return hashlib.sha256(data.numpy().tobytes()).hexdigest()[:16]


# (block, plane) pairs of the scatter's two paths over phases 6 and 9:
# summed in a block's shared-memory window, added straight to device
# memory
SCATTER_PATHS = [0, 0]


def check_scatter(shape, dtype, device, dot: bool, tag: str,
                  library: bool = False) -> dict:
    """The scatter against its plain version on seeded gradients at a
    sweep `shape`, with the cameras of each of `GEOMETRIES`, bit-identical
    over two calls; the digest of d_src, the planes of each path, its
    time, the plain version's, its bound and, with `library`, one
    `index_add_` call's. Returns the numbers of the "close" geometry (the
    training batch's cameras)."""
    for geometry in GEOMETRIES:
        args, grads = scatter_case(*shape, dtype=dtype, device=device,
                                   seed=1, dot=dot, geometry=geometry)
        before = launched(cuda_cv.sweep_scatter)
        got = cuda_cv.sweep_scatter(*args, **grads)
        paths = cuda_cv.sweep_scatter.paths.tolist()
        again = cuda_cv.sweep_scatter(*args, **grads)
        want = cuda_cv.sweep_scatter_reference(*args, **grads)
        torch.cuda.synchronize()
        assert launched(cuda_cv.sweep_scatter) == before + 2
        assert torch.isfinite(got).all()
        assert torch.equal(got, again), tag
        SCATTER_PATHS[0] += paths[0]
        SCATTER_PATHS[1] += paths[1]
        err = (got - want).abs().max().item()
        tol = SCATTER_TOL * max(1.0, want.abs().max().item())
        out = digest(got)
        del got, again, want
        ms = cuda_ms(lambda: cuda_cv.sweep_scatter(*args, **grads), reps=10)
        plain_ms = cuda_ms(lambda: cuda_cv.sweep_scatter_reference(
            *args, **grads), reps=3, warmup=1)
        library_ms = (index_add_ms(args, grads, reps=3)
                      if library and geometry == "close" else None)
        ops, nbytes = scatter_work(shape, dtype, dot)
        bound = work_bound(ops, nbytes, PEAK_FLOPS[torch.float32])
        print(f"[scatter] {tag}{' dot' if dot else ''} {geometry}: shape "
              f"{shape} max_abs_err {err:.3e} (tol {tol:.1e}); two calls "
              f"bit-identical; d_src {out}; window/global planes "
              f"{paths[0]}/{paths[1]}; kernel {ms:.3f} ms plain "
              f"{plain_ms:.3f} ms"
              + (f" index_add_ {library_ms:.3f} ms" if library_ms else "")
              + f"; bound {bound[0]:.4f} ms by {bound[1]} "
              f"({ops / 1e9:.2f} GOP, {nbytes / 1e6:.1f} MB)")
        assert err <= tol, (tag, geometry, err, tol)
        del args, grads
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                library_ms=library_ms)


def phase_backward(device) -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, scatter = {}, {}
    fp32_bf16 = (torch.float32, torch.bfloat16)
    for name, shape, dtypes in (
            ("odd", (2, 3, 13, 21, 8, 5), fp32_bf16),
            ("hero_b1", (1,) + HERO_SWEEP, fp32_bf16),
            (f"hero_b{TRAIN_BATCH}", (TRAIN_BATCH,) + HERO_SWEEP,
             (torch.bfloat16,))):
        b, k, h, w, c, d = shape
        g = sweep_cotangent(b, d, h * w, device, seed=2)
        for dtype in dtypes:
            args = sweep_case(*shape, dtype=dtype, device=device, seed=1)
            before = (launched(cuda_cv.fused_sweep_bwd),
                      launched(cuda_cv.sweep_scatter))
            got = cuda_cv.fused_sweep_bwd(*args, g)
            again = cuda_cv.fused_sweep_bwd(*args, g)
            torch.cuda.synchronize()
            assert (launched(cuda_cv.fused_sweep_bwd),
                    launched(cuda_cv.sweep_scatter)) == (before[0] + 2,
                                                        before[1] + 2)
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            for grad, x, y in zip(SWEEP_GRAD_NAMES, got, again):
                assert torch.equal(x, y), (tag, grad)
            del again
            want = cuda_cv.fused_sweep_backward_reference(
                *[a.float() for a in args], g)
            for a, ref in zip(got, want):
                assert a.shape == ref.shape and torch.isfinite(a).all()
            errs = relative_errors(got, want)
            max_abs = max(e[2] for e in errs.values())
            ms = cuda_ms(lambda: cuda_cv.fused_sweep_bwd(*args, g), reps=10)
            plain_ms = cuda_ms(lambda: cuda_cv.fused_sweep_backward_reference(
                *args, g), reps=3, warmup=1)
            bound = bound_ms(shape, dtype, backward=True)
            print(f"[backward] {tag}: shape {shape} kernel (K2 and the "
                  f"scatter) {ms:.3f} ms plain {plain_ms:.3f} ms; "
                  f"max_abs_err {max_abs:.3e}; all eight gradients "
                  "bit-identical over two calls; "
                  + rate_line(shape, dtype, True, ms, bound))
            print(f"[backward] {tag} vs float32 plain, per gradient "
                  "(max-rel, L2-rel): " + ", ".join(
                      f"{k_} {e[0]:.2e} {e[1]:.2e}" for k_, e in errs.items()))
            if dtype == torch.float32 and name == "odd":
                assert max(e[0] for e in errs.values()) <= BWD_MAX_TOL, errs
            assert max(e[1] for e in errs.values()) <= BWD_L2_TOL[dtype], errs
            if dtype == torch.bfloat16:
                # the report's error: against the plain version on the
                # same (bf16) inputs, as K1's
                same = relative_errors(
                    got, cuda_cv.fused_sweep_backward_reference(*args, g))
                worst = max(e[1] for e in same.values())
                max_abs = max(e[2] for e in same.values())
                print(f"[backward] {tag} vs bf16 plain: worst L2-rel "
                      f"{worst:.2e} (tol {BWD_SAME_ROUNDING_TOL:.0e}), "
                      f"max_abs_err {max_abs:.3e}")
                assert worst <= BWD_SAME_ROUNDING_TOL, same
            del got, want
            report[tag] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                               bound=bound)
            scatter[tag] = check_scatter(
                shape, dtype, device, dot=False, tag=tag,
                library=name == f"hero_b{TRAIN_BATCH}")
            print(f"[backward] {tag}: K2 without the scatter about "
                  f"{ms - scatter[tag]['ms']:.3f} ms")
    return report, scatter


def _device_split(prof, steps: int) -> dict:
    """Device (self CUDA) time per step in ms, by kernel family."""
    families = (("K1", ("fused_sweep_mlp_kernel", "fused_sweep_mma_kernel")),
                ("K2", ("fused_sweep_bwd", "sum_partials_kernel")),
                ("scatter", ("sweep_scatter", "fixed_to_float")),
                ("K1-dot d_cur", ("fused_sweep_dot_kernel<float, true",
                                  "fused_sweep_dot_kernel<__nv_bfloat16, "
                                  "true")),
                ("K1-dot", ("fused_sweep_dot_kernel",)),
                ("K3", ("max_blur_pool",)),
                ("convolution", ("conv", "cudnn", "dgrad", "wgrad", "fprop",
                                 "winograd", "nchwtonhwc", "nhwctonchw")),
                ("optimizer", ("multi_tensor", "adam", "foreach")),
                ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
                ("gemm", ("gemm", "gemv", "cutlass", "xmma")),
                ("elementwise and other", ("",)))
    split = {name: 0.0 for name, _ in families}
    kernels = []
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or "#" in evt.key):   # record_function ranges, not kernels
            continue
        t = getattr(evt, "self_device_time_total",
                    getattr(evt, "self_cuda_time_total", 0.0)) / 1e3 / steps
        if t <= 0:
            continue
        kernels.append((t, evt.key))
        low = evt.key.lower()
        for name, keys in families:
            if any(key in low for key in keys):
                split[name] += t
                break
    kernels.sort(reverse=True)
    return split, kernels


def _run_steps(model, optimizer, batch, generator, steps: int) -> tuple:
    """`steps` training steps; (losses, grad norms, step ms by the host
    clock after a synchronize)."""
    losses, norms, step_ms = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train.train_step(model, optimizer, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return losses, norms, step_ms


def _series(losses, norms) -> str:
    return ("loss " + ", ".join(f"{x:.4f}" for x in losses) + "; grad_norm "
            + ", ".join(f"{x:.3f}" for x in norms))


# the kernel families that run only inside a span of the dot training
# step (`tracing.py`)
RANGE_KERNELS = {"sr.dot_sweep_backward": ("scatter", "K1-dot d_cur")}


def _range_device_ms(prof, name: str, steps: int) -> float:
    """Device time per step, in ms, of the kernels launched inside the
    span `name`: its profiler range's device time, which counts the
    kernels of every operation inside and, the range being a function
    scope, those launched through ctypes directly in it."""
    total = sum(evt.device_time_total for evt in prof.events()
                if evt.name == name
                and evt.device_type == torch.autograd.DeviceType.CPU)
    return total / 1e3 / steps


def profile_steps(model, optimizer, batch, generator, step: float,
                  tag: str, ranges=()) -> dict:
    """A `torch.profiler` split of the device time over two more steps,
    against the unprofiled median `step` (ms); `ranges` names spans
    whose device time is printed too."""
    steps = 2
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            train.train_step(model, optimizer, batch, generator)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    split, kernels = _device_split(prof, steps)
    busy = sum(split.values())
    print(f"[{tag}] profile over {steps} steps: device busy {busy:.2f} "
          f"ms/step; idle share {1 - busy / step:.3f} of the unprofiled "
          f"median step ({step:.2f} ms); wall {wall:.2f} ms/step with the "
          "profiler on")
    print(f"[{tag}] device ms/step by family: " + ", ".join(
        f"{name} {t:.2f}" for name, t in split.items()))
    for name in ranges:
        ms = _range_device_ms(prof, name, steps)
        print(f"[{tag}] device ms/step inside '{name}': {ms:.2f} "
              f"({ms / max(busy, 1e-9):.3f} of busy), of which its kernels "
              + ", ".join(f"{family} {split[family]:.2f}"
                          for family in RANGE_KERNELS.get(name, ())))
    print(f"[{tag}] top kernels ms/step: " + "; ".join(
        f"{t:.2f} {name[:60]}" for t, name in kernels[:10]))
    return split


def train_steps(opts, device, tag: str) -> tuple:
    """TRAIN_STEPS training steps at b16 on one fixed seeded batch, with
    the launch counters set to 0 just before; checks losses and gradient
    norms finite. Returns (model, optimizer, batch, generator, losses,
    launches, median timed step ms, parameter tensors changed, their
    count)."""
    model = build_depth_model(opts, device=device, seed=0)
    assert model.compute_dtype == torch.bfloat16
    optimizer = train.make_optimizer(opts, model)
    batch = train.batch_to_device(train_batch(opts, TRAIN_BATCH, seed=7),
                                  device)
    generator = torch.Generator().manual_seed(0)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    losses, norms, step_ms = _run_steps(model, optimizer, batch, generator,
                                        TRAIN_STEPS)
    counts = launches()
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses,
                                                                  norms)
    assert optimizer.count == TRAIN_STEPS, optimizer.count
    unchanged = [name for (name, p), a in zip(model.named_parameters(),
                                              before)
                 if torch.equal(a, p.detach())]
    timed = step_ms[WARMUP_STEPS:]
    step = statistics.median(timed)
    print(f"[{tag}] b{TRAIN_BATCH} bf16, {TRAIN_STEPS} steps at lr "
          f"{opts.lr:g}: " + _series(losses, norms))
    print(f"[{tag}] launches {counts}; step ms median {step:.2f} over "
          f"{len(timed)} (all " + ", ".join(f"{x:.2f}" for x in step_ms)
          + f"); peak memory {peak_gib:.2f} GiB; "
          f"{len(before) - len(unchanged)} of {len(before)} parameter "
          f"tensors changed" + (f" (unchanged: {unchanged})" if unchanged
                                else ""))
    return (model, optimizer, batch, generator, losses, counts, step,
            len(before) - len(unchanged), len(before))


def phase_train(device) -> dict:
    opts = hero_options()
    (model, optimizer, batch, generator, losses, counts, step, changed,
     total) = train_steps(opts, device, "train")
    assert_launches(counts, {"K1": TRAIN_STEPS, "K2": TRAIN_STEPS,
                             "scatter": TRAIN_STEPS})
    assert losses[-1] < losses[0], losses
    assert changed >= 0.95 * total, (changed, total)
    profile_steps(model, optimizer, batch, generator, step, "train")
    assert_repeatable(model, batch, "train")

    # the same steps from the same init at a tenth of the learning rate
    del model, optimizer
    slow = hero_options(lr=opts.lr / 10)
    model = build_depth_model(slow, device=device, seed=0)
    slow_losses, slow_norms, _ = _run_steps(
        model, train.make_optimizer(slow, model), batch,
        torch.Generator().manual_seed(0), TRAIN_STEPS)
    assert all(np.isfinite(slow_losses)), slow_losses
    print(f"[train] the same at lr {slow.lr:g}: "
          + _series(slow_losses, slow_norms))
    return dict(launches=counts, step_ms=step)


@contextlib.contextmanager
def warps_in_dot_backward():
    """Counts the calls of the plain warp `sweep_warp` made inside the dot
    backward while the context is open; yields the one-element count."""
    inside, count = [False], [0]
    backward, warp = cuda_cv.dot_sweep_backward, cv_ops.sweep_warp

    def counted_backward(*args):
        inside[0] = True
        try:
            return backward(*args)
        finally:
            inside[0] = False

    def counted_warp(*args, **kwargs):
        count[0] += inside[0]
        return warp(*args, **kwargs)

    cuda_cv.dot_sweep_backward, cv_ops.sweep_warp = (counted_backward,
                                                     counted_warp)
    try:
        yield count
    finally:
        cuda_cv.dot_sweep_backward, cv_ops.sweep_warp = backward, warp


def phase_dot_train(device) -> dict:
    with warps_in_dot_backward() as warps:
        (model, optimizer, batch, generator, _, counts, step, changed,
         total) = train_steps(dot_options(), device, "dot_train")
    assert type(model.cost_volume).__name__ == "DotProductCostVolume"
    assert_launches(counts, {"K1-dot": TRAIN_STEPS,
                             "K1-dot d_cur": TRAIN_STEPS,
                             "K3-fwd": TRAIN_STEPS, "K3-bwd": TRAIN_STEPS,
                             "scatter": TRAIN_STEPS})
    print(f"[dot_train] plain warps inside the dot backward over "
          f"{TRAIN_STEPS} steps: {warps[0]}")
    assert warps[0] == 0, warps
    assert changed == total, (changed, total)
    profile_steps(model, optimizer, batch, generator, step, "dot_train",
                  ranges=("sr.dot_sweep_backward",))
    assert_repeatable(model, batch, "dot_train")
    return dict(launches=counts, step_ms=step)


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def _one_step_grads(model, batch, device, names) -> tuple:
    """The loss and the named gradients of one training-mode forward and
    backward without flip (no update)."""
    model.train()
    losses, _ = train.forward_and_losses(
        model, train.batch_to_device(batch, device), flip=False)
    losses["loss"].backward()
    params = dict(model.named_parameters())
    return losses["loss"].item(), {n: params[n].grad.cpu() for n in names}


def phase_train_card_vs_cpu(device, opts, compared, steps: int, tag: str,
                            perturbed: bool):
    """`steps` float32 training steps of the model of `opts` on the card
    and on the CPU from the same init, batch and flip coins: the first
    step's loss, grad norm and `compared` gradients, and the second
    step's loss if there is one, held tight; with `perturbed`, one step
    from a perturbed init held to the one-ulp input spread."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # training steps from the plain seeded init, the same flip coins
    base = build_depth_model(opts, device="cpu", seed=9)
    batch = train_batch(opts, CHECK_BATCH, seed=8)
    runs = {}
    for dev_tag, dev in (("cpu", "cpu"), ("gpu", device)):
        model = copy.deepcopy(base).to(dev)
        optimizer = train.make_optimizer(opts, model)
        data = train.batch_to_device(batch, dev)
        generator = torch.Generator().manual_seed(0)
        losses, norms, step_ms = _run_steps(model, optimizer, data,
                                            generator, 1)
        params = dict(model.named_parameters())
        grads = {name: params[name].grad.cpu() for name in compared}
        rest = _run_steps(model, optimizer, data, generator, steps - 1)
        losses, norms = losses + rest[0], norms + rest[1]
        print(f"[{tag}] {dev_tag} b{CHECK_BATCH}, {steps} "
              f"steps in {(sum(step_ms) + sum(rest[2])) / 1e3:.2f} s: "
              + _series(losses, norms))
        assert all(np.isfinite(losses)) and all(np.isfinite(norms))
        runs[dev_tag] = (losses, norms, grads)
    (l_cpu, n_cpu, g_cpu), (l_gpu, n_gpu, g_gpu) = runs["cpu"], runs["gpu"]
    held = [(l_gpu[0], l_cpu[0], TRAIN_LOSS_RTOL),
            (n_gpu[0], n_cpu[0], TRAIN_NORM_RTOL)]
    if steps > 1:
        held.append((l_gpu[1], l_cpu[1], TRAIN_LOSS2_RTOL))
    for got, want, rtol in held:
        assert abs(got - want) <= rtol * abs(want), (got, want, rtol)
    for name in compared:
        rel = _rel(g_gpu[name], g_cpu[name])
        print(f"[{tag}] first step {name}: L2-rel {rel:.2e} "
              f"(|grad| {g_cpu[name].norm().item():.3e})")
        assert g_cpu[name].norm() > 0 and rel <= TRAIN_GRAD_TOL, (name, rel)

    if not perturbed:
        return
    # one step from a perturbed init, against the spread of one ulp
    spread = spread_outputs_(build_depth_model(opts, device="cpu", seed=9),
                             seed=9)
    one = train_batch(opts, 1, seed=8)
    moved = copy.deepcopy(one)
    for part in moved.values():
        part["image_b3hw"] = (part["image_b3hw"]
                              * np.float32(1 + 2 ** -23)).astype(np.float32)
    res = {key: _one_step_grads(copy.deepcopy(spread).to(dev), data, dev,
                                compared)
           for key, dev, data in (("cpu", "cpu", one),
                                  ("cpu_ulp", "cpu", moved),
                                  ("gpu", device, one),
                                  ("gpu_ulp", device, moved))}
    print(f"[{tag}] perturbed init, loss " + ", ".join(
        f"{key} {loss:.6f}" for key, (loss, _) in res.items()))
    assert abs(res["gpu"][0] - res["cpu"][0]) <= (TRAIN_LOSS_RTOL
                                                  * abs(res["cpu"][0]))
    for name in compared:
        card = _rel(res["gpu"][1][name], res["cpu"][1][name])
        ulps = [_rel(res[f"{dev}_ulp"][1][name], res[dev][1][name])
                for dev in ("cpu", "gpu")]
        limit = max(TRAIN_GRAD_TOL, ULP_FACTOR * max(ulps))
        print(f"[{tag}] perturbed init {name}: card vs CPU "
              f"L2-rel {card:.2e}; one-ulp spread CPU {ulps[0]:.2e}, card "
              f"{ulps[1]:.2e} (limit {limit:.2e})")
        assert card <= limit, (name, card, limit)


def phase_dot_kernel(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    fp32_bf16 = (torch.float32, torch.bfloat16)
    for name, shape, dtypes in (
            ("odd", (2, 3, 13, 21, 16, 5), fp32_bf16),
            ("hero_b1", (1,) + HERO_SWEEP, fp32_bf16),
            ("hero_b8", (8,) + HERO_SWEEP, (torch.bfloat16,)),
            (f"hero_b{TRAIN_BATCH}", (TRAIN_BATCH,) + HERO_SWEEP,
             (torch.bfloat16,))):
        for dtype in dtypes:
            args = dot_case(*shape, dtype=dtype, device=device, seed=1)
            before = launched(cuda_cv.dot_sweep)
            got = cuda_cv.dot_sweep(*args)
            want = cuda_cv.dot_sweep_reference(*args)
            torch.cuda.synchronize()
            assert launched(cuda_cv.dot_sweep) == before + 1
            b, k, h, w, c, d = shape
            assert got.shape == (b, d, h * w), got.shape
            assert torch.isfinite(got).all()
            err = (got - want).abs().max().item()
            tol = DOT_TOL * max(1.0, want.abs().max().item())
            ms = cuda_ms(lambda: cuda_cv.dot_sweep(*args), reps=20)
            plain_ms = cuda_ms(lambda: cuda_cv.dot_sweep_reference(*args),
                               reps=5)
            flops, nbytes, tap_bytes = dot_sweep_work(shape, dtype)
            bound, bound_by = work_bound(flops, nbytes,
                                         PEAK_FLOPS[torch.float32])
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            print(f"[dot_kernel] {tag}: shape {shape} max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}) kernel {ms:.3f} ms plain {plain_ms:.3f} "
                  f"ms; bound {bound:.4f} ms by {bound_by} "
                  f"({flops / 1e9:.2f} GFLOP on float32 CUDA cores, "
                  f"{nbytes / 1e6:.1f} MB; tap loads {tap_bytes / 1e9:.2f} "
                  "GB through L1/L2)")
            assert err <= tol, (tag, err, tol)
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound=(bound, bound_by))
            if dtype == torch.bfloat16:
                unrounded = dot_case(*shape, dtype=torch.float32,
                                     device=device, seed=1)
                want = cuda_cv.dot_sweep_reference(*unrounded)
                rel = ((got - want).norm() / want.norm()).item()
                print(f"[dot_kernel] {tag} vs float32 plain on unrounded "
                      f"features: L2-rel {rel:.2e} "
                      f"(tol {DOT_BF16_L2_TOL:.0e})")
                assert rel <= DOT_BF16_L2_TOL, (tag, rel)
            # K1-dot's d_cur mode against its plain version
            g = sweep_cotangent(b, d, h * w, device, seed=2)
            dargs = [args[0]] + list(args[2:]) + [g]
            before = launched(cuda_cv.dot_sweep_dcur)
            got = cuda_cv.dot_sweep_dcur(*dargs)
            again = cuda_cv.dot_sweep_dcur(*dargs)
            want = cuda_cv.dot_sweep_dcur_reference(*dargs)
            torch.cuda.synchronize()
            assert launched(cuda_cv.dot_sweep_dcur) == before + 2
            assert got.shape == (b, h * w, c) and torch.isfinite(got).all()
            assert torch.equal(got, again), tag
            err = (got - want).abs().max().item()
            tol = DCUR_TOL * max(1.0, want.abs().max().item())
            del got, again, want
            ms = cuda_ms(lambda: cuda_cv.dot_sweep_dcur(*dargs), reps=20)
            plain_ms = cuda_ms(
                lambda: cuda_cv.dot_sweep_dcur_reference(*dargs), reps=5)
            flops, nbytes = dcur_work(shape, dtype)
            bound, bound_by = work_bound(flops, nbytes,
                                         PEAK_FLOPS[torch.float32])
            print(f"[dot_kernel] {tag} d_cur mode: max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}); two calls bit-identical; kernel "
                  f"{ms:.3f} ms plain {plain_ms:.3f} ms; bound {bound:.4f} "
                  f"ms by {bound_by} ({flops / 1e9:.2f} GFLOP on float32 "
                  f"CUDA cores, {nbytes / 1e6:.1f} MB)")
            assert err <= tol, (tag, err, tol)
            entry["dcur"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound=(bound, bound_by))
            # the dot backward: d_cur by that mode, d_src by the scatter
            before = (launched(cuda_cv.sweep_scatter),
                      launched(cuda_cv.dot_sweep_dcur))
            first = cuda_cv.dot_sweep_backward(*args, g)
            second = cuda_cv.dot_sweep_backward(*args, g)
            torch.cuda.synchronize()
            assert (launched(cuda_cv.sweep_scatter),
                    launched(cuda_cv.dot_sweep_dcur)) == (before[0] + 2,
                                                         before[1] + 2)
            for grad, x, y in zip(("d_src", "d_cur"), first, second):
                assert torch.isfinite(x).all() and torch.equal(x, y), (tag,
                                                                       grad)
            del first, second
            line = (f"[dot_kernel] {tag}: dot backward bit-identical over "
                    "two calls")
            if name == f"hero_b{TRAIN_BATCH}":
                bwd_ms = cuda_ms(lambda: cuda_cv.dot_sweep_backward(*args, g),
                                 reps=3, warmup=1)
                line += f"; {bwd_ms:.3f} ms"
            print(line)
            scatter = check_scatter(shape, dtype, device, dot=True, tag=tag)
            entry["scatter"] = scatter
            report[tag] = entry
    print(f"[scatter] over phases 6 and 9: (block, plane) pairs summed in "
          f"the window {SCATTER_PATHS[0]}, straight to device memory "
          f"{SCATTER_PATHS[1]}")
    assert SCATTER_PATHS[0] > 0 and SCATTER_PATHS[1] > 0, SCATTER_PATHS
    return report


def encoder_pool_dtype(device) -> torch.dtype:
    """The dtype the bf16 (autocast) matching encoder hands its stem
    pool, in train mode."""
    encoder = ResnetMatchingEncoder(pool_impl="pallas").to(device).train()
    seen = []
    hook = encoder.net[3].register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        encoder(torch.randn(2, 3, 64, 64, device=device))
    hook.remove()
    print(f"[pool_kernel] under bf16 autocast the stem pool takes "
          f"{seen[0][0]} and gives {seen[0][1]}")
    return seen[0][0]


def phase_pool_kernels(device) -> tuple:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cdt = encoder_pool_dtype(device)
    dtypes = (torch.float32,) if cdt == torch.float32 else (torch.float32,
                                                            cdt)
    report, staged = {}, set()
    cases = dict(POOL_CASES)
    cases[f"encoder_b{TRAIN_BATCH}"] = ((8 * TRAIN_BATCH,) + STEM, 0)
    for name, (shape, offset) in cases.items():
        b, c, h, w = shape
        for dtype in dtypes:
            x = shifted(pool_case(shape, dtype, device, seed=3), offset)
            g = shifted(pool_cotangent((b, c) + pool.output_size(h, w),
                                       dtype, device, seed=4, positive=True),
                        offset)
            before = (launched(pool.max_blur_pool),
                      launched(pool.max_blur_pool_bwd))
            out = pool.max_blur_pool(x)
            dx = pool.max_blur_pool_bwd(x, g)
            torch.cuda.synchronize()
            by16 = (pool.rows_by_16_bytes(x, w),
                    pool.rows_by_16_bytes(out, out.shape[-1]),
                    pool.rows_by_16_bytes(g, g.shape[-1]))
            staged.update(by16)
            assert (launched(pool.max_blur_pool),
                    launched(pool.max_blur_pool_bwd)) == (before[0] + 1,
                                                         before[1] + 1)
            want = pool.max_blur_pool_reference(x.float())
            want_dx = pool.max_blur_pool_backward_reference(x.float(),
                                                            g.float())
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            entry = {}
            xr = x.detach().requires_grad_()
            graph = pool.max_blur_pool_reference(xr)
            timings = {
                "fwd": (lambda: pool.max_blur_pool(x),
                        lambda: pool.max_blur_pool_reference(x)),
                "bwd": (lambda: pool.max_blur_pool_bwd(x, g),
                        lambda: torch.autograd.grad(graph, xr, g,
                                                    retain_graph=True))}
            for part, got, ref in (("fwd", out, want), ("bwd", dx, want_dx)):
                assert got.shape == ref.shape and got.dtype == dtype
                assert torch.isfinite(got).all()
                diff = (got.float() - ref).abs()
                err = diff.max().item()
                if dtype == torch.float32:
                    limit = POOL_TOL * max(1.0, ref.abs().max().item())
                    ok = err <= limit
                    rule = f"max <= {limit:.1e}"
                else:
                    ratio = (diff / (ref.abs() + 1e-30)).max().item()
                    ok = bool((diff <= POOL_BF16_REL * ref.abs() + 1e-6)
                              .all())
                    rule = (f"elementwise <= 2^-8 |ref|, worst "
                            f"{ratio:.2e} |ref|")
                kernel_fn, plain_fn = timings[part]
                ms = cuda_ms(kernel_fn, reps=20)
                plain_ms = cuda_ms(plain_fn, reps=20)
                bound, bound_by = work_bound(
                    *pool_work(shape, dtype, part == "bwd"),
                    PEAK_FLOPS[torch.float32])
                print(f"[pool_kernel] {tag} {part}: shape {shape} "
                      f"max_abs_err {err:.3e} vs the float32 chain ({rule}); "
                      f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms; bound "
                      f"{bound:.4f} ms by {bound_by}")
                assert ok, (tag, part, err)
                entry[part] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound=(bound, bound_by))
            routed = dx != 0
            assert torch.equal(routed, want_dx != 0), tag
            if dtype != torch.float32:
                same = (pool.max_blur_pool_backward_reference(x, g).float()
                        - dx.float()).abs().max().item()
                fwd_same = (pool.max_blur_pool_reference(x).float()
                            - out.float()).abs().max().item()
                print(f"[pool_kernel] {tag}: against the {dtype} plain chain "
                      f"max |diff| fwd {fwd_same:.3e} bwd {same:.3e}")
            print(f"[pool_kernel] {tag}: dx routed to the same "
                  f"{routed.float().mean().item():.4f} of the elements as "
                  "the plain autograd; rows by 16 bytes (else element by "
                  f"element): x {by16[0]}, out {by16[1]}, g {by16[2]}")
            report[tag] = entry
            del x, g, out, dx, want, want_dx, xr, graph
    assert staged == {True, False}, "both staging paths must run"
    return report, cdt


def profile_requests(opts, model, tag: str):
    """A `torch.profiler` view of the 12-frame stream through a fresh
    `OnlineSession`: device busy time and kernels per answered request,
    and the host ops that take the most CPU time."""
    session = OnlineSession(opts, model)
    frames = posed_stream(12, opts.image_height, opts.image_width, seed=2)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    answered = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        for frame in frames:
            answered += session.process_frame(frame) is not None
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / answered
    events = [e for e in prof.key_averages()
              if not getattr(e, "is_user_annotation", False)]
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "#" not in e.key]
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in cuda)
    kernels = sum(e.count for e in cuda)
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)
    print(f"[{tag}] profiled stream: {answered} answers, device busy "
          f"{busy / 1e3 / answered:.2f} ms and {kernels / answered:.0f} "
          f"kernels per answer; wall {wall:.2f} ms per answer with the "
          "profiler on")
    print(f"[{tag}] host ops by self CPU ms per answer: " + "; ".join(
        f"{t / 1e3 / answered:.2f} {key} (x{count / answered:.0f})"
        for t, count, key in host[:10]))


def phase_dot_infer(device) -> dict:
    """The dot model through `OnlineSession`, then the hero and the dot
    model again in turns on the same card state, and a profiled stream
    of each: the two request latencies compared."""
    torch.cuda.empty_cache()    # the pool phase's tensors leave the cache
    opts = dot_options(fast_cost_volume=True)
    model = build_depth_model(opts, device=device, seed=0)
    assert model.compute_dtype == torch.bfloat16
    assert type(model.cost_volume).__name__ == "DotProductCostVolume"
    assert model.matching_model.net[3].impl == "pallas"
    answers, dot_ms, counts = serve(opts, model, "dot_infer")
    assert_launches(counts, {"K1-dot": len(answers),
                             "K3-fwd": len(answers)})

    hero_opts = hero_options()
    hero = build_depth_model(hero_opts, device=device, seed=0)
    hero_answers, hero_ms, hero_counts = serve(hero_opts, hero,
                                               "dot_infer hero")
    assert_launches(hero_counts, {"K1": len(hero_answers)})
    again, dot_again_ms, again_counts = serve(opts, model,
                                              "dot_infer dot again")
    assert_launches(again_counts, {"K1-dot": len(again),
                                   "K3-fwd": len(again)})
    print("[dot_infer] request median ms in turns: dot "
          f"{statistics.median(dot_ms):.2f}, hero "
          f"{statistics.median(hero_ms):.2f}, dot "
          f"{statistics.median(dot_again_ms):.2f}")
    profile_requests(opts, model, "dot_infer dot")
    profile_requests(hero_opts, hero, "dot_infer hero")
    return counts


# K5 and K4 by name: (case maker, wrapper, plain version)
EARLY_KERNELS = {
    "K5": (stack_case, early_sweeps.fused_feature_volume,
           early_sweeps.fused_feature_volume_reference),
    "K4": (warp_case, early_sweeps.fused_warp_feature_volume,
           early_sweeps.fused_warp_feature_volume_reference),
}
# the hero model's sweeps by cost_volume_backend: K1, the warp and K5, K4
HERO_SWEEPS = ("pallas", "pallas_v1", "pallas_full")


def early_sweep_work(name: str, shape, dtype) -> tuple:
    """(operations, bytes) of one K5 or K4 call at `shape`: the MLP
    products per (pixel, plane), as K1's, and each input read and the
    output written once (K5: the stack, mask and depths; K4: the source
    maps and projections; both: cur, rays, planes, pose rows and MLP)."""
    b, k, h, w, c, d = shape
    n, hid = h * w, cuda_cv.HIDDEN
    cin = cuda_cv.mlp_in_channels(k, c)
    cells = b * d * n
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((b * n * c + cin * hid + hid * hid + hid) * esize
              + (b * n * 3 + b * d + 2 * b * k * 3 + 2 * hid + 1 + cells) * 4)
    if name == "K5":
        nbytes += k * cells * (c * esize + 2 * 4)
    else:
        nbytes += b * k * n * c * esize + b * k * 16 * 4
    return 2 * (cin * hid + hid * hid + hid) * cells, nbytes


def phase_early_kernels(device) -> dict:
    """K5 and K4 against their plain versions: values, times, bounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k, h, w, c, d = HERO_SWEEP
    report = {}
    fp32_bf16 = (torch.float32, torch.bfloat16)
    for name, (make_case, kernel_fn, plain_fn) in EARLY_KERNELS.items():
        # at b8, K5 runs once per chunk of planes: time one chunk
        d8 = early_sweeps.stack_plane_chunk(8, k, h * w, c, d) \
            if name == "K5" else d
        for case, shape, dtypes in (
                ("odd", (2, 3, 13, 21, 8, 5), fp32_bf16),
                ("hero_b1", (1,) + HERO_SWEEP, fp32_bf16),
                ("hero_b8", (8, k, h, w, c, d8), (torch.bfloat16,))):
            for dtype in dtypes:
                args = make_case(*shape, dtype=dtype, device=device, seed=1)
                before = launched(kernel_fn)
                with torch.no_grad():
                    got = kernel_fn(*args)
                    want = plain_fn(*args)
                torch.cuda.synchronize()
                assert launched(kernel_fn) == before + 1
                b_, _, h_, w_, _, d_ = shape
                assert got.shape == (b_, d_, h_ * w_), got.shape
                assert torch.isfinite(got).all()
                err = (got - want).abs().max().item()
                tol = KERNEL_TOL[dtype] * max(1.0, want.abs().max().item())
                with torch.no_grad():
                    ms = cuda_ms(lambda: kernel_fn(*args), reps=20)
                    plain_ms = cuda_ms(lambda: plain_fn(*args), reps=5)
                flops, nbytes = early_sweep_work(name, shape, dtype)
                bound, bound_by = work_bound(flops, nbytes, PEAK_FLOPS[dtype])
                tag = f"{case}_{str(dtype).split('.')[-1]}"
                print(f"[early_kernel] {name} {tag}: shape {shape} "
                      f"max_abs_err {err:.3e} (tol {tol:.1e}) kernel "
                      f"{ms:.3f} ms plain {plain_ms:.3f} ms; bound "
                      f"{bound:.4f} ms by {bound_by} ({flops / 1e9:.2f} "
                      f"GFLOP, {nbytes / 1e6:.1f} MB)")
                assert err <= tol, (name, tag, err, tol)
                report[(name, tag)] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms,
                                           bound=(bound, bound_by))
                del args, got, want
    return report


def b8_batch(opts, device) -> tuple:
    """(cur_data, src_data) of 8 reference frames, each with the 7
    frames before it as sources."""
    frames = posed_stream(15, opts.image_height, opts.image_width, seed=4)
    n_src = opts.model_num_views - 1
    parts = [make_batch(frames[i + n_src], frames[i:i + n_src],
                        opts.matching_scale, device) for i in range(8)]
    return tuple({key: torch.cat([part[j][key] for part in parts])
                  for key in parts[0][j]} for j in (0, 1))


def phase_early_serve(device) -> dict:
    """The hero model served with each of its three sweeps, in turns, on
    the same seeded weights; the sweeps' depth maps against each other;
    a b8 forward of each. Returns the serving launches of K5 and K4."""
    torch.cuda.empty_cache()
    k, h, w, c, d = HERO_SWEEP
    chunks = {b: d // early_sweeps.stack_plane_chunk(b, k, h * w, c, d)
              for b in (1, 8)}

    def expected(backend, forwards, b):
        return {"pallas": {"K1": forwards},
                "pallas_v1": {"K5": forwards * chunks[b]},
                "pallas_full": {"K4": forwards}}[backend]

    models, answers, served = {}, {}, {}
    for backend in HERO_SWEEPS:
        opts = hero_options(cost_volume_backend=backend)
        models[backend] = spread_outputs_(
            build_depth_model(opts, device=device, seed=0), seed=0)
        assert models[backend].compute_dtype == torch.bfloat16
        answers[backend], _, counts = serve(opts, models[backend],
                                            f"early_serve {backend}")
        assert_launches(counts, expected(backend, len(answers[backend]), 1))
        served[backend] = counts
    ref = answers["pallas"]
    for backend in ("pallas_v1", "pallas_full"):
        assert len(answers[backend]) == len(ref)
        l2, agree, max_err = [], [], 0.0
        for got, want in zip(answers[backend], ref):
            x = got["log_depth_pred_s0_bhw1"]
            y = want["log_depth_pred_s0_bhw1"]
            l2.append(np.linalg.norm(x - y) / np.linalg.norm(y - y.mean()))
            max_err = max(max_err, float(np.abs(x - y).max()))
            agree.append(float(np.mean(got["lowest_cost_bhw"]
                                       == want["lowest_cost_bhw"])))
        std = float(np.std(ref[0]["log_depth_pred_s0_bhw1"]))
        print(f"[early_serve] {backend} against pallas (K1), bf16, "
              f"{len(ref)} answers: s0 log-depth L2-rel to its spread "
              f"worst {max(l2):.3e} (tol {SWEEPS_L2_TOL:.0e}), max |diff| "
              f"{max_err:.3e} (std {std:.3f}); lowest-cost depth agrees "
              f"at {min(agree):.4f} of pixels (tol {SWEEPS_LOWEST_AGREE})")
        assert max(l2) <= SWEEPS_L2_TOL, (backend, l2)
        assert min(agree) >= SWEEPS_LOWEST_AGREE, (backend, agree)

    cur, src = b8_batch(hero_options(), device)
    reps = 5
    for backend in HERO_SWEEPS:
        model = models[backend]
        with torch.no_grad():
            model(cur, src, return_mask=True)   # warm-up
            torch.cuda.synchronize()
            reset_launches()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = model(cur, src, return_mask=True)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        counts = launches()
        assert_launches(counts, expected(backend, reps, 8))
        assert torch.isfinite(out["depth_pred_s0_bhw1"]).all()
        print(f"[early_serve] {backend} b8 bf16 forward: "
              f"{statistics.median(times) / 8:.2f} ms per frame (median of "
              f"{reps}: " + ", ".join(f"{t:.2f}" for t in times)
              + f" ms per batch); launches {counts}")
    return {"K5": served["pallas_v1"]["K5"], "K4": served["pallas_full"]["K4"]}


def assert_repeatable(model, batch, tag: str):
    """Two forward and backward passes from the model's current state, as
    the training step runs them: every gradient the same bits."""
    loss_a, grads_a = determinism.grads_once(model, batch)
    loss_b, grads_b = determinism.grads_once(model, batch)
    differ = [name for name, a in grads_a.items()
              if not torch.equal(a, grads_b[name])]
    print(f"[{tag}] two passes from one state: loss {loss_a!r}, {loss_b!r};"
          f" gradients that differ: {len(differ)} of {len(grads_a)}"
          + (f" ({differ[:5]})" if differ else ""))
    assert loss_a == loss_b and not differ, (tag, differ)
    model.zero_grad(set_to_none=True)


EVAL_OUT = "build/eval_out"
SYNTHETIC_FRAMES = 48        # the synthetic scene's default length


def eval_options(out: str, *extra):
    """The eval CLI's options as a user gives them: the hero YAML, the
    synthetic scene, fusion; `extra` flags after them."""
    return OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", "configs/models/hero_model.yaml",
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--split", "test", "--run_fusion", "--output_base_path", out,
        *extra])


def eval_results(opts) -> str:
    return f"{opts.output_base_path}/{opts.name}/{opts.dataset}/" \
        f"{opts.frame_tuple_type}"


def check_eval_outputs(opts, scan: str = "scene") -> tuple:
    """The metrics JSONs hold finite scores and the scan's PLY finite
    vertices; returns the mesh."""
    results = eval_results(opts)
    for name in ("all_frame_avg_metrics.json", "all_scene_avg_metrics.json",
                 f"{scan}_avg_metrics.json"):
        with open(f"{results}/scores/{name}") as f:
            scores = json.load(f)["scores"]
        assert scores and all(np.isfinite(v) for v in scores.values()), name
    verts, faces = read_ply(f"{results}/meshes/4cm_3.0m/{scan}.ply")
    assert len(faces) > 0 and np.isfinite(verts).all(), len(faces)
    return verts, faces


def phase_eval_cli(device) -> dict:
    """`scripts/test.py` as a user runs it: the hero YAML (bf16, b16,
    384x512, 8 views, 64 planes, `xla_fused` -> K1), the 48-frame
    synthetic scene (41 tuples: batches of 16, 16, 9), metrics, TSDF
    fusion (4 cm, 3 m) and a PLY; K1 once a batch, no other kernel."""
    shutil.rmtree(EVAL_OUT, ignore_errors=True)
    opts = eval_options(EVAL_OUT, "--cache_depths")
    assert (opts.batch_size, opts.compute_dtype, opts.image_height,
            opts.image_width, opts.model_num_views,
            opts.matching_num_depth_bins, opts.cost_volume_backend) == (
        16, "bfloat16", 384, 512, 8, 64, "xla_fused"), opts
    assert synthetic.DEFAULT_NUM_FRAMES == SYNTHETIC_FRAMES
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frame_avg, _ = eval_cli.main(opts)
    total = time.perf_counter() - t0
    counts = launches()
    stats = frame_avg.run_stats
    assert (stats["frames"], stats["batches"], stats["fused_frames"]) == (
        41, 3, 41), stats
    assert_launches(counts, {"K1": stats["batches"]})
    verts, faces = check_eval_outputs(opts)
    n, batches = stats["frames"], stats["batches"]
    print(f"[eval_cli] hero b{opts.batch_size} bf16 384x512, {n} frames in "
          f"{batches} batches; launches {counts}; total {total:.2f} s")
    print(f"[eval_cli] loader wait {stats['loader'] / batches * 1e3:.2f} "
          f"ms/batch; forward {stats['forward_device'] / n * 1e3:.3f} "
          f"ms/frame by CUDA events (per batch "
          + ", ".join(f"{ms:.2f}" for ms in stats["batch_forward_ms"])
          + f" ms), {stats['forward'] / n * 1e3:.3f} ms/frame by the host "
          f"clock; metrics {stats['metrics'] / batches * 1e3:.2f} ms/batch;"
          f" TSDF {stats['fusion'] / stats['fused_frames'] * 1e3:.3f} "
          f"ms/fused frame over {stats['voxels']} voxels; marching cubes "
          f"{stats['marching_cubes'] * 1e3:.1f} ms; PLY "
          f"{stats['ply'] * 1e3:.1f} ms; mesh {len(verts)} vertices, "
          f"{len(faces)} faces; abs_rel "
          f"{frame_avg.final_metrics['abs_rel']:.4f} (seeded weights)")
    return dict(launches=counts, stats=stats, total=total, opts=opts)


def phase_gt_fusion(device) -> dict:
    """The synthetic scene's 48 GT depths (at 192x256) through the port's
    `OurFuser` on the card, bounded by the cameras' frustums at 3 m, 4 cm
    voxels, scored against the room mesh: the JAX package's grid, mesh
    counts within 1% and F1 within 0.005 (`testing.GT_FUSION`)."""
    frames = synthetic_gt_frames()
    fuser = OurFuser(fusion_resolution=0.04, max_fusion_depth=3.0,
                     bounds_3x2=synthetic_gt_bounds(), device=device)
    on_card = [{k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in f.items()} for f in frames]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for f in on_card:
        fuser.fuse_frames(f["depth_b1hw"][None], f["K"][None],
                          f["cam_T_world"][None])
    end.record()
    end.synchronize()
    fuse_ms = start.elapsed_time(end) / len(frames)
    t0 = time.perf_counter()
    verts, faces = fuser.get_mesh()
    mc_ms = (time.perf_counter() - t0) * 1e3
    room_v, room_f, _ = make_room_mesh()
    scores = evaluate_mesh(verts, faces, room_v, room_f, num_points=100_000)
    dims = tuple(fuser.fuser.tsdf.dims)
    print(f"[gt_fusion] {len(frames)} frames into {dims} = "
          f"{int(np.prod(dims))} voxels: {fuse_ms:.3f} ms/frame by CUDA "
          f"events; marching cubes {mc_ms:.1f} ms; mesh {len(verts)} "
          f"vertices, {len(faces)} faces (JAX {GT_FUSION['vertices']}, "
          f"{GT_FUSION['faces']}); precision {scores['precision']:.4f} "
          f"recall {scores['recall']:.4f} F1 {scores['f1']:.4f} (JAX "
          f"{GT_FUSION['f1']:.4f})")
    assert dims == GT_FUSION["dims"], dims
    for got, want in ((len(verts), GT_FUSION["vertices"]),
                      (len(faces), GT_FUSION["faces"])):
        assert abs(got - want) <= 0.01 * want, (got, want)
    assert abs(scores["f1"] - GT_FUSION["f1"]) <= 0.005, scores
    return dict(fuse_ms=fuse_ms, voxels=int(np.prod(dims)),
                f1=scores["f1"])


def phase_eval_card_vs_cpu(device):
    """The eval CLI on the card and on the CPU in float32 at 192x256 (hero
    widths, the 48-frame scene: 41 tuples in batches of 8, which bounds
    the CPU run's memory), the same seeded weights (`spread_outputs_`, through a checkpoint): cached
    depths, per-frame and per-scene metrics and meshes within
    `testing.EVAL_TOL`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = "build/eval_card_vs_cpu"
    shutil.rmtree(root, ignore_errors=True)
    assert synthetic.DEFAULT_NUM_FRAMES == SYNTHETIC_FRAMES
    runs = {}
    for tag, dev in (("cpu", "cpu"), ("gpu", device)):
        opts = eval_options(f"{root}/{tag}", "--image_height", "192",
                            "--image_width", "256", "--precision", "32",
                            "--batch_size", "8", "--cache_depths")
        if not runs:
            model = spread_outputs_(
                build_depth_model(opts, device="cpu", seed=3), seed=3)
            ckpt = save_weights(f"{root}/seeded.pt", model, opts)
        opts.load_weights_from_checkpoint = ckpt
        t0 = time.perf_counter()
        runs[tag] = (opts, eval_cli.main(opts, device=dev))
        print(f"[eval_card_vs_cpu] {tag} run "
              f"{time.perf_counter() - t0:.2f} s")
    (cpu_opts, (cpu_frames, cpu_scenes)), (gpu_opts, (gpu_frames,
                                                      gpu_scenes)) = (
        runs["cpu"], runs["gpu"])
    assert (len(gpu_frames.elem_metrics), len(cpu_frames.elem_metrics)
            ) == (41, 41)
    depths = compare_cached_depths(f"{eval_results(gpu_opts)}/depths/scene",
                                   f"{eval_results(cpu_opts)}/depths/scene",
                                   flip_ratio=plane_ratio(gpu_opts))
    valid = 192 * 256 * 0.5
    worst = dict(metric_rel=0.0, a_pixels=0.0)
    for got, want in zip(
            gpu_frames.elem_metrics + [gpu_frames.final_metrics,
                                       gpu_scenes.final_metrics],
            cpu_frames.elem_metrics + [cpu_frames.final_metrics,
                                       cpu_scenes.final_metrics]):
        for key, value in compare_metrics(got, want, valid).items():
            worst[key] = max(worst[key], value)
    mesh = compare_meshes(
        f"{eval_results(gpu_opts)}/meshes/4cm_3.0m/scene.ply",
        f"{eval_results(cpu_opts)}/meshes/4cm_3.0m/scene.ply")
    print(f"[eval_card_vs_cpu] {depths['frames']} cached depths: largest "
          f"relative difference {depths['depth_rel']:.2e}, lowest-cost "
          f"pixels on another plane {depths['plane_flips']}; metrics: "
          f"continuous {worst['metric_rel']:.2e} relative, percentages "
          f"{worst['a_pixels']:.2f} pixels; meshes {mesh['vertices']} "
          f"vertices, {mesh['faces']} faces, F1 at 4 cm {mesh['f1']:.4f}")


TRAIN_CLI_OUT = "build/train_cli"
CLI_STEPS, CLI_LOG_INTERVAL, CLI_VAL_INTERVAL = 12, 4, 6
GRAND_LOOP_STEPS = 100
# the JSON-lines keys of the JAX training CLI: its loss dictionary, the
# gradient norm, steps per second and learning rate after "train/"
LOSS_KEYS = ("loss", "si_loss", "grad_loss", "abs_loss", "normals_loss",
             "ms_loss", "inv_abs_loss", "log_l1_loss", "mv_loss")
TRAIN_ROW_KEYS = {"step"} | {f"train/{k}" for k in LOSS_KEYS + (
    "grad_norm", "steps_per_sec", "lr")}
VAL_ROW_KEYS = {"step", "val/loss"}


@contextlib.contextmanager
def plain_sweeps():
    """Counts the calls of the plain sweep (`fused_sweep_reference`, its
    backward, or `sweep_warp` over more than one feature channel) while
    the context is open; yields the one-element count."""
    count = [0]
    fwd, bwd = cuda_cv.fused_sweep_reference, \
        cuda_cv.fused_sweep_backward_reference
    warp = cv_ops.sweep_warp

    def counted(fn, min_channels: int):
        # the model warps one channel for the last plane's mask
        def wrapped(*args, **kwargs):
            count[0] += args[0].shape[-1] >= min_channels
            return fn(*args, **kwargs)
        return wrapped

    cuda_cv.fused_sweep_reference = counted(fwd, 1)
    cuda_cv.fused_sweep_backward_reference = counted(bwd, 1)
    cv_ops.sweep_warp = counted(warp, 2)
    try:
        yield count
    finally:
        cuda_cv.fused_sweep_reference = fwd
        cuda_cv.fused_sweep_backward_reference = bwd
        cv_ops.sweep_warp = warp


def check_png(path: str) -> tuple:
    """Parses a PNG written by `utils/visualization.py`: the signature,
    every chunk's CRC, IHDR, and the inflated rows' length. Returns
    (height, width)."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", path
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, (path, kind)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + length
    assert list(chunks)[-1] == b"IEND" and pos == len(data), path
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    channels = {0: 1, 2: 3, 6: 4}[color]
    assert depth == 8 and len(zlib.decompress(chunks[b"IDAT"])) == h * (
        1 + w * channels), path
    return h, w


def train_cli_options(out: str, *extra):
    """The training CLI's options as a user of one card gives them: the
    hero YAML (which asks for the reference's two cards) with one rank,
    the synthetic scene, CLI_STEPS steps with a log every
    CLI_LOG_INTERVAL and a validation of one batch every
    CLI_VAL_INTERVAL; `extra` flags after them."""
    return OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", "configs/models/hero_model.yaml",
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--num_devices", "1", "--max_steps", str(CLI_STEPS),
        "--log_interval", str(CLI_LOG_INTERVAL), "--val_interval",
        str(CLI_VAL_INTERVAL), "--val_batches", "1", "--log_dir", out,
        *extra])


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def assert_hero_full_width(opts, batch: int = 16):
    assert (opts.batch_size, opts.compute_dtype, opts.image_height,
            opts.image_width, opts.model_num_views,
            opts.matching_num_depth_bins, opts.cost_volume_backend) == (
        batch, "bfloat16", 384, 512, 8, 64, "xla_fused"), opts


def run_train_cli(opts, device) -> tuple:
    """`scripts/train.py::main(opts)` on `device` with the launch counters
    set to 0 just before; no plain sweep may run. Returns (state,
    launches, seconds)."""
    torch.cuda.synchronize()
    with plain_sweeps() as plain:
        reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main(opts, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches()
    assert plain[0] == 0, f"{plain[0]} plain sweeps on the card"
    return state, counts, seconds


def phase_train_cli(device, bare_step_ms: float) -> dict:
    """`scripts/train.py` as a user runs it at full width (the hero YAML:
    bf16, b16, 384x512, 8 views, 64 planes, `xla_fused` -> K1, K2 and
    the scatter), CLI_STEPS steps on the synthetic scene."""
    shutil.rmtree(TRAIN_CLI_OUT, ignore_errors=True)
    opts = train_cli_options(TRAIN_CLI_OUT)
    assert_hero_full_width(opts)
    state, counts, total = run_train_cli(opts, device)
    vals = CLI_STEPS // CLI_VAL_INTERVAL
    assert_launches(counts, {"K1": CLI_STEPS + vals, "K2": CLI_STEPS,
                             "scatter": CLI_STEPS})
    assert state.step == state.optimizer.count == CLI_STEPS, state.step
    root = f"{TRAIN_CLI_OUT}/{opts.name}"
    rows = read_jsonl(f"{root}/metrics.jsonl")
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in train_rows] == list(range(
        CLI_LOG_INTERVAL, CLI_STEPS + 1, CLI_LOG_INTERVAL)), rows
    assert [r["step"] for r in val_rows] == list(range(
        CLI_VAL_INTERVAL, CLI_STEPS + 1, CLI_VAL_INTERVAL)), rows
    assert all(set(r) == TRAIN_ROW_KEYS for r in train_rows), train_rows
    assert all(set(r) == VAL_ROW_KEYS for r in val_rows), val_rows
    assert all(np.isfinite(v) for r in rows for v in r.values()), rows
    panels = sorted(os.listdir(f"{root}/panels"))
    assert panels == [f"step{s:08d}_{i}.png" for s in range(
        CLI_VAL_INTERVAL, CLI_STEPS + 1, CLI_VAL_INTERVAL)
        for i in range(4)], panels
    shapes = {check_png(f"{root}/panels/{p}") for p in panels}
    assert shapes == {(opts.image_height, 5 * opts.image_width)}, shapes
    assert sorted(os.listdir(f"{root}/checkpoints")) == [
        f"step_{CLI_STEPS}", f"step_{CLI_VAL_INTERVAL}"], os.listdir(
            f"{root}/checkpoints")
    assert len(os.listdir(f"{root}/best")) == 1, os.listdir(f"{root}/best")
    stats = state.run_stats
    step_ms = [t * 1e3 for t in stats["step_seconds"]]
    median = statistics.median(step_ms[2:])
    loop = sum(stats["step_seconds"]) + sum(stats["loader_seconds"])
    print(f"[train_cli] hero b{opts.batch_size} bf16 384x512, {state.step} "
          f"steps; launches {counts}; losses " + ", ".join(
              f"{r['step']}: {r['train/loss']:.4f}" for r in train_rows)
          + "; val " + ", ".join(f"{r['step']}: {r['val/loss']:.4f}"
                                 for r in val_rows))
    print(f"[train_cli] step ms median {median:.2f} over steps 3-"
          f"{len(step_ms)} (all " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f"), phase 7's bare step {bare_step_ms:.2f}; "
          f"{len(step_ms) / loop:.3f} steps/s over steps and loader waits;"
          " loader wait ms " + ", ".join(
              f"{t * 1e3:.1f}" for t in stats["loader_seconds"])
          + "; checkpoint write ms " + ", ".join(
              f"{t * 1e3:.0f}" for t in stats["checkpoint_seconds"])
          + "; validation ms " + ", ".join(
              f"{t * 1e3:.0f}" for t in stats["val_seconds"])
          + f"; peak memory {stats['peak_memory_bytes'] / 2 ** 30:.2f} GiB;"
          f" total {total:.2f} s")
    del state
    return dict(launches=counts, step_ms=median, total=total, opts=opts)


def phase_resume(device, opts) -> None:
    """`step_6` of phase 20 restored bit for bit; a run resumed from it
    to CLI_STEPS; a finetune from it with a fresh optimizer."""
    root = f"{TRAIN_CLI_OUT}/{opts.name}"
    step_dir = f"{root}/checkpoints/step_{CLI_VAL_INTERVAL}"
    saved = torch.load(f"{step_dir}/{ckpt_lib.STATE_FILE}",
                       map_location="cpu", weights_only=False)
    model = build_depth_model(opts, device=device, seed=1)
    state = train.TrainState(model, train.make_optimizer(opts, model),
                             torch.Generator().manual_seed(1))
    ckpt_lib.restore_checkpoint(step_dir, state)
    for name, value in model.state_dict().items():
        assert value.device.type == device.type, name
        assert torch.equal(value.cpu(), saved["state_dict"][name]), name
    got = state.optimizer.inner.state_dict()["state"]
    for i, moments in saved["optimizer"]["state"].items():
        for key, value in moments.items():
            assert torch.equal(got[i][key].cpu(), value), (i, key)
    assert (state.step, state.optimizer.count,
            state.optimizer.consecutive_errors,
            state.optimizer.total_errors) == (
        saved["step"], saved["count"], saved["consecutive_errors"],
        saved["total_errors"]) and saved["step"] == CLI_VAL_INTERVAL
    assert torch.equal(state.generator.get_state(), saved["generator"])
    n_moments = sum(len(m) for m in got.values())
    del model, state

    for suffix in ("_resumed", "_tuned"):
        shutil.rmtree(TRAIN_CLI_OUT + suffix, ignore_errors=True)
    resumed = train_cli_options(f"{TRAIN_CLI_OUT}_resumed")
    resumed.resume = step_dir
    state, counts, total = run_train_cli(resumed, device)
    steps = CLI_STEPS - CLI_VAL_INTERVAL
    assert_launches(counts, {"K1": steps + 1, "K2": steps,
                             "scatter": steps})
    resumed_root = f"{TRAIN_CLI_OUT}_resumed/{opts.name}"
    rows = read_jsonl(f"{resumed_root}/metrics.jsonl")
    assert [r["step"] for r in rows if "train/loss" in r] == [8, 12], rows
    assert os.listdir(f"{resumed_root}/checkpoints") == [
        f"step_{CLI_STEPS}"]
    assert state.step == state.optimizer.count == CLI_STEPS
    del state

    tuned = train_cli_options(f"{TRAIN_CLI_OUT}_tuned", "--max_steps", "1")
    tuned.load_weights_from_checkpoint = step_dir
    state, counts, _ = run_train_cli(tuned, device)
    assert_launches(counts, {"K1": 1, "K2": 1, "scatter": 1})
    assert (state.step, state.optimizer.count) == (1, 1)
    print(f"[resume] step_{CLI_VAL_INTERVAL} restored bit for bit: "
          f"{len(saved['state_dict'])} parameters and buffers, "
          f"{n_moments} AdamW state tensors, count {saved['count']}, the "
          f"generator; resumed to step {CLI_STEPS} in {total:.2f} s; "
          "finetune from its weights with a fresh optimizer: count 1 "
          "after one step")


def phase_grand_loop(device) -> dict:
    """`scripts/grand_loop.py` at GRAND_LOOP_STEPS steps: training, the
    eval CLI with fusion and the mesh score chain together on the card."""
    out = "build/grand_loop_short"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    summary = grand_loop.main(["--steps", str(GRAND_LOOP_STEPS),
                               "--out", out, "--mesh_points", "20000"],
                              device=device)
    seconds = time.perf_counter() - t0
    assert all(np.isfinite(v) for v in summary.values()
               if not isinstance(v, str)), summary
    plys = [os.path.join(d, f) for d, _, fs in os.walk(f"{out}/eval")
            for f in fs if f.endswith(".ply")]
    verts, faces = read_ply(plys[0])
    assert len(plys) == 1 and len(faces) > 0, (plys, len(faces))
    print(f"[grand_loop] {GRAND_LOOP_STEPS} steps: {json.dumps(summary)}; "
          f"mesh {len(verts)} vertices, {len(faces)} faces; {seconds:.1f} s")
    return summary


def phase_group_norm(device) -> None:
    """One b16 bf16 step of the hero model with GroupNorm-8 in the
    matching stem: K1, K2 and the scatter once each; then two passes
    from one state give the same gradient bits."""
    opts = hero_options(matching_norm="group")
    model = build_depth_model(opts, device=device, seed=0)
    assert isinstance(model.matching_model.net[1], torch.nn.GroupNorm)
    optimizer = train.make_optimizer(opts, model)
    batch = train.batch_to_device(train_batch(opts, TRAIN_BATCH, seed=7),
                                  device)
    reset_launches()
    losses, norms, step_ms = _run_steps(model, optimizer, batch,
                                        torch.Generator().manual_seed(0), 1)
    counts = launches()
    assert_launches(counts, {"K1": 1, "K2": 1, "scatter": 1})
    assert np.isfinite(losses[0]) and np.isfinite(norms[0]), (losses, norms)
    print(f"[group_norm] b{TRAIN_BATCH} bf16 step: launches {counts}; "
          + _series(losses, norms) + f"; {step_ms[0]:.1f} ms (first step)")
    assert_repeatable(model, batch, "group_norm")


CODEC_FIXTURES = "tests/data_torch"
SCAN_ROOT = "build/scannet_scan"
SCAN_EVAL_OUT = "build/eval_scan_out"
SCAN_TRAIN_OUT = "build/train_scan"
SCAN_STEPS = 4
SCAN_F1_TOL = 0.01
SCAN_SIZE = (384, 512)        # the scan's colour; its depth is 5/4 of it


def phase_codec() -> dict:
    """`native/image_codec.cpp` built on the card's host, then the
    committed fixtures decoded: each decode's SHA-256 must be the digest
    of Pillow's decode (`tests/data_torch/digests.json`, recorded where
    Pillow is). Times a 968x1296 JPEG and the 480x640 PNGs."""
    t0 = time.perf_counter()
    lib = native.load_library("image_codec")
    build_s = time.perf_counter() - t0
    with open(f"{CODEC_FIXTURES}/digests.json") as f:
        digests = json.load(f)
    ms = {}
    for name, want in sorted(digests.items()):
        with open(f"{CODEC_FIXTURES}/{name}", "rb") as f:
            data = f.read()
        image = codec.decode_image(data, name)
        got = hashlib.sha256(image.tobytes()).hexdigest()
        assert (got, list(image.shape), str(image.dtype)) == (
            want["sha256"], want["shape"], want["dtype"]), (name, got)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            codec.decode_image(data, name)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
    print(f"[codec] {lib._name}: g++ and load {build_s:.2f} s; {len(ms)} "
          "fixtures decode to Pillow's digests: " + ", ".join(sorted(ms)))
    print(f"[codec] decode ms a frame (median of 5): 968x1296 JPEG 4:2:0 "
          f"{ms['jpeg_968x1296.jpg']:.2f}, 480x640 PNG 8-bit RGB "
          f"{ms['png_rgb8_480x640.png']:.2f}, 480x640 PNG 16-bit grey "
          f"{ms['png_depth16_480x640.png']:.2f}")
    return ms


def scan_options(*args):
    return OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--dataset", "scannet", "--dataset_path", SCAN_ROOT,
        "--single_debug_scan_id", SCAN_ID, "--num_workers", "1", *args])


def generated_tuples(split: str, *args) -> list:
    """The port's `scripts/generate_tuples.py` on the written scan; its
    lines, each the scan and 8 of its frame ids."""
    out = generate_tuples.main(scan_options(
        "--split", split, "--num_images_in_tuple", "8",
        "--tuple_info_file_location", f"{SCAN_ROOT}/tuples", *args))
    lines = readlines(out)
    ids = {f"{i:06d}" for i in range(SYNTHETIC_FRAMES)}
    for line in lines:
        parts = line.split(" ")
        assert parts[0] == SCAN_ID and len(parts) == 9, line
        assert set(parts[1:]) <= ids, line
    return lines


def phase_scan_eval(device, synthetic_run: dict) -> dict:
    """The eval CLI over the 48-frame synthetic scene written in
    ScanNet's layout (`testing.write_scannet_scan`) with phase 17's 41
    tuples: the hero YAML at full width, phase 17's seeded weights, K1
    once a batch and no other kernel, finite metrics and a PLY, cached
    depths within `testing.EVAL_TOL` of phase 17's. The port's
    `generate_tuples` writes well-formed dense tuples of the scan."""
    shutil.rmtree(SCAN_ROOT, ignore_errors=True)
    shutil.rmtree(SCAN_EVAL_OUT, ignore_errors=True)
    t0 = time.perf_counter()
    write_scannet_scan(SCAN_ROOT, SYNTHETIC_FRAMES, *SCAN_SIZE)
    write_tuples(SCAN_ROOT, synthetic_tuples(SYNTHETIC_FRAMES, 8))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = generated_tuples("test", "--frame_tuple_type", "dense",
                             "--mv_tuple_file_suffix", "_dense.txt")
    tuples_s = time.perf_counter() - t0
    assert len(dense) == SYNTHETIC_FRAMES - 1, len(dense)

    opts = eval_options(SCAN_EVAL_OUT, "--dataset", "scannet",
                        "--dataset_path", SCAN_ROOT,
                        "--single_debug_scan_id", SCAN_ID, "--cache_depths")
    assert_hero_full_width(opts)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frame_avg, _ = eval_cli.main(opts)
    total = time.perf_counter() - t0
    counts = launches()
    stats = frame_avg.run_stats
    assert (stats["frames"], stats["batches"], stats["fused_frames"]) == (
        41, 3, 41), stats
    assert_launches(counts, {"K1": stats["batches"]})
    verts, faces = check_eval_outputs(opts, SCAN_ID)
    depths = compare_scan_depths(
        f"{eval_results(opts)}/depths/{SCAN_ID}",
        f"{eval_results(synthetic_run['opts'])}/depths/scene")
    assert depths["frames"] == 41, depths

    # the reader's decode of one frame: colour PNG, depth PNG at the
    # model's output size and at full size
    dataset = ScannetDataset(SCAN_ROOT, "test", None,
                             image_height=SCAN_SIZE[0],
                             image_width=SCAN_SIZE[1],
                             include_full_res_depth=True)
    times = []
    for i in range(8):
        fid = f"{i:06d}"
        t0 = time.perf_counter()
        dataset.load_color(SCAN_ID, fid)
        dataset.load_target_size_depth_and_mask(SCAN_ID, fid)
        dataset.load_full_res_depth_and_mask(SCAN_ID, fid)
        times.append((time.perf_counter() - t0) * 1e3)
    decode_ms = statistics.median(times)
    batches = stats["batches"]
    h, w = SCAN_SIZE
    print(f"[scan_eval] wrote the scan ({SYNTHETIC_FRAMES} frames, colour "
          f"{h}x{w} PNG, depth {h * 5 // 4}x{w * 5 // 4} 16-bit PNG) in "
          f"{write_s:.2f} s; "
          f"generate_tuples dense: {len(dense)} tuples in {tuples_s:.2f} s")
    print(f"[scan_eval] eval CLI --dataset scannet, hero b{opts.batch_size} "
          f"{opts.compute_dtype} {opts.image_height}x{opts.image_width}: "
          f"{stats['frames']} frames in {batches} batches; "
          f"launches {counts}; total {total:.2f} s (phase 17 "
          f"{synthetic_run['total']:.2f} s); loader wait "
          f"{stats['loader'] / batches * 1e3:.2f} ms a batch (phase 17 "
          f"{synthetic_run['stats']['loader'] / batches * 1e3:.2f}); "
          f"decode {decode_ms:.2f} ms a frame (colour, and depth at the "
          f"model's and at full size; median of 8); mesh {len(verts)} "
          f"vertices, "
          f"{len(faces)} faces; abs_rel "
          f"{frame_avg.final_metrics['abs_rel']:.4f}")
    print(f"[scan_eval] cached depths against phase 17's: {depths['frames']}"
          f" frames, largest relative difference {depths['depth_rel']:.2e}, "
          f"the same bits: {depths['same_bits']}")
    return dict(launches=counts, stats=stats, total=total,
                decode_ms=decode_ms, same_bits=depths["same_bits"])


def phase_scan_gt_fusion(device, synthetic_f1: float) -> dict:
    """The scan's 48 depths as the ScanNet reader reads them back (the
    480x640 millimetre PNGs to 192x256 by nearest neighbour, its
    intrinsics and poses) fused on the card as phase 18 fuses the
    synthetic GT: F1 against the room mesh within SCAN_F1_TOL of phase
    18's."""
    dataset = ScannetDataset(SCAN_ROOT, "test", None,
                             image_height=SCAN_SIZE[0],
                             image_width=SCAN_SIZE[1])
    fuser = OurFuser(fusion_resolution=0.04, max_fusion_depth=3.0,
                     bounds_3x2=synthetic_gt_bounds(), device=device)
    frames = []
    for i in range(SYNTHETIC_FRAMES):
        fid = f"{i:06d}"
        depth, _, _ = dataset.load_target_size_depth_and_mask(SCAN_ID, fid)
        _, cam_T_world = dataset.load_pose(SCAN_ID, fid)
        K = dataset.load_intrinsics(SCAN_ID, fid)["K_s0_b44"]
        frames.append([torch.from_numpy(np.asarray(a, np.float32)).to(device)
                       for a in (np.nan_to_num(depth), K, cam_T_world)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for depth, K, cam_T_world in frames:
        fuser.fuse_frames(depth[None], K[None], cam_T_world[None])
    end.record()
    end.synchronize()
    fuse_ms = start.elapsed_time(end) / len(frames)
    verts, faces = fuser.get_mesh()
    room_v, room_f, _ = make_room_mesh()
    scores = evaluate_mesh(verts, faces, room_v, room_f, num_points=100_000)
    print(f"[scan_gt_fusion] {len(frames)} depths read back from the scan: "
          f"{fuse_ms:.3f} ms/frame by CUDA events; mesh {len(verts)} "
          f"vertices, {len(faces)} faces; precision "
          f"{scores['precision']:.4f} recall {scores['recall']:.4f} F1 "
          f"{scores['f1']:.4f} (phase 18 {synthetic_f1:.4f})")
    assert abs(scores["f1"] - synthetic_f1) <= SCAN_F1_TOL, scores
    return dict(f1=scores["f1"], fuse_ms=fuse_ms)


def phase_scan_train(device) -> dict:
    """The port's `generate_tuples` with the train type on the scan, then
    `scripts/train.py --dataset scannet` at full width for SCAN_STEPS
    steps (batch 16, or the scan's tuple count when it has fewer; no
    validation): K1, K2 and the scatter once a step, no other kernel, no
    plain sweep, finite losses."""
    t0 = time.perf_counter()
    chains = generated_tuples("train")
    tuples_s = time.perf_counter() - t0
    shutil.copy(f"{SCAN_ROOT}/tuples/train{TUPLE_SUFFIX}",
                f"{SCAN_ROOT}/tuples/val{TUPLE_SUFFIX}")
    batch = min(TRAIN_BATCH, len(chains))
    assert batch > 0
    shutil.rmtree(SCAN_TRAIN_OUT, ignore_errors=True)
    opts = train_cli_options(
        SCAN_TRAIN_OUT, "--dataset", "scannet", "--dataset_path", SCAN_ROOT,
        "--single_debug_scan_id", SCAN_ID, "--tuple_info_file_location",
        f"{SCAN_ROOT}/tuples", "--max_steps", str(SCAN_STEPS),
        "--log_interval", "1", "--val_interval", str(10 * SCAN_STEPS),
        "--batch_size", str(batch))
    assert_hero_full_width(opts, batch)
    state, counts, total = run_train_cli(opts, device)
    assert_launches(counts, {"K1": SCAN_STEPS, "K2": SCAN_STEPS,
                             "scatter": SCAN_STEPS})
    assert state.step == SCAN_STEPS, state.step
    rows = read_jsonl(f"{SCAN_TRAIN_OUT}/{opts.name}/metrics.jsonl")
    assert [r["step"] for r in rows] == list(range(1, SCAN_STEPS + 1)), rows
    assert all(np.isfinite(v) for r in rows for v in r.values()), rows
    stats = state.run_stats
    print(f"[scan_train] generate_tuples train: {len(chains)} chains of 8 "
          f"frames in {tuples_s:.2f} s; batch {batch}"
          + ("" if batch == TRAIN_BATCH else
             f" (the scan's {len(chains)} tuples, fewer than {TRAIN_BATCH})")
          + f"; {SCAN_STEPS} steps, launches {counts}; losses "
          + ", ".join(f"{r['train/loss']:.4f}" for r in rows)
          + "; step ms " + ", ".join(f"{t * 1e3:.1f}"
                                     for t in stats["step_seconds"])
          + "; loader wait ms " + ", ".join(
              f"{t * 1e3:.1f}" for t in stats["loader_seconds"])
          + f"; total {total:.2f} s")
    del state
    return dict(launches=counts, batch=batch, total=total,
                loader_s=stats["loader_seconds"])


def phase_unet(device) -> dict:
    """The hero model with the UNet matching encoder at full width:
    served (K1 once an answer), trained three b16 bf16 steps (K1, K2 and
    the scatter once a step), two passes from one state with the same
    gradient bits, and card against CPU at 192x256 float32."""
    opts = hero_options(matching_encoder_type="unet_encoder")
    model = build_depth_model(opts, device=device, seed=0)
    assert isinstance(model.matching_model, UNetMatchingEncoder)
    assert model.compute_dtype == torch.bfloat16
    answers, latencies, served = serve(opts, model, "unet")
    assert_launches(served, {"K1": len(answers)})
    del model
    torch.cuda.empty_cache()

    model = build_depth_model(opts, device=device, seed=0)
    optimizer = train.make_optimizer(opts, model)
    batch = train.batch_to_device(train_batch(opts, TRAIN_BATCH, seed=7),
                                  device)
    steps = 3
    reset_launches()
    losses, norms, step_ms = _run_steps(model, optimizer, batch,
                                        torch.Generator().manual_seed(0),
                                        steps)
    trained = launches()
    assert_launches(trained, {"K1": steps, "K2": steps, "scatter": steps})
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses,
                                                                  norms)
    print(f"[unet] b{TRAIN_BATCH} bf16, {steps} steps: launches {trained};"
          f" " + _series(losses, norms) + "; step ms "
          + ", ".join(f"{x:.2f}" for x in step_ms)
          + f"; b1 request ms median {statistics.median(latencies):.2f}")
    assert_repeatable(model, batch, "unet")
    del model, optimizer, batch
    torch.cuda.empty_cache()
    phase_card_vs_cpu(device, hero_options(
        image_height=192, image_width=256, precision="32",
        matching_encoder_type="unet_encoder"), "unet_card_vs_cpu")
    return dict(served=served, trained=trained,
                b1_ms=statistics.median(latencies),
                step_ms=statistics.median(step_ms[1:]))


PC_OUT = "build/pc_fusion_out"
LIVE_OUT = "build/live_meshing_out"


def read_video_frames(path: str) -> int:
    """The frames OpenCV decodes from the video at `path`."""
    import cv2
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase_pc_fusion(device) -> dict:
    """`scripts/pc_fusion.py` on the 48-frame scene with the hero YAML,
    then its predicted depths through the consistency pass on the card
    and on the CPU."""
    shutil.rmtree(PC_OUT, ignore_errors=True)
    opts = eval_options(PC_OUT, "--pc_fusion_z_thresh", "0.5",
                        "--n_consistent_thresh", "1")
    assert_hero_full_width(opts)
    captured = {}
    fuse = pc_fusion.process_scene

    def keep_inputs(*args, **kw):
        captured.update(args=args, kw=kw)
        return fuse(*args, **kw)

    pc_fusion.process_scene = keep_inputs
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = pc_fusion.main(opts)
        total = time.perf_counter() - t0
        counts = launches()
    finally:
        pc_fusion.process_scene = fuse
    assert (stats["frames"], stats["batches"]) == (41, 3), stats
    assert_launches(counts, {"K1": 3})
    verts, faces = read_ply(stats["plys"]["scene"])
    assert len(verts) == stats["points"]["scene"] > 0 and len(faces) == 0
    assert np.isfinite(verts).all()

    depths, poses, Ks, invKs = captured["args"][:4]
    kw = captured["kw"]
    clouds, keeps = {}, {}
    for tag, dev in (("gpu", device), ("cpu", "cpu")):
        passes = point_cloud.fuse_points(
            depths, poses, Ks, invKs, z_thresh=kw["z_thresh"],
            n_consistent=kw["n_consistent"], device=dev)
        keeps[tag] = np.stack([keep for _, keep in passes])
        clouds[tag] = point_cloud.voxel_downsample(
            np.concatenate([pts[keep] for pts, keep in passes]),
            kw["voxel_downsample_size"])[0]
    differ = float((keeps["gpu"] != keeps["cpu"]).mean())
    n_gpu, n_cpu = len(clouds["gpu"]), len(clouds["cpu"])
    assert n_gpu == stats["points"]["scene"], (n_gpu, stats["points"])
    pass_ms = stats["pass_ms"]
    assert len(pass_ms) == depths.shape[0] == 41, len(pass_ms)
    print(f"[pc_fusion] hero b{opts.batch_size} bf16 384x512, "
          f"{stats['frames']} frames in {stats['batches']} batches; "
          f"launches {counts}; {n_gpu} fused points (kept "
          f"{int(keeps['gpu'].sum())} of {keeps['gpu'].size} pixels); "
          f"consistency pass ms by CUDA events median "
          f"{statistics.median(pass_ms):.3f} (first {pass_ms[0]:.3f}, "
          f"{len(pass_ms)} passes over {depths.shape[0]} frames of "
          f"{depths.shape[1]}x{depths.shape[2]}); forward "
          f"{stats['forward_s']:.2f} s, fusion {stats['fusion_s']:.2f} s, "
          f"total {total:.2f} s; card against CPU: keep masks differ at "
          f"{differ:.2e} of pixels, clouds {n_gpu} and {n_cpu} points")
    assert differ <= 1e-4, differ
    assert abs(n_gpu - n_cpu) <= 1e-3 * n_cpu, (n_gpu, n_cpu)
    return dict(launches=counts, total=total,
                pass_ms=statistics.median(pass_ms))


def phase_live_meshing(device) -> dict:
    """`scripts/visualize_live_meshing.py` on the 48-frame scene at b1
    into a fresh directory: K1 once a keyframe, two videos that read
    back."""
    shutil.rmtree(LIVE_OUT, ignore_errors=True)
    opts = eval_options(LIVE_OUT)
    assert_hero_full_width(opts)
    ranges = []
    write = live_meshing.write_video

    def keep_ranges(path, frames, fps=30):
        ranges.append((min(float(f.min()) for f in frames),
                       max(float(f.max()) for f in frames)))
        return write(path, frames, fps=fps)

    live_meshing.write_video = keep_ranges
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        stats = live_meshing.main(opts)
        total = time.perf_counter() - t0
        counts = launches()
    finally:
        live_meshing.write_video = write
    assert (stats["keyframes"], stats["forwards"], stats["cached"]) == (
        41, 41, 0), stats
    assert_launches(counts, {"K1": 41})
    frames = stats["frames"]["scene"]
    videos = stats["videos"]["scene"]
    decoded = [read_video_frames(path) for path in videos]
    keyframe_ms = [x * 1e3 for x in stats["keyframe_s"]]
    print(f"[live_meshing] hero b1 bf16 384x512, {stats['keyframes']} "
          f"keyframes; launches {counts}; {frames} frames with a mesh; "
          f"videos {videos} decode to {decoded} frames; value ranges "
          f"{ranges}; ms a keyframe median "
          f"{statistics.median(keyframe_ms):.1f} (first "
          f"{keyframe_ms[0]:.1f}); total {total:.2f} s")
    assert frames > 0 and all(v.endswith(".mp4") for v in videos)
    assert decoded == [frames, frames], (decoded, frames)
    assert all(0.0 <= lo and hi <= 1.0 for lo, hi in ranges), ranges
    return dict(launches=counts, total=total,
                keyframe_ms=statistics.median(keyframe_ms))


def phase_depth_video(device) -> dict:
    """The GT min/max cache, then `scripts/visualize_scene_depth_output.py`
    over phase 17's cached depths: no kernel, 41 frames with sides that
    are multiples of 16, a video that reads back."""
    opts = eval_options(EVAL_OUT)
    shapes = []
    write = depth_video.write_video

    def keep_shapes(path, frames, fps=30):
        shapes.extend({f.shape for f in frames})
        return write(path, frames, fps=fps)

    depth_video.write_video = keep_shapes
    try:
        reset_launches()
        t0 = time.perf_counter()
        generate_gt_min_max_cache.main(opts)
        written = depth_video.main(opts)
        total = time.perf_counter() - t0
        counts = launches()
    finally:
        depth_video.write_video = write
    assert_launches(counts, {})
    frames, path = written["scene"]
    decoded = read_video_frames(path)
    print(f"[depth_video] {frames} frames of {shapes} from "
          f"{eval_results(opts)}/depths/scene -> {path}, {decoded} decoded;"
          f" launches {counts}; total {total:.2f} s")
    assert frames == 41 and decoded == 41, (frames, decoded)
    assert shapes and all(h % 16 == 0 and w % 16 == 0 for h, w, _ in shapes)
    return dict(launches=counts, total=total)


DDP_OUT = "build/ddp_shared"
DDP_CLI_OUT = "build/ddp_train_cli"
DP_EVAL_OUT = "build/dp_eval_out"
DDP_STEPS = 2
DDP_TIMED_STEPS = 3
DDP_CLI_STEPS = 4
# two ranks sharing the card against the single-process mean of the two
# b8 halves, after DDP_STEPS AdamW steps: relative L2 of the parameters
# and of the running statistics (the same kernels on the same rows: the
# same bits are expected; Adam's first updates move a weight by about
# lr x the sign of its gradient, so a gradient summed another way shows
# as ~1e-4, a missing or wrong average as ~1)
DDP_SHARED_TOL = 1e-3
# the data-parallel eval (b8 shards) against phase 17 (b16 batches), bf16:
# relative L2 of each depth map, and the share of lowest-cost pixels on
# the same plane
DP_EVAL_L2_TOL = 1e-2
DP_EVAL_LOWEST_AGREE = 0.99


def rank_launches(rank_stats: dict) -> dict:
    """A rank's launch counts (wrapper names) by the names of COUNTERS."""
    counts = rank_stats["launches"]
    return {name: counts[fn.__name__] for name, fn in COUNTERS.items()}


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_ddp_single(device, bare_step_ms: float) -> dict:
    """32: the hero b16 bf16 training step through
    `parallel/train.py::ddp_train_step` at world size 1 over NCCL against
    `train_step`: losses, gradient norm, every gradient, parameter and
    buffer the same bits; then DDP_TIMED_STEPS more steps of each, timed."""
    opts = hero_options()
    batch = train.batch_to_device(train_batch(opts, TRAIN_BATCH, seed=7),
                                  device)
    torch.cuda.empty_cache()
    os.makedirs(DDP_OUT, exist_ok=True)
    init_file = os.path.abspath(f"{DDP_OUT}/world1")
    if os.path.exists(init_file):
        os.remove(init_file)
    backend = mesh.init_process_group(0, 1, init_file, device, "nccl")
    runs = {}
    try:
        for tag in ("plain", "ddp"):
            model = build_depth_model(opts, device=device, seed=0)
            optimizer = train.make_optimizer(opts, model)
            generator = torch.Generator().manual_seed(0)
            if tag == "plain":
                def step():
                    return train.train_step(model, optimizer, batch,
                                            generator)
            else:
                wrapped = train.wrap_ddp(model)

                def step():
                    return train.ddp_train_step(wrapped, optimizer, batch,
                                                generator)
            torch.cuda.synchronize()
            reset_launches()
            metrics = step()
            torch.cuda.synchronize()
            counts = launches()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            state = _state(model)
            step_ms = []
            for _ in range(DDP_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            runs[tag] = dict(metrics={k: float(v) for k, v in metrics.items()},
                             grads=grads, state=state, counts=counts,
                             step_ms=step_ms)
            del model, optimizer, step
            torch.cuda.empty_cache()
    finally:
        mesh.destroy_process_group()
    plain, ddp = runs["plain"], runs["ddp"]
    for run in runs.values():
        assert_launches(run["counts"], {"K1": 1, "K2": 1, "scatter": 1})
    grads_differ = [n for n, g in plain["grads"].items()
                    if not torch.equal(g, ddp["grads"][n])]
    state_differ = [k for k, v in plain["state"].items()
                    if not torch.equal(v, ddp["state"][k])]
    print(f"[ddp_single] hero b{TRAIN_BATCH} bf16, {backend} world size 1:"
          f" launches {ddp['counts']}; loss {ddp['metrics']['loss']!r} "
          f"(plain {plain['metrics']['loss']!r}); gradients that differ "
          f"{len(grads_differ)} of {len(plain['grads'])}, state entries "
          f"that differ {len(state_differ)} of {len(plain['state'])}"
          + (f" ({grads_differ[:3]}, {state_differ[:3]})"
             if grads_differ or state_differ else ""))
    print(f"[ddp_single] step ms: DDP " + ", ".join(
        f"{x:.2f}" for x in ddp["step_ms"]) + "; plain " + ", ".join(
        f"{x:.2f}" for x in plain["step_ms"])
        + f" (phase 7's bare step {bare_step_ms:.2f})")
    assert plain["metrics"] == ddp["metrics"], (plain["metrics"],
                                                ddp["metrics"])
    assert not grads_differ and not state_differ
    return dict(step_ms=statistics.median(ddp["step_ms"]),
                plain_ms=statistics.median(plain["step_ms"]))


def phase_ddp_shared(device) -> dict:
    """33: two ranks share the card over gloo (NCCL takes one rank a
    card): the hero at full width, global batch 16 (b8 a rank), bf16,
    DDP_STEPS steps with the flip coin of one seeded generator. K1, K2 and
    the scatter once per rank per step; the ranks' parameters and buffers
    the same bits; the result within DDP_SHARED_TOL of the single-process
    mean of the two b8 halves (its losses, gradient norm, parameters and
    running statistics); step ms and peak memory per rank."""
    opts = hero_options()
    batch = train_batch(opts, TRAIN_BATCH, seed=7)
    shutil.rmtree(DDP_OUT, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ranks = run_ddp_steps(2, DDP_OUT, opts, 0, batch, [None] * DDP_STEPS,
                          device_type="cuda", backend="gloo")
    wall = time.perf_counter() - t0
    assert_launches(launches(), {})         # the parent launched nothing
    for rank in ranks:
        assert_launches(rank_launches(rank), {
            "K1": DDP_STEPS, "K2": DDP_STEPS, "scatter": DDP_STEPS})
    want, ref = shard_mean_steps(opts, batch, 2, DDP_STEPS, device)
    torch.cuda.empty_cache()
    report = compare_ranks(ranks, want, ref)
    assert report["ranks_equal"], report
    got = ranks[0]["metrics"]
    step_ms = [r["step_ms"] for r in ranks]
    peak = [r["peak_memory_bytes"] / 2 ** 30 for r in ranks]
    print(f"[ddp_shared] hero global b{TRAIN_BATCH} bf16 over 2 gloo ranks "
          f"on one card, {DDP_STEPS} steps: launches per rank "
          f"{[rank_launches(r) for r in ranks]}; losses " + ", ".join(
              f"{m['loss']:.6f}" for m in got) + " (single-process mean "
          + ", ".join(f"{m['loss']:.6f}" for m in want) + ")")
    print(f"[ddp_shared] against the single-process mean of the halves: "
          f"parameters relative L2 {report['param_rel']:.3e}, running "
          f"statistics {report['stat_rel']:.3e}, losses and gradient norms "
          f"{report['loss_rel']:.3e}, the same bits: {report['same_bits']};"
          f" ranks bit-equal: True; step ms per rank "
          f"{[[round(x, 2) for x in ms] for ms in step_ms]}; peak memory "
          f"per rank {[round(x, 2) for x in peak]} GiB; wall {wall:.1f} s "
          "with the ranks' start")
    assert max(report["param_rel"], report["stat_rel"],
               report["loss_rel"]) <= DDP_SHARED_TOL, report
    return dict(ranks=[rank_launches(r) for r in ranks],
                step_ms=[statistics.median(ms[1:]) for ms in step_ms],
                peak_gib=peak, param_rel=report["param_rel"],
                same_bits=report["same_bits"])


def phase_ddp_clis(device, eval_run: dict) -> dict:
    """34: the training CLI with `--num_devices 2` on the shared card
    (`backend="gloo"`) at full width, DDP_CLI_STEPS steps, a log every 2,
    a validation at the end: K1, K2 and the scatter once per rank per step
    (and K1 once for rank 0's validation batch), the JSON lines and a
    checkpoint the single-device restore reads; then the eval CLI with
    `--data_parallel_eval` over ["cuda:0", "cuda:0"] on the 41-frame
    scene: K1 once a shard, depths within DP_EVAL_L2_TOL of phase 17's."""
    shutil.rmtree(DDP_CLI_OUT, ignore_errors=True)
    opts = train_cli_options(
        DDP_CLI_OUT, "--num_devices", "2", "--max_steps",
        str(DDP_CLI_STEPS), "--log_interval", "2", "--val_interval",
        str(DDP_CLI_STEPS))
    assert_hero_full_width(opts)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    with plain_sweeps() as plain:
        reset_launches()
        t0 = time.perf_counter()
        state = train_cli.main(opts, device=device, backend="gloo")
        train_s = time.perf_counter() - t0
        counts = launches()
    assert plain[0] == 0 and not any(counts.values()), (plain, counts)
    ranks = state.run_stats["ranks"]
    for rank, stats in enumerate(ranks):
        assert stats["steps"] == DDP_CLI_STEPS, stats["steps"]
        assert_launches(rank_launches(stats), {
            "K1": DDP_CLI_STEPS + (1 if rank == 0 else 0),
            "K2": DDP_CLI_STEPS, "scatter": DDP_CLI_STEPS})
    assert state.step == state.optimizer.count == DDP_CLI_STEPS
    root = f"{DDP_CLI_OUT}/{opts.name}"
    rows = read_jsonl(f"{root}/metrics.jsonl")
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [2, 4], rows
    assert all(set(r) == TRAIN_ROW_KEYS for r in train_rows), train_rows
    assert all(np.isfinite(v) for r in rows for v in r.values()), rows
    assert [r["step"] for r in rows if "val/loss" in r] == [DDP_CLI_STEPS]
    assert os.listdir(f"{root}/checkpoints") == [f"step_{DDP_CLI_STEPS}"]
    step_ms = [[t * 1e3 for t in r["step_seconds"]] for r in ranks]
    print(f"[ddp_train_cli] --num_devices 2 on one card over gloo, hero "
          f"global b{opts.batch_size} bf16: launches per rank "
          f"{[rank_launches(r) for r in ranks]} (parent {counts}); losses "
          + ", ".join(f"{r['step']}: {r['train/loss']:.4f}"
                      for r in train_rows)
          + f"; step ms per rank {[[round(x, 1) for x in ms] for ms in step_ms]}"
          f"; peak memory per rank "
          f"{[round(r['peak_memory_bytes'] / 2 ** 30, 2) for r in ranks]} "
          f"GiB; total {train_s:.1f} s")
    del state
    torch.cuda.empty_cache()

    shutil.rmtree(DP_EVAL_OUT, ignore_errors=True)
    eval_opts = eval_options(DP_EVAL_OUT, "--cache_depths",
                             "--data_parallel_eval")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    frame_avg, _ = eval_cli.main(eval_opts, devices=["cuda:0", "cuda:0"])
    eval_s = time.perf_counter() - t0
    eval_counts = launches()
    stats = frame_avg.run_stats
    assert (stats["frames"], stats["batches"]) == (41, 3), stats
    assert_launches(eval_counts, {"K1": 2 * stats["batches"]})
    check_eval_outputs(eval_opts)
    depths = compare_depth_maps(
        f"{eval_results(eval_opts)}/depths/scene",
        f"{eval_results(eval_run['opts'])}/depths/scene")
    print(f"[dp_eval] --data_parallel_eval over cuda:0 twice: "
          f"{stats['frames']} frames in {stats['batches']} batches, launches "
          f"{eval_counts}; forward {stats['forward_device'] / 41 * 1e3:.3f} "
          f"ms/frame by CUDA events (phase 17 "
          f"{eval_run['stats']['forward_device'] / 41 * 1e3:.3f}); total "
          f"{eval_s:.2f} s; against phase 17's depths: {depths}")
    assert depths["frames"] == 41, depths
    assert depths["depth_l2"] <= DP_EVAL_L2_TOL, depths
    assert depths["lowest_agree"] >= DP_EVAL_LOWEST_AGREE, depths
    return dict(ranks=[rank_launches(r) for r in ranks],
                step_ms=[statistics.median(ms[1:]) for ms in step_ms],
                train_s=train_s, eval_counts=eval_counts, eval_s=eval_s,
                depths=depths)


SENS_OUT = "build/sens_export"
IOS_OUT = "build/ios_capture"
EXPORT_FRAMES = 8


def phase_exports() -> dict:
    """35: host exports. A `.sens` file (`testing.write_sens`) whose
    colour frames are the 968x1296 fixture JPEG, exported by
    `SensorData.export_color_images` at 480x640: every file the bytes
    Pillow writes for those pixels (`tests/data_torch/jpeg_encode.json`);
    then an ios-logger capture written on this machine
    (`testing.write_ios_capture`: an mp4v `Frames.m4v` of 480x640 frames)
    through `scripts/preprocess_ios_logger.py`: one PNG, pose and
    intrinsics file a frame, the PNGs near the frames written, the poses
    rigid. ms a frame of each."""
    with open(f"{CODEC_FIXTURES}/jpeg_encode.json") as f:
        want = json.load(f)
    with open(f"{CODEC_FIXTURES}/{want['source']}", "rb") as f:
        jpeg = f.read()
    colour = codec.decode_image(jpeg)
    shutil.rmtree(SENS_OUT, ignore_errors=True)
    os.makedirs(SENS_OUT)
    sens = f"{SENS_OUT}/scan.sens"
    write_sens(sens, [jpeg] * EXPORT_FRAMES,
               [np.full((480, 640), 1500, np.uint16)] * EXPORT_FRAMES,
               colour.shape[:2], (480, 640))
    reader = SensorData(sens)
    t0 = time.perf_counter()
    reader.export_color_images(f"{SENS_OUT}/sensor_data",
                               image_size=tuple(want["size"]))
    sens_ms = (time.perf_counter() - t0) * 1e3 / EXPORT_FRAMES
    names = sorted(os.listdir(f"{SENS_OUT}/sensor_data"))
    assert names == [f"frame-{i:06d}.color.jpg"
                     for i in range(EXPORT_FRAMES)], names
    for name in names:
        with open(f"{SENS_OUT}/sensor_data/{name}", "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == want["sha256"], name
        assert codec.decode_image(data).shape == tuple(want["size"]) + (3,)

    shutil.rmtree(IOS_OUT, ignore_errors=True)
    frames = []
    for i in range(EXPORT_FRAMES):
        frame = codec.resize(np.roll(colour, 40 * i, axis=1), 480, 640)
        frames.append(np.ascontiguousarray(frame[..., ::-1]))
    write_ios_capture(IOS_OUT, frames)
    t0 = time.perf_counter()
    n = preprocess_ios_logger.process_scan(IOS_OUT)
    ios_ms = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    assert n == EXPORT_FRAMES, n
    psnrs = []
    for i in range(n):
        png = codec.read_image(f"{IOS_OUT}/images/{i:06d}.png")
        assert png.shape == (480, 640, 3), png.shape
        err = np.mean((png.astype(np.float64)
                       - frames[i][..., ::-1].astype(np.float64)) ** 2)
        psnrs.append(10 * np.log10(255.0 ** 2 / max(err, 1e-12)))
        pose = np.loadtxt(f"{IOS_OUT}/poses/{i:06d}.txt")
        rot = pose[:3, :3]
        assert np.allclose(rot @ rot.T, np.eye(3), atol=1e-5), pose
        intr = np.loadtxt(f"{IOS_OUT}/intrinsics/{i:06d}.txt")
        assert tuple(intr[4:]) == (640, 480), intr
    print(f"[exports] .sens colour export: {len(names)} frames of "
          f"{want['source']} at {want['size'][0]}x{want['size'][1]}, each "
          f"Pillow's bytes; {sens_ms:.2f} ms a frame (decode, resize, "
          f"encode, write); ios-logger: {n} frames from an mp4v "
          f"Frames.m4v, PNG PSNR against the frames written "
          f"{min(psnrs):.2f}-{max(psnrs):.2f} dB; {ios_ms:.2f} ms a frame")
    assert min(psnrs) >= 25.0, psnrs
    return dict(sens_ms=sens_ms, ios_ms=ios_ms)


def kernel_entry(name, source, replaces, launches_on_path, measured) -> dict:
    bound, bound_by = measured["bound"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_on_path,
            "max_abs_err": measured["max_abs_err"], "ms": measured["ms"],
            "plain_ms": measured["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": measured.get("library_ms")}


def main():
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    kernel = phase_kernel(device)
    hero_infer = phase_hero(device)
    phase_card_vs_cpu(device, hero_options(image_height=192, image_width=256,
                                           precision="32"), "card_vs_cpu")
    backward, scatter = phase_backward(device)
    trained = phase_train(device)
    phase_train_card_vs_cpu(
        device, hero_options(image_height=192, image_width=256,
                             precision="32"),
        HERO_COMPARED, CHECK_STEPS, "train_card_vs_cpu", perturbed=True)
    dot_kernel = phase_dot_kernel(device)
    pool_kernel, pool_dtype = phase_pool_kernels(device)
    dot_infer = phase_dot_infer(device)
    dot_trained = phase_dot_train(device)
    dot_small = dot_options(image_height=192, image_width=256, precision="32")
    phase_card_vs_cpu(device, dot_small, "dot_card_vs_cpu")
    phase_train_card_vs_cpu(device, dot_small, DOT_COMPARED, 1,
                            "dot_train_card_vs_cpu", perturbed=False)
    early_kernel = phase_early_kernels(device)
    early_served = phase_early_serve(device)
    for backend in ("pallas_v1", "pallas_full"):
        phase_card_vs_cpu(
            device, hero_options(image_height=192, image_width=256,
                                 precision="32", cost_volume_backend=backend),
            f"card_vs_cpu {backend}")
    eval_run = phase_eval_cli(device)
    gt_fusion = phase_gt_fusion(device)
    phase_eval_card_vs_cpu(device)
    t_new = time.perf_counter()
    train_run = phase_train_cli(device, trained["step_ms"])
    phase_resume(device, train_run["opts"])
    phase_grand_loop(device)
    phase_group_norm(device)
    t_scan = time.perf_counter()
    print(f"[summary] phases 20-23 took {t_scan - t_new:.1f} s")
    phase_codec()
    scan_eval = phase_scan_eval(device, eval_run)
    phase_scan_gt_fusion(device, gt_fusion["f1"])
    scan_train = phase_scan_train(device)
    t_viz = time.perf_counter()
    print(f"[summary] phases 24-27 took {t_viz - t_scan:.1f} s"
          f" (phases 20-23 {t_scan - t_new:.1f} s)")
    unet = phase_unet(device)
    pc_run = phase_pc_fusion(device)
    live_run = phase_live_meshing(device)
    phase_depth_video(device)
    t_ddp = time.perf_counter()
    print(f"[summary] phases 28-31 took {t_ddp - t_viz:.1f} s")
    ddp_single = phase_ddp_single(device, trained["step_ms"])
    ddp_shared = phase_ddp_shared(device)
    ddp_clis = phase_ddp_clis(device, eval_run)
    phase_exports()
    print(f"[summary] phases 32-35 took {time.perf_counter() - t_ddp:.1f} s")
    loaded = [m for m in sys.modules if m in ("jax", "flax", "yaml", "PIL")
              or m == "simplerecon_tpu" or m.startswith("simplerecon_tpu.")]
    assert not loaded, f"the port pulled in {loaded}"

    # the training path's shapes: hero b16 for K1, K2 and the scatter of
    # K2's d_src, the dot model's b16 for K1-dot, and its encoder's b16
    # stem for K3; K5 and K4 are inference-only: hero b8 (for K5 one of
    # its two launches there)
    b16 = f"hero_b{TRAIN_BATCH}_bfloat16"
    stem = f"encoder_b{TRAIN_BATCH}_{str(pool_dtype).split('.')[-1]}"
    hero_k, dot_k = trained["launches"], dot_trained["launches"]
    print(f"[summary] inference: hero K1 {hero_infer}, K5 "
          f"{early_served['K5']}, K4 {early_served['K4']}; dot K1-dot "
          f"{dot_infer['K1-dot']}, K3-fwd {dot_infer['K3-fwd']}. training "
          f"steps: hero {hero_k}; dot {dot_k}. eval CLI: K1 "
          f"{eval_run['launches']['K1']}, forward "
          f"{eval_run['stats']['forward_device'] * 1e3:.1f} ms, TSDF "
          f"{eval_run['stats']['fusion'] * 1e3:.1f} ms, marching cubes "
          f"{eval_run['stats']['marching_cubes'] * 1e3:.1f} ms, total "
          f"{eval_run['total']:.1f} s. training CLI: "
          f"{train_run['launches']}, step {train_run['step_ms']:.1f} ms "
          f"(bare {trained['step_ms']:.1f}), total "
          f"{train_run['total']:.1f} s. file-backed eval CLI: K1 "
          f"{scan_eval['launches']['K1']}, total {scan_eval['total']:.1f} s;"
          f" file-backed training CLI: {scan_train['launches']}, total "
          f"{scan_train['total']:.1f} s. UNet hero: served "
          f"{unet['served']}, b1 {unet['b1_ms']:.2f} ms; trained "
          f"{unet['trained']}, step {unet['step_ms']:.1f} ms. pc_fusion: "
          f"K1 {pc_run['launches']['K1']}, pass {pc_run['pass_ms']:.3f} ms,"
          f" total {pc_run['total']:.1f} s. live meshing: K1 "
          f"{live_run['launches']['K1']}, {live_run['keyframe_ms']:.1f} ms "
          f"a keyframe, total {live_run['total']:.1f} s. DDP: world size 1 "
          f"step {ddp_single['step_ms']:.1f} ms (plain "
          f"{ddp_single['plain_ms']:.1f}); two ranks on one card "
          f"{ddp_shared['ranks']}, step {ddp_shared['step_ms']} ms; train "
          f"CLI --num_devices 2 {ddp_clis['ranks']}; data-parallel eval "
          f"{ddp_clis['eval_counts']}. run total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        kernel_entry("fused_sweep_mlp",
                     "simplerecon_tpu_torch/csrc/fused_sweep.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:513", hero_k["K1"],
                     kernel[b16]),
        kernel_entry("fused_sweep_mlp_bwd",
                     "simplerecon_tpu_torch/csrc/fused_sweep_bwd.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:1047", hero_k["K2"],
                     backward[b16]),
        kernel_entry("sweep_scatter",
                     "simplerecon_tpu_torch/csrc/sweep_scatter.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:1047",
                     hero_k["scatter"], scatter[b16]),
        kernel_entry("fused_sweep_dot",
                     "simplerecon_tpu_torch/csrc/fused_sweep.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:747", dot_k["K1-dot"],
                     dot_kernel[b16]),
        kernel_entry("fused_sweep_dot_cur_grad",
                     "simplerecon_tpu_torch/csrc/fused_sweep.cu",
                     "simplerecon_tpu/models/cost_volume.py:88",
                     dot_k["K1-dot d_cur"], dot_kernel[b16]["dcur"]),
        kernel_entry("max_blur_pool_fwd",
                     "simplerecon_tpu_torch/csrc/max_blur_pool.cu",
                     "simplerecon_tpu/ops/pallas_pool.py:335",
                     dot_k["K3-fwd"], pool_kernel[stem]["fwd"]),
        kernel_entry("max_blur_pool_bwd",
                     "simplerecon_tpu_torch/csrc/max_blur_pool.cu",
                     "simplerecon_tpu/ops/pallas_pool.py:281",
                     dot_k["K3-bwd"], pool_kernel[stem]["bwd"]),
        kernel_entry("fused_feature_volume",
                     "simplerecon_tpu_torch/csrc/early_sweeps.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:151",
                     early_served["K5"],
                     early_kernel[("K5", "hero_b8_bfloat16")]),
        kernel_entry("fused_warp_feature_volume",
                     "simplerecon_tpu_torch/csrc/early_sweeps.cu",
                     "simplerecon_tpu/ops/pallas_cv.py:664",
                     early_served["K4"],
                     early_kernel[("K4", "hero_b8_bfloat16")]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
