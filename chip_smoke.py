"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero, and only a run that passes them all prints the last line:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the CUDA kernels from `simplerecon_tpu_torch/csrc`, timed;
3. the fused sweep kernel against its plain PyTorch version at the hero
   shape (b=1, k=7, 96x128, c=16, d=64) and at a small odd shape, in
   float32 (TF32 off) and bf16, and at hero b=8 in bf16, with CUDA-event
   times of both;
4. the hero model (384x512, 8 views, 64 planes, bf16, seeded random
   weights) through `OnlineSession` over a 12-frame posed stream: outputs
   finite and of the right shapes, one kernel launch per answered frame,
   per-request latency;
5. the card against the CPU in float32 at a reduced size (192x256, hero
   widths): the kernel path against the plain path, same weights.

The line before the last is the kernel report as JSON; the last line is
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

import json
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
from simplerecon_tpu_torch.online import \
    OnlineSession, make_batch  # noqa: E402
from simplerecon_tpu_torch.ops import _build, cuda_cv  # noqa: E402
from simplerecon_tpu_torch.testing import (  # noqa: E402
    hero_options, posed_stream, spread_outputs_, sweep_case)

KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SIGNAL_FRACTION = 0.02   # card vs CPU: max |diff| <= 2% of the CPU map's std
MIN_STD = 1e-2


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


def phase_build():
    lib, seconds = _build.build()
    cuda_cv_lib = _build.load_library()
    assert cuda_cv_lib.fused_sweep_mlp is not None
    print(f"[build] {lib.name}: nvcc {seconds:.2f} s")
    ptxas = lib.with_suffix(".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")
    return seconds


def phase_kernel(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    fp32_bf16 = (torch.float32, torch.bfloat16)
    for name, shape, dtypes in (
            ("odd", (2, 3, 13, 21, 8, 5), fp32_bf16),
            ("hero_b1", (1, 7, 96, 128, 16, 64), fp32_bf16),
            ("hero_b8", (8, 7, 96, 128, 16, 64), (torch.bfloat16,))):
        for dtype in dtypes:
            args = sweep_case(*shape, dtype=dtype, device=device, seed=1)
            before = cuda_cv.fused_sweep.launches
            with torch.no_grad():
                got = cuda_cv.fused_sweep(*args)
                want = cuda_cv.fused_sweep_reference(*args)
            torch.cuda.synchronize()
            assert cuda_cv.fused_sweep.launches == before + 1
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
            print(f"[kernel] {tag}: shape {shape} max_abs_err {err:.3e} "
                  f"(tol {tol:.1e}) kernel {ms:.3f} ms "
                  f"plain {plain_ms:.3f} ms")
            assert err <= tol, (tag, err, tol)
            report[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return report


def phase_hero(device) -> int:
    opts = hero_options()
    model = build_depth_model(opts, device=device, seed=0)
    assert model.compute_dtype == torch.bfloat16
    session = OnlineSession(opts, model)
    frames = posed_stream(12, opts.image_height, opts.image_width, seed=2)

    cuda_cv.fused_sweep.launches = 0
    latencies, answers = [], []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = session.process_frame(frame)
        if out is not None:
            latencies.append((time.perf_counter() - t0) * 1e3)
            answers.append(out)
    launches = cuda_cv.fused_sweep.launches

    assert len(answers) >= 3, len(answers)
    assert launches == len(answers), (launches, len(answers))
    h, w = opts.image_height, opts.image_width
    for out in answers:
        for i in range(4):
            for key in (f"log_depth_pred_s{i}_bhw1", f"depth_pred_s{i}_bhw1"):
                assert out[key].shape == (1, h >> (i + 1), w >> (i + 1), 1)
                assert np.isfinite(out[key]).all(), key
        assert out["lowest_cost_bhw"].shape == (1, h // 4, w // 4)
        assert out["overall_mask_bhw"].shape == (1, h // 4, w // 4)
        assert out["overall_mask_bhw"].dtype == bool
    print(f"[hero] {len(frames)} frames, {len(answers)} answered, "
          f"kernel launches {launches}; request latency ms "
          f"median {statistics.median(latencies):.2f} "
          f"(first {latencies[0]:.2f}, all "
          f"{', '.join(f'{x:.2f}' for x in latencies)}); "
          f"overall_mask mean {answers[-1]['overall_mask_bhw'].mean():.3f}")
    return launches


def phase_card_vs_cpu(device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts = hero_options(image_height=192, image_width=256, precision="32")
    cpu_model = spread_outputs_(build_depth_model(opts, seed=5), seed=5)
    gpu_model = build_depth_model(opts, device=device, seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    frames = posed_stream(8, opts.image_height, opts.image_width, seed=3)
    results = {}
    for tag, model in (("cpu", cpu_model), ("gpu", gpu_model)):
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
        print(f"[card_vs_cpu] {tag} forward {time.perf_counter() - t0:.2f} s")
        results[tag] = out
    for key in ["cost_volume_bhwd"] + [f"log_depth_pred_s{i}_bhw1"
                                       for i in range(4)]:
        ref, got = results["cpu"][key], results["gpu"][key]
        std = ref.std().item()
        err = (got - ref).abs().max().item()
        print(f"[card_vs_cpu] {key}: max_abs_err {err:.3e} std {std:.3e} "
              f"ratio {err / std:.2e}")
        assert std >= MIN_STD, (key, std)
        assert err <= SIGNAL_FRACTION * std, (key, err, std)
    agree = (results["cpu"]["overall_mask_bhw"]
             == results["gpu"]["overall_mask_bhw"]).float().mean().item()
    print(f"[card_vs_cpu] overall_mask agreement {agree:.5f}")


def main():
    device = torch.device("cuda", 0)
    phase_card()
    phase_build()
    kernel = phase_kernel(device)
    launches = phase_hero(device)
    phase_card_vs_cpu(device)
    loaded = [m for m in ("jax", "flax", "yaml", "PIL") if m in sys.modules]
    assert not loaded, f"the port pulled in {loaded}"

    hero = kernel["hero_b1_bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "fused_sweep_mlp", "route": "cuda",
        "source": "simplerecon_tpu_torch/csrc/fused_sweep.cu",
        "replaces": "simplerecon_tpu/ops/pallas_cv.py:513",
        "launches": launches, "max_abs_err": hero["max_abs_err"],
        "ms": hero["ms"], "plain_ms": hero["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
