"""Fused plane sweep: warp + 202-channel metadata + MLP (counterpart of
`simplerecon_tpu/ops/pallas_cv.py`).

`fused_sweep` replaces the TPU kernel `banded_warp_feature_volume` in
mode "mlp" (`simplerecon_tpu/ops/pallas_cv.py`, body `_banded_kernel`,
launched by `_banded_call`). For each (batch, plane, reference pixel) it
projects the pixel's ray at the plane depth into every source view,
samples the source features bilinearly (zeros outside the image),
assembles the MLP input in the channel order of
`simplerecon_tpu/models/cost_volume.py::_metadata_chunk`

    [sampled (k*c, view-major) | ref (c)] mask(k) depth(k) plane(1)
    dot(k) ray_angle(k) [ref ray (3) | src rays (3k)] penalty(k) R(k) t(k)

and runs the MLP C_in -> 128 -> 128 -> 1 with LeakyReLU(0.01). Operands
are rounded to the weight dtype before each product; sums are float32.
Output: (b, d, N) float32 scores.

The CUDA kernel is `csrc/fused_sweep.cu`; see the note there for what
bounds it on an H100 and how its layout answers that. `fused_sweep`
launches it for CUDA tensors and uses `fused_sweep_reference`, the plain
PyTorch version with the same rounding points, only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import geometry as geo

HIDDEN = 128
REFERENCE_PLANE_CHUNK = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mlp_in_channels(k: int, c: int) -> int:
    return c * (1 + k) + 10 * k + 4


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rounds float32 values to `dtype` and back (a no-op for float32)."""
    return x.to(dtype).float()


def fused_sweep_reference(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                          src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                          pose_meta_bk3, src_loc_bk3,
                          w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the fused sweep: the gather warp plus the
    metadata assembly of `_metadata_chunk`, in chunks of 8 planes.

    Rounds to the compute dtype (`w0.dtype`) where the kernel does:
    features are sampled in float32 from compute-dtype maps, the 202-
    channel input and each hidden activation are rounded before the next
    product, and every product and sum is float32. Returns (b, d, N).
    """
    cdt = w0.dtype
    f32 = torch.float32
    b, k, h, w, c = src_feats_bkhwc.shape
    n = h * w
    src = src_feats_bkhwc.to(cdt).float()
    cur = cur_bNc.to(cdt).float()
    pose_meta = pose_meta_bk3.to(f32)
    loc = src_loc_bk3.to(f32)
    w0f, w1f, w2f = (_round(x.float(), cdt) for x in (w0, w1, w2))
    b0f, b1f, b2f = (x.float() for x in (b0, b1, b2))

    chunks = []
    for s in range(0, depth_planes_bd.shape[1], REFERENCE_PLANE_CHUNK):
        planes = depth_planes_bd[:, s:s + REFERENCE_PLANE_CHUNK].to(f32)
        dc = planes.shape[1]
        warp = cv_ops.sweep_warp(src, src_extrinsics_bk44, src_Ks_bk44,
                                 cur_invK_b44, planes)
        sampled_bdNkc = warp.sampled_bkdNc.permute(0, 2, 3, 1, 4)
        mask_bkdN = warp.mask_bkdN
        dot_bkdN = torch.einsum("bkdnc,bnc->bkdn", warp.sampled_bkdNc,
                                cur) * mask_bkdN
        cur_rays = geo.normalize(warp.world_points_bdN3)
        src_rays = geo.normalize(warp.world_points_bdN3[:, None]
                                 - loc[:, :, None, None, :])
        angle_bkdN = geo.cosine_similarity(cur_rays[:, None], src_rays)
        feats = torch.cat([
            sampled_bdNkc.reshape(b, dc, n, k * c),
            cur[:, None].expand(b, dc, n, c),
            mask_bkdN.permute(0, 2, 3, 1),
            warp.depths_bkdN.permute(0, 2, 3, 1),
            planes[:, :, None, None].expand(b, dc, n, 1),
            dot_bkdN.permute(0, 2, 3, 1),
            angle_bkdN.permute(0, 2, 3, 1),
            cur_rays,
            src_rays.permute(0, 2, 3, 1, 4).reshape(b, dc, n, 3 * k),
            pose_meta.transpose(1, 2).reshape(b, 1, 1, 3 * k
                                              ).expand(b, dc, n, 3 * k),
        ], dim=-1)
        h0 = _round(F.leaky_relu(_round(feats, cdt) @ w0f + b0f, 0.01), cdt)
        h1 = _round(F.leaky_relu(h0 @ w1f + b1f, 0.01), cdt)
        chunks.append((h1 @ w2f + b2f)[..., 0])
    return torch.cat(chunks, dim=1)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_args(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
               cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
               w0, b0, w1, b1, w2, b2) -> tuple:
    """Raises on any argument the kernel does not take; returns
    (b, k, h, w, c, d)."""
    device = src_feats_bkhwc.device
    cdt = w0.dtype
    if cdt not in _DTYPE_CODES:
        raise TypeError(f"compute dtype {cdt} is not float32 or bfloat16")
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_bd.shape[1]
    n = h * w
    cin = mlp_in_channels(k, c)
    f32 = torch.float32
    _check("src_feats", src_feats_bkhwc, cdt, (b, k, h, w, c), device)
    _check("cur_feats", cur_bNc, cdt, (b, n, c), device)
    _check("src_extrinsics", src_extrinsics_bk44, f32, (b, k, 4, 4), device)
    _check("src_Ks", src_Ks_bk44, f32, (b, k, 4, 4), device)
    _check("cur_invK", cur_invK_b44, f32, (b, 4, 4), device)
    _check("depth_planes", depth_planes_bd, f32, (b, d), device)
    _check("pose_meta", pose_meta_bk3, f32, (b, k, 3), device)
    _check("src_loc", src_loc_bk3, f32, (b, k, 3), device)
    _check("w0", w0, cdt, (cin, HIDDEN), device)
    _check("b0", b0, f32, (HIDDEN,), device)
    _check("w1", w1, cdt, (HIDDEN, HIDDEN), device)
    _check("b1", b1, f32, (HIDDEN,), device)
    _check("w2", w2, cdt, (HIDDEN, 1), device)
    _check("b2", b2, f32, (1,), device)

    return b, k, h, w, c, d


def fused_sweep(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
                cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
                w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Fused warp + metadata + MLP plane sweep. Returns (b, d, N) float32.

    Arguments follow the JAX `banded_warp_feature_volume`: src features
    (b, k, h, w, c) and reference features (b, N, c) in the compute dtype
    (float32 or bfloat16, that of w0, w1 and w2); src_cam_T_cur_cam
    extrinsics, source intrinsics (b, k, 4, 4), reference inverse
    intrinsics (b, 4, 4), planes (b, d), pose metadata [penalty, R, t]
    and source camera centres (b, k, 3); MLP weights (in, out) and float32
    biases. All CUDA inputs must be contiguous.

    CPU tensors go to `fused_sweep_reference`; CUDA tensors launch the
    kernel, or raise.
    """
    device = src_feats_bkhwc.device
    if device.type == "cpu":
        return fused_sweep_reference(
            src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
            cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
            w0, b0, w1, b1, w2, b2)
    if device.type != "cuda":
        raise ValueError(f"fused_sweep runs on CPU or CUDA, not {device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (src_feats_bkhwc, cur_bNc, w0, b0, w1,
                                      b1, w2, b2)):
        raise NotImplementedError(
            "the fused sweep kernel has no backward yet: its backward is "
            "K2 (ROADMAP Queue 2, item 2); run it under torch.no_grad()")

    b, k, h, w, c, d = check_args(
        src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
        cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
        w0, b0, w1, b1, w2, b2)
    cdt = w0.dtype
    n = h * w
    f32 = torch.float32

    from simplerecon_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(device):
        proj = torch.matmul(src_Ks_bk44, src_extrinsics_bk44).contiguous()
        out = torch.empty((b, d, n), dtype=f32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in (
            src_feats_bkhwc, cur_bNc, proj, cur_invK_b44, depth_planes_bd,
            pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2, out)]
        rc = lib.fused_sweep_mlp(_DTYPE_CODES[cdt], *ptrs,
                                 b, k, h, w, c, d, stream)
    if rc != 0:
        raise RuntimeError("fused_sweep_mlp launch failed: "
                           + lib.fused_sweep_error_string(rc).decode())
    fused_sweep.launches += 1
    return out


fused_sweep.launches = 0
