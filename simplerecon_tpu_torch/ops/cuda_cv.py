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

`fused_sweep_bwd` is its backward (K2, `csrc/fused_sweep_bwd.cu`), which
replaces `banded_warp_feature_volume_bwd` (body `_banded_bwd_kernel`,
launched by `_banded_bwd_call`); its plain version is
`fused_sweep_backward_reference`. `FusedSweep` joins the two as a
`torch.autograd.Function`. On the card K2 writes each sample's gradient,
and `sweep_scatter` (`csrc/sweep_scatter.cu`) sums them into d_src as
64-bit fixed-point integers, whose sum does not depend on the order of
the additions: d_src has the same bits on every run, as the JAX kernel's
sequential grid gives. Its plain version is `sweep_scatter_reference`.

`dot_sweep` is the dot-product model's cost volume (K1-dot, the
`fused_sweep_dot` entry of `csrc/fused_sweep.cu`), which replaces
`banded_warp_dot_volume` (the same `_banded_kernel` in mode "dot"); its
plain version is `dot_sweep_reference`. `DotSweep` makes it
differentiable with `dot_sweep_backward`: d_cur by K1-dot's d_cur mode
(`dot_sweep_dcur`, the `fused_sweep_dot_cur_grad` entry; plain version
`dot_sweep_dcur_reference`) and d_src by `sweep_scatter`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.ops import _build
from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import geometry as geo

HIDDEN = 128
REFERENCE_PLANE_CHUNK = 8
BWD_TILE = 32     # reference pixels per tile of the backward kernel
DOT_CHANNELS = 16  # the feature width K1-dot takes (its vector tap loads)


def mlp_in_channels(k: int, c: int) -> int:
    return c * (1 + k) + 10 * k + 4


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rounds float32 values to `dtype` and back (a no-op for float32)."""
    return x.to(dtype).float()


def _chunks(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
            cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3, cdt):
    """Yields, for each chunk of 8 planes, (plane slice, MLP inputs
    (b, dc, N, C_in) float32, unrounded, and the chunk's `SweepWarp`),
    with the channel order of `_metadata_chunk`. Features are sampled in
    float32 from compute-dtype maps."""
    f32 = torch.float32
    b, k, h, w, c = src_feats_bkhwc.shape
    n = h * w
    src = src_feats_bkhwc.to(cdt).float()
    cur = cur_bNc.to(cdt).float()
    pose_meta = pose_meta_bk3.to(f32)
    loc = src_loc_bk3.to(f32)
    for s in range(0, depth_planes_bd.shape[1], REFERENCE_PLANE_CHUNK):
        sl = slice(s, s + REFERENCE_PLANE_CHUNK)
        planes = depth_planes_bd[:, sl].to(f32)
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
        yield sl, feats, warp


def _leaky_slope(pre: torch.Tensor) -> torch.Tensor:
    return torch.where(pre > 0, 1.0, 0.01)


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
    chunks = []
    for _, feats, _ in _chunks(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                               src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                               pose_meta_bk3, src_loc_bk3, w0.dtype):
        chunks.append(mlp_reference(feats, w0, b0, w1, b1, w2, b2))
    return torch.cat(chunks, dim=1)


def mlp_reference(feats, w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """The MLP C_in -> 128 -> 128 -> 1 with LeakyReLU(0.01) over float32
    inputs (..., C_in), as the kernels run it: the input and each hidden
    activation are rounded to the compute dtype (`w0.dtype`) before the
    next product; products and sums are float32. Returns (...)."""
    cdt = w0.dtype
    w0f, w1f, w2f = (_round(x.float(), cdt) for x in (w0, w1, w2))
    h0 = _round(F.leaky_relu(_round(feats, cdt) @ w0f + b0.float(), 0.01),
                cdt)
    h1 = _round(F.leaky_relu(h0 @ w1f + b1.float(), 0.01), cdt)
    return (h1 @ w2f + b2.float())[..., 0]


def fused_sweep_backward_reference(src_feats_bkhwc, cur_bNc,
                                   src_extrinsics_bk44, src_Ks_bk44,
                                   cur_invK_b44, depth_planes_bd,
                                   pose_meta_bk3, src_loc_bk3,
                                   w0, b0, w1, b1, w2, b2, g_bdN) -> tuple:
    """Plain PyTorch backward of the fused sweep, given the cotangent g
    (b, d, N) of its output.

    Recomputes the forward chunk by chunk, then runs the MLP transposes,
    the dot-product split and the bilinear-warp transpose (a scatter of
    the four taps). Gradients go to the features and the MLP weights
    only; geometry is data. Rounding points in the compute dtype are the
    kernel's: the MLP input and hidden activations as in the forward,
    and d_h1p, d_h0p and each view's sample gradient d_s before the
    product that consumes them; sums are float32.

    Returns float32 (d_src (b,k,h,w,c), d_cur (b,N,c), d_w0, d_b0, d_w1,
    d_b1, d_w2, d_b2), each weight gradient shaped like its weight.
    """
    cdt = w0.dtype
    f32 = torch.float32
    b, k, h, w, c = src_feats_bkhwc.shape
    n = h * w
    w0f, w1f, w2f = (_round(x.float(), cdt) for x in (w0, w1, w2))
    b0f, b1f = b0.float(), b1.float()
    cur = cur_bNc.to(cdt).float()
    g_bdN = g_bdN.to(f32)

    d_src = torch.zeros((b * k * n, c), dtype=f32, device=cur.device)
    d_cur = torch.zeros((b, n, c), dtype=f32, device=cur.device)
    d_w0, d_w1 = torch.zeros_like(w0f), torch.zeros_like(w1f)
    d_b0, d_b1 = torch.zeros_like(b0f), torch.zeros_like(b1f)
    d_w2 = torch.zeros_like(w2f)
    d_b2 = g_bdN.sum().reshape(1)
    o_dot = k * c + c + 2 * k + 1   # first dot row of the MLP input

    for sl, feats, warp in _chunks(src_feats_bkhwc, cur_bNc,
                                   src_extrinsics_bk44, src_Ks_bk44,
                                   cur_invK_b44, depth_planes_bd,
                                   pose_meta_bk3, src_loc_bk3, cdt):
        g = g_bdN[:, sl, :, None]                          # (b, dc, N, 1)
        dc = g.shape[1]
        # forward recompute
        x = _round(feats, cdt)
        h0pre = x @ w0f + b0f
        h0 = _round(F.leaky_relu(h0pre, 0.01), cdt)
        h1pre = h0 @ w1f + b1f
        h1 = _round(F.leaky_relu(h1pre, 0.01), cdt)
        # MLP transposes
        d_w2 += torch.einsum("bdni,bdno->io", h1, g)
        d_h1p = (g * w2f[:, 0]) * _leaky_slope(h1pre)
        d_b1 += d_h1p.sum(dim=(0, 1, 2))
        r1 = _round(d_h1p, cdt)
        d_w1 += torch.einsum("bdni,bdno->io", h0, r1)
        d_h0p = (r1 @ w1f.t()) * _leaky_slope(h0pre)
        d_b0 += d_h0p.sum(dim=(0, 1, 2))
        r0 = _round(d_h0p, cdt)
        d_w0 += torch.einsum("bdni,bdno->io", x, r0)
        d_x = r0 @ w0f.t()                                 # (b, dc, N, C_in)
        # the dot split: only feature channels carry gradient
        mask = warp.mask_bkdN.permute(0, 2, 3, 1)          # (b, dc, N, k)
        d_dot = d_x[..., o_dot:o_dot + k] * mask
        sampled = warp.sampled_bkdNc.permute(0, 2, 3, 1, 4)  # (b,dc,N,k,c)
        d_s = (d_x[..., :k * c].reshape(b, dc, n, k, c)
               + d_dot[..., None] * cur[:, None, :, None, :])
        d_cur += d_x[..., k * c:k * c + c].sum(dim=1)
        d_cur += torch.einsum("bdnk,bdnkc->bnc", d_dot, sampled)
        # warp transpose: scatter each tap of each sample
        _scatter_taps_(d_src, _round(d_s, cdt).permute(0, 3, 1, 2, 4),
                       warp.pix_bkdN2, h, w)
    d_src = d_src.reshape(b, k, h, w, c)
    return d_src, d_cur, d_w0, d_b0, d_w1, d_b1, d_w2, d_b2


def _taps(pix_bkdN2, h: int, w: int):
    """Yields the four bilinear taps of (b, k, dc, N) pixel coords (u, v)
    at index coords (u - 0.5, v - 0.5), as the kernels sample: each tap's
    row in (b*k*h*w) rows (0 outside the image) and its weight (0
    outside)."""
    b, k = pix_bkdN2.shape[:2]
    ix = pix_bkdN2[..., 0] - 0.5
    iy = pix_bkdN2[..., 1] - 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    base = (torch.arange(b * k, device=ix.device) * (h * w)
            ).reshape(b, k, 1, 1)
    for xt, yt, wgt in ((x0, y0, (x0 + 1 - ix) * (y0 + 1 - iy)),
                        (x0 + 1, y0, (ix - x0) * (y0 + 1 - iy)),
                        (x0, y0 + 1, (x0 + 1 - ix) * (iy - y0)),
                        (x0 + 1, y0 + 1, (ix - x0) * (iy - y0))):
        valid = (xt >= 0) & (xt <= w - 1) & (yt >= 0) & (yt <= h - 1)
        yield (base + torch.where(valid, yt * w + xt, 0.0).long(),
               torch.where(valid, wgt, 0.0))


def _scatter_taps_(d_src_rows, d_s_bkdNc, pix_bkdN2, h: int, w: int):
    """Adds the bilinear transpose of (b, k, dc, N, c) sample gradients
    at pixel coords (u, v) into (b*k*h*w, c) float32 rows: each of the
    four taps inside the image gets its weight times the gradient
    (`index_add_`, which sums with atomics in no fixed order on a
    card)."""
    c = d_s_bkdNc.shape[-1]
    for idx, wgt in _taps(pix_bkdN2, h, w):
        vals = d_s_bkdNc * wgt[..., None]
        d_src_rows.index_add_(0, idx.reshape(-1), vals.reshape(-1, c))


def fixed_point_shift(max_abs: float, count: int) -> int:
    """S of the fixed-point sums of `sweep_scatter`: with max_abs < 2^e
    and count <= 2^L, 62 - L - e, so that count contributions of at most
    max_abs each, scaled by 2^S, sum within 2^62; clamped to [-100, 100]
    (2^S and 2^-S stay normal float32); 0 for a max_abs of 0 or not
    finite."""
    if not max_abs > 0 or not math.isfinite(max_abs):
        return 0
    e = math.frexp(max_abs)[1]
    return min(max(62 - (count - 1).bit_length() - e, -100), 100)


def _scatter_taps_fixed_(acc_rows, d_s_bkdNc, pix_bkdN2, h: int, w: int,
                         shift: int):
    """`_scatter_taps_` into (b*k*h*w, c) int64 rows: each contribution
    (weight times gradient, a float32 product) is scaled by 2^shift and
    rounded to the nearest integer (ties to even) before the sum, so the
    sums do not depend on the order of the contributions."""
    c = d_s_bkdNc.shape[-1]
    scale = 2.0 ** shift
    for idx, wgt in _taps(pix_bkdN2, h, w):
        vals = torch.round(d_s_bkdNc * wgt[..., None] * scale).long()
        acc_rows.index_add_(0, idx.reshape(-1), vals.reshape(-1, c))


def _fixed_to_float(acc_rows, max_abs: float, shift: int) -> torch.Tensor:
    """The float32 values acc * 2^-shift of int64 fixed-point sums; NaN
    everywhere for a max_abs that is not finite."""
    if not math.isfinite(max_abs):
        return torch.full(acc_rows.shape, math.nan, dtype=torch.float32,
                          device=acc_rows.device)
    return acc_rows.float() * 2.0 ** -shift


def _project(proj_bk44, cur_invK_b44, planes_bdc, h: int, w: int) -> tuple:
    """The reference pixels' rays at planes (b, dc) projected with
    proj = K @ src_T_cur (b, k, 4, 4), with `project_points`' eps-safe
    divide: pixel coords (b, k, dc, N, 2) and the mask z + eps > 0
    (b, k, dc, N) float32."""
    P = proj_bk44.float()[:, :, None]                        # (b,k,1,4,4)
    rays = cv_ops.pixel_rays(cur_invK_b44, h, w)             # (b, N, 3)
    world = rays[:, None] * planes_bdc[..., None, None]      # (b,dc,N,3)
    cam = (torch.matmul(world[:, None], P[..., :3, :3].transpose(-1, -2))
           + P[..., None, :3, 3])
    z_eps = cam[..., 2:3] + 1e-8
    scale = torch.where(cam[..., 2:3].abs() > 1e-8, 1.0 / z_eps, 1.0)
    return cam[..., :2] * scale, (z_eps[..., 0] > 0).float()


def sweep_scatter_reference(proj_bk44, cur_invK_b44, depth_planes_bd,
                            max_abs, h: int, w: int, d_s_bkdNc=None,
                            g_bdN=None, cur_bNc=None) -> torch.Tensor:
    """Plain PyTorch version of `sweep_scatter`: the same fixed-point
    integers, summed with `index_add_` on int64 in chunks of 8 planes.
    Integer sums do not depend on the order of the contributions, so the
    chunking, and the order inside `index_add_`, leave the bits as they
    are. Returns d_src (b, k, h, w, c) float32."""
    b, d = depth_planes_bd.shape
    k = proj_bk44.shape[1]
    n = h * w
    samples = d_s_bkdNc is not None
    c = (d_s_bkdNc if samples else cur_bNc).shape[-1]
    device = depth_planes_bd.device
    max_abs = float(max_abs)
    shift = fixed_point_shift(max_abs, 4 * d * n)
    acc = torch.zeros((b * k * n, c), dtype=torch.int64, device=device)
    for s in range(0, d, REFERENCE_PLANE_CHUNK):
        sl = slice(s, s + REFERENCE_PLANE_CHUNK)
        pix, mask = _project(proj_bk44, cur_invK_b44,
                             depth_planes_bd[:, sl].float(), h, w)
        if samples:
            d_s = d_s_bkdNc[:, :, sl].float()
        else:
            m = mask * g_bdN[:, None, sl].float()
            d_s = m[..., None] * cur_bNc.float()[:, None, None]
        _scatter_taps_fixed_(acc, d_s, pix, h, w, shift)
    return _fixed_to_float(acc, max_abs, shift).reshape(b, k, h, w, c)


def sweep_scatter(proj_bk44, cur_invK_b44, depth_planes_bd, max_abs,
                  h: int, w: int, d_s_bkdNc=None, g_bdN=None,
                  cur_bNc=None) -> torch.Tensor:
    """The transpose of the sweeps' bilinear warp, summed in an order-free
    fixed-point form. Returns d_src (b, k, h, w, c) float32.

    Each sample gradient of a (pixel, plane, view), times each of its
    four tap weights (a float32 product), is scaled by 2^S, rounded to a
    64-bit integer and added into d_src's element at that tap; the sums
    are then converted to float32 times 2^-S. S =
    `fixed_point_shift(max_abs, 4 * d * N)`: max_abs (a float32 tensor
    of one element, or a float) bounds |d_s|, and no more than 4 * d * N
    contributions reach one element, so no sum overflows. The gradients
    are d_s_bkdNc (b, k, d, N, c) (K2's), or d_s = mask * g * cur from
    g_bdN (b, d, N) float32 and cur_bNc (b, N, c) (the dot model's), with
    mask = projected z + eps > 0. Geometry: proj = K @ src_T_cur
    (b, k, 4, 4), the reference inverse intrinsics (b, 4, 4) and the
    planes (b, d), float32. d_s and cur are float32 or bfloat16, all
    inputs contiguous on the card.

    CPU tensors go to `sweep_scatter_reference`; CUDA tensors launch the
    kernel (`csrc/sweep_scatter.cu`), or raise. The bits do not depend on
    the order of the sums: two calls give the same d_src. After a launch,
    `sweep_scatter.paths` holds its int64 counts (on the card) of the
    (block, plane) pairs whose sums went through a block's shared-memory
    window and of those added straight to device memory.
    """
    samples = d_s_bkdNc is not None
    if samples == (g_bdN is not None or cur_bNc is not None):
        raise ValueError("sweep_scatter takes d_s_bkdNc, or g_bdN and "
                         "cur_bNc")
    vals = d_s_bkdNc if samples else cur_bNc
    device = _build.kernel_device(vals, "sweep_scatter")
    if device is None:
        return sweep_scatter_reference(
            proj_bk44, cur_invK_b44, depth_planes_bd, max_abs, h, w,
            d_s_bkdNc=d_s_bkdNc, g_bdN=g_bdN, cur_bNc=cur_bNc)
    cdt = vals.dtype
    if cdt not in _build.DTYPE_CODES:
        raise TypeError(f"sweep_scatter takes float32 or bfloat16, not {cdt}")
    b, d = depth_planes_bd.shape
    k = proj_bk44.shape[1]
    n, c = h * w, vals.shape[-1]
    f32 = torch.float32
    check = _build.check
    if samples:
        check("d_s", d_s_bkdNc, cdt, (b, k, d, n, c), device)
    else:
        check("g", g_bdN, f32, (b, d, n), device)
        check("cur_feats", cur_bNc, cdt, (b, n, c), device)
    check("proj", proj_bk44, f32, (b, k, 4, 4), device)
    check("cur_invK", cur_invK_b44, f32, (b, 4, 4), device)
    check("depth_planes", depth_planes_bd, f32, (b, d), device)
    check("max_abs", max_abs, f32, (1,), device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        acc = torch.zeros((b, k, h, w, c), dtype=torch.int64, device=device)
        d_src = torch.empty((b, k, h, w, c), dtype=f32, device=device)
        paths = torch.zeros((2,), dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [0 if t is None else t.data_ptr() for t in (
            d_s_bkdNc, g_bdN, cur_bNc, proj_bk44, cur_invK_b44,
            depth_planes_bd, max_abs, acc, d_src, paths)]
        rc = lib.sweep_scatter(_build.DTYPE_CODES[cdt], int(not samples),
                               *ptrs, b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "sweep_scatter", rc)
    tracing.count("launch.sweep_scatter")
    sweep_scatter.paths = paths
    return d_src


sweep_scatter.paths = None


def check_dot_args(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                   src_Ks_bk44, cur_invK_b44, depth_planes_bd) -> tuple:
    """Raises on any feature or geometry argument the kernels do not take
    (cur_bNc None: not checked); returns (b, k, h, w, c, d). The compute
    dtype is the features'."""
    device = src_feats_bkhwc.device
    cdt = src_feats_bkhwc.dtype
    if cdt not in _build.DTYPE_CODES:
        raise TypeError(f"compute dtype {cdt} is not float32 or bfloat16")
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_bd.shape[1]
    f32 = torch.float32
    check = _build.check
    check("src_feats", src_feats_bkhwc, cdt, (b, k, h, w, c), device)
    if cur_bNc is not None:
        check("cur_feats", cur_bNc, cdt, (b, h * w, c), device)
    check("src_extrinsics", src_extrinsics_bk44, f32, (b, k, 4, 4), device)
    check("src_Ks", src_Ks_bk44, f32, (b, k, 4, 4), device)
    check("cur_invK", cur_invK_b44, f32, (b, 4, 4), device)
    check("depth_planes", depth_planes_bd, f32, (b, d), device)
    return b, k, h, w, c, d


def check_args(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
               cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
               w0, b0, w1, b1, w2, b2) -> tuple:
    """Raises on any argument the kernel does not take; returns
    (b, k, h, w, c, d)."""
    b, k, h, w, c, d = check_dot_args(
        src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
        cur_invK_b44, depth_planes_bd)
    check_meta_args(pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    b, k, c, src_feats_bkhwc.dtype, src_feats_bkhwc.device)
    return b, k, h, w, c, d


def check_meta_args(pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    b: int, k: int, c: int, cdt, device):
    """Raises on any pose or MLP argument that K1, K4 and K5 do not take:
    float32 pose metadata and camera centres, weights (in, out) in the
    compute dtype `cdt`, float32 biases, all contiguous on `device`."""
    cin = mlp_in_channels(k, c)
    f32 = torch.float32
    check = _build.check
    check("pose_meta", pose_meta_bk3, f32, (b, k, 3), device)
    check("src_loc", src_loc_bk3, f32, (b, k, 3), device)
    check("w0", w0, cdt, (cin, HIDDEN), device)
    check("b0", b0, f32, (HIDDEN,), device)
    check("w1", w1, cdt, (HIDDEN, HIDDEN), device)
    check("b1", b1, f32, (HIDDEN,), device)
    check("w2", w2, cdt, (HIDDEN, 1), device)
    check("b2", b2, f32, (1,), device)


def fused_sweep(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
                cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
                w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Fused warp + metadata + MLP plane sweep (K1). Returns (b, d, N)
    float32.

    Arguments follow the JAX `banded_warp_feature_volume`: src features
    (b, k, h, w, c) and reference features (b, N, c) in the compute dtype
    (float32 or bfloat16, that of w0, w1 and w2); src_cam_T_cur_cam
    extrinsics, source intrinsics (b, k, 4, 4), reference inverse
    intrinsics (b, 4, 4), planes (b, d), pose metadata [penalty, R, t]
    and source camera centres (b, k, 3); MLP weights (in, out) and float32
    biases. All CUDA inputs must be contiguous. No autograd: `FusedSweep`
    is the differentiable form.

    CPU tensors go to `fused_sweep_reference`; CUDA tensors launch the
    kernel, or raise.
    """
    args = (src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
            cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
            w0, b0, w1, b1, w2, b2)
    device = _build.kernel_device(src_feats_bkhwc, "fused_sweep")
    if device is None:
        return fused_sweep_reference(*args)
    b, k, h, w, c, d = check_args(*args)
    lib = _build.load_library()
    with torch.cuda.device(device):
        proj = torch.matmul(src_Ks_bk44, src_extrinsics_bk44).contiguous()
        out = torch.empty((b, d, h * w), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in (
            src_feats_bkhwc, cur_bNc, proj, cur_invK_b44, depth_planes_bd,
            pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2, out)]
        rc = lib.fused_sweep_mlp(_build.DTYPE_CODES[w0.dtype], *ptrs,
                                 b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "fused_sweep_mlp", rc)
    tracing.count("launch.fused_sweep")
    return out


def fused_sweep_bwd(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                    src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                    pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    g_bdN) -> tuple:
    """Backward of the fused sweep (K2), given the float32 cotangent g
    (b, d, N) of its output; the other arguments are `fused_sweep`'s.

    Returns float32 (d_src, d_cur, d_w0, d_b0, d_w1, d_b1, d_w2, d_b2),
    as `fused_sweep_backward_reference` does. CPU tensors go to that plain
    version; CUDA tensors launch the kernel, then `sweep_scatter` on the
    sample gradients it writes (b, k, d, N, c), or raise. Every gradient
    is summed in a fixed order or in an order-free form: two calls give
    the same bits.
    """
    args = (src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
            cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
            w0, b0, w1, b1, w2, b2)
    device = _build.kernel_device(src_feats_bkhwc, "fused_sweep_bwd")
    if device is None:
        return fused_sweep_backward_reference(*args, g_bdN)
    b, k, h, w, c, d = check_args(*args)
    _build.check("g", g_bdN, torch.float32, (b, d, h * w), device)
    cin = mlp_in_channels(k, c)
    n_params = cin * HIDDEN + HIDDEN * HIDDEN + 3 * HIDDEN + 1
    tiles = b * -(-h * w // BWD_TILE)
    lib = _build.load_library()
    f32 = torch.float32
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = min(tiles, sms)
        proj = torch.matmul(src_Ks_bk44, src_extrinsics_bk44).contiguous()
        # the float32 kernel reads W0^T and W1^T; the bf16 one transposes
        # in its ldmatrix loads
        fp32 = w0.dtype == torch.float32
        w0t = w0.t().contiguous() if fp32 else None
        w1t = w1.t().contiguous() if fp32 else None
        d_s = torch.empty((b, k, d, h * w, c), dtype=w0.dtype, device=device)
        d_s_max = torch.zeros((1,), dtype=torch.int32, device=device)
        d_cur = torch.empty((b, h * w, c), dtype=f32, device=device)
        partials = torch.empty((blocks, n_params), dtype=f32, device=device)
        d_params = torch.empty((n_params,), dtype=f32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [0 if t is None else t.data_ptr() for t in (
            src_feats_bkhwc, cur_bNc, proj, cur_invK_b44, depth_planes_bd,
            pose_meta_bk3, src_loc_bk3, w0, w0t, b0, w1, w1t, b1, w2, g_bdN,
            d_s, d_s_max, d_cur, partials, d_params)]
        rc = lib.fused_sweep_mlp_bwd(_build.DTYPE_CODES[w0.dtype], *ptrs,
                                     blocks, b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "fused_sweep_mlp_bwd", rc)
    tracing.count("launch.fused_sweep_bwd")
    # the bits of the largest |d_s| are a non-negative float32's
    d_src = sweep_scatter(proj, cur_invK_b44, depth_planes_bd,
                          d_s_max.view(f32), h, w, d_s_bkdNc=d_s)
    sizes = (cin * HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN, HIDDEN, 1)
    d_w0, d_w1, d_b0, d_b1, d_w2, d_b2 = torch.split(d_params, sizes)
    return (d_src, d_cur, d_w0.reshape(cin, HIDDEN), d_b0,
            d_w1.reshape(HIDDEN, HIDDEN), d_b1, d_w2.reshape(HIDDEN, 1), d_b2)


class FusedSweep(torch.autograd.Function):
    """The differentiable fused sweep: forward `fused_sweep` (K1),
    backward `fused_sweep_bwd` (K2); on the CPU their plain versions.

    Takes `fused_sweep`'s arguments, except that the MLP weights may be
    float32 master weights: they are cast to the compute dtype (that of
    the features) inside, and their gradients come back in float32. Only
    the primal inputs are saved. Geometry gets no gradient, as in the
    JAX package's custom VJP.
    """

    @staticmethod
    def forward(ctx, src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                src_Ks_bk44, cur_invK_b44, depth_planes_bd, pose_meta_bk3,
                src_loc_bk3, w0, b0, w1, b1, w2, b2):
        args = (src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
                cur_invK_b44, depth_planes_bd, pose_meta_bk3, src_loc_bk3,
                w0, b0, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        return fused_sweep(*FusedSweep._compute_args(args))

    @staticmethod
    def backward(ctx, g_bdN):
        args = ctx.saved_tensors
        grads = fused_sweep_bwd(*FusedSweep._compute_args(args),
                                g_bdN.float().contiguous())
        d_src, d_cur, d_w0, d_b0, d_w1, d_b1, d_w2, d_b2 = grads
        src, cur, w0, b0, w1, b1, w2, b2 = (args[0], args[1]) + args[8:]
        return (d_src.to(src.dtype), d_cur.to(cur.dtype),
                None, None, None, None, None, None,
                d_w0.to(w0.dtype), d_b0.to(b0.dtype), d_w1.to(w1.dtype),
                d_b1.to(b1.dtype), d_w2.to(w2.dtype), d_b2.to(b2.dtype))

    @staticmethod
    def _compute_args(args) -> tuple:
        cdt = args[0].dtype
        w0, b0, w1, b1, w2, b2 = args[8:]
        return args[:8] + (w0.to(cdt).contiguous(), b0,
                           w1.to(cdt).contiguous(), b1,
                           w2.to(cdt).contiguous(), b2)


# --------------------------------------------------------------------------
# the dot-product sweep (K1-dot)
# --------------------------------------------------------------------------

def dot_sweep_reference(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                        src_Ks_bk44, cur_invK_b44, depth_planes_bd
                        ) -> torch.Tensor:
    """Plain PyTorch version of the dot-product sweep: the gather warp in
    chunks of 8 planes, then the masked dot of each sample with the
    reference features, summed over views. Features are sampled in
    float32 from maps in the compute dtype; the dot is float32. Returns
    (b, d, N) float32."""
    cur = cur_bNc.float()
    src = src_feats_bkhwc.float()
    chunks = []
    for s in range(0, depth_planes_bd.shape[1], REFERENCE_PLANE_CHUNK):
        warp = cv_ops.sweep_warp(
            src, src_extrinsics_bk44, src_Ks_bk44, cur_invK_b44,
            depth_planes_bd[:, s:s + REFERENCE_PLANE_CHUNK].float())
        dot_bkdN = torch.einsum("bkdnc,bnc->bkdn", warp.sampled_bkdNc, cur)
        chunks.append((dot_bkdN * warp.mask_bkdN).sum(dim=1))
    return torch.cat(chunks, dim=1)


def dot_sweep_dcur_reference(src_feats_bkhwc, src_extrinsics_bk44,
                             src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                             g_bdN) -> torch.Tensor:
    """Plain PyTorch version of `dot_sweep_dcur`: the gather warp in
    chunks of 8 planes, and d_cur += the sum over views and planes of
    mask * g * sample, in float32 from features in the compute dtype.
    Returns (b, N, c) float32."""
    b, k, h, w, c = src_feats_bkhwc.shape
    src = src_feats_bkhwc.float()
    g_bdN = g_bdN.float()
    d_cur = torch.zeros((b, h * w, c), dtype=torch.float32,
                        device=src.device)
    for s in range(0, depth_planes_bd.shape[1], REFERENCE_PLANE_CHUNK):
        sl = slice(s, s + REFERENCE_PLANE_CHUNK)
        warp = cv_ops.sweep_warp(src, src_extrinsics_bk44, src_Ks_bk44,
                                 cur_invK_b44,
                                 depth_planes_bd[:, sl].float())
        m_bkdN = warp.mask_bkdN * g_bdN[:, None, sl]
        d_cur += torch.einsum("bkdn,bkdnc->bnc", m_bkdN, warp.sampled_bkdNc)
    return d_cur


def dot_sweep_dcur(src_feats_bkhwc, src_extrinsics_bk44, src_Ks_bk44,
                   cur_invK_b44, depth_planes_bd, g_bdN) -> torch.Tensor:
    """The dot-product sweep's gradient for the reference features (K1-dot
    in its d_cur mode): d_cur[b, pix] = the sum over planes and views of
    mask * g[b, plane, pix] * the bilinear sample of the source features,
    float32 (b, N, c), from the cotangent g (b, d, N) of `dot_sweep`'s
    output. The other arguments are `dot_sweep`'s (without cur).

    Each pixel's sum runs in a fixed order on the card, so two calls give
    the same bits. CPU tensors go to `dot_sweep_dcur_reference`; CUDA
    tensors launch the kernel (`fused_sweep_dot_cur_grad` of
    `csrc/fused_sweep.cu`), or raise.
    """
    device = _build.kernel_device(src_feats_bkhwc, "dot_sweep_dcur")
    if device is None:
        return dot_sweep_dcur_reference(src_feats_bkhwc, src_extrinsics_bk44,
                                        src_Ks_bk44, cur_invK_b44,
                                        depth_planes_bd, g_bdN)
    b, k, h, w, c, d = check_dot_args(src_feats_bkhwc, None,
                                      src_extrinsics_bk44, src_Ks_bk44,
                                      cur_invK_b44, depth_planes_bd)
    check_dot_layout(src_feats_bkhwc, c)
    _build.check("g", g_bdN, torch.float32, (b, d, h * w), device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        proj = torch.matmul(src_Ks_bk44, src_extrinsics_bk44).contiguous()
        d_cur = torch.empty((b, h * w, c), dtype=torch.float32,
                            device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in (src_feats_bkhwc, g_bdN, proj,
                                       cur_invK_b44, depth_planes_bd, d_cur)]
        rc = lib.fused_sweep_dot_cur_grad(
            _build.DTYPE_CODES[src_feats_bkhwc.dtype], *ptrs, b, k, h, w, c,
            d, stream)
    _build.raise_on_error(lib, "fused_sweep_dot_cur_grad", rc)
    tracing.count("launch.dot_sweep_dcur")
    return d_cur


def dot_sweep_backward(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                       src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                       g_bdN) -> tuple:
    """Backward of the dot-product sweep, given the cotangent g (b, d, N)
    of its output: with m = mask * g per (view, plane, pixel),
        d_cur = sum over views and planes of m * sample (`dot_sweep_dcur`),
        d_src = the bilinear transpose of m * cur (`sweep_scatter`, which
                forms m * cur itself and sums in an order-free fixed-point
                form).
    Geometry gets none. Returns float32 (d_src (b,k,h,w,c), d_cur
    (b,N,c)). On the card both are kernels whose sums do not depend on
    the order of the blocks: two calls give the same bits. On the CPU
    their plain versions run. The JAX package has no backward kernel for
    the dot mode (it trains the dot model through autodiff of its XLA
    warp). The work is the span "sr.dot_sweep_backward".
    """
    b, k, h, w, c = src_feats_bkhwc.shape
    with tracing.span("sr.dot_sweep_backward"):
        g_bdN = g_bdN.float().contiguous()
        planes = depth_planes_bd.float().contiguous()
        invK = cur_invK_b44.float().contiguous()
        d_cur = dot_sweep_dcur(src_feats_bkhwc, src_extrinsics_bk44,
                               src_Ks_bk44, invK, planes, g_bdN)
        # m * cur is bounded by max |g| * max |cur|
        bound = (g_bdN.abs().amax() * cur_bNc.float().abs().amax()
                 ).reshape(1)
        proj = torch.matmul(src_Ks_bk44.float(),
                            src_extrinsics_bk44.float()).contiguous()
        d_src = sweep_scatter(proj, invK, planes, bound, h, w, g_bdN=g_bdN,
                              cur_bNc=cur_bNc.contiguous())
    return d_src, d_cur


def check_dot_layout(src_feats_bkhwc, c: int, cur_bNc=None):
    """Raises unless the features have the 16 channels K1-dot's vector
    loads take and start on 16-byte boundaries."""
    if c != DOT_CHANNELS:
        raise ValueError(f"K1-dot takes {DOT_CHANNELS} feature channels, "
                         f"got {c}")
    for name, t in (("src_feats", src_feats_bkhwc), ("cur_feats", cur_bNc)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "K1-dot's vector loads")


def dot_sweep(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
              cur_invK_b44, depth_planes_bd) -> torch.Tensor:
    """The dot-product sweep (K1-dot): for each (batch, plane, reference
    pixel), the sum over source views of mask * <bilinear sample, cur>,
    mask = projected z + eps > 0. Returns (b, d, N) float32.

    Arguments are `fused_sweep`'s first six (features in float32 or
    bfloat16, geometry in float32, all contiguous); on the card the
    features have 16 channels and start on 16-byte boundaries. No autograd:
    `DotSweep` is the differentiable form. CPU tensors go to
    `dot_sweep_reference`; CUDA tensors launch the kernel, or raise.
    """
    args = (src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
            cur_invK_b44, depth_planes_bd)
    device = _build.kernel_device(src_feats_bkhwc, "dot_sweep")
    if device is None:
        return dot_sweep_reference(*args)
    b, k, h, w, c, d = check_dot_args(*args)
    check_dot_layout(src_feats_bkhwc, c, cur_bNc)
    lib = _build.load_library()
    with torch.cuda.device(device):
        proj = torch.matmul(src_Ks_bk44, src_extrinsics_bk44).contiguous()
        out = torch.empty((b, d, h * w), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in (src_feats_bkhwc, cur_bNc, proj,
                                       cur_invK_b44, depth_planes_bd, out)]
        rc = lib.fused_sweep_dot(_build.DTYPE_CODES[src_feats_bkhwc.dtype],
                                 *ptrs, b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "fused_sweep_dot", rc)
    tracing.count("launch.dot_sweep")
    return out


class DotSweep(torch.autograd.Function):
    """The differentiable dot-product sweep: forward `dot_sweep` (K1-dot
    on the card, its plain version on the CPU), backward
    `dot_sweep_backward` (K1-dot's d_cur mode and the scatter on the
    card). Gradients go to the source and reference features, in their
    dtype; geometry gets none."""

    @staticmethod
    def forward(ctx, src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                src_Ks_bk44, cur_invK_b44, depth_planes_bd):
        args = (src_feats_bkhwc, cur_bNc, src_extrinsics_bk44, src_Ks_bk44,
                cur_invK_b44, depth_planes_bd)
        ctx.save_for_backward(*args)
        return dot_sweep(*args)

    @staticmethod
    def backward(ctx, g_bdN):
        args = ctx.saved_tensors
        d_src, d_cur = dot_sweep_backward(*args, g_bdN)
        return (d_src.to(args[0].dtype), d_cur.to(args[1].dtype),
                None, None, None, None)
