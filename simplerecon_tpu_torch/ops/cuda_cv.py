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
`torch.autograd.Function`.

`dot_sweep` is the dot-product model's cost volume (K1-dot, the
`fused_sweep_dot` entry of `csrc/fused_sweep.cu`), which replaces
`banded_warp_dot_volume` (the same `_banded_kernel` in mode "dot"); its
plain version is `dot_sweep_reference`. `DotSweep` makes it
differentiable with a plain PyTorch backward, `dot_sweep_backward`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _scatter_taps_(d_src_rows, d_s_bkdNc, pix_bkdN2, h: int, w: int):
    """Adds the bilinear transpose of (b, k, dc, N, c) sample gradients
    at pixel coords (u, v) into (b*k*h*w, c) rows: each of the four taps
    at index coords (u - 0.5, v - 0.5) inside the image gets its weight
    times the gradient, as the kernels sample."""
    b, k, dc, n, c = d_s_bkdNc.shape
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
        idx = base + torch.where(valid, yt * w + xt, 0.0).long()
        vals = d_s_bkdNc * torch.where(valid, wgt, 0.0)[..., None]
        d_src_rows.index_add_(0, idx.reshape(-1), vals.reshape(-1, c))


def check_dot_args(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                   src_Ks_bk44, cur_invK_b44, depth_planes_bd) -> tuple:
    """Raises on any feature or geometry argument the kernels do not take;
    returns (b, k, h, w, c, d). The compute dtype is the features'."""
    device = src_feats_bkhwc.device
    cdt = src_feats_bkhwc.dtype
    if cdt not in _build.DTYPE_CODES:
        raise TypeError(f"compute dtype {cdt} is not float32 or bfloat16")
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_bd.shape[1]
    f32 = torch.float32
    check = _build.check
    check("src_feats", src_feats_bkhwc, cdt, (b, k, h, w, c), device)
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
    fused_sweep.launches += 1
    return out


fused_sweep.launches = 0


def fused_sweep_bwd(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                    src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                    pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    g_bdN) -> tuple:
    """Backward of the fused sweep (K2), given the float32 cotangent g
    (b, d, N) of its output; the other arguments are `fused_sweep`'s.

    Returns float32 (d_src, d_cur, d_w0, d_b0, d_w1, d_b1, d_w2, d_b2),
    as `fused_sweep_backward_reference` does. CPU tensors go to that plain
    version; CUDA tensors launch the kernel, or raise. On the card d_src
    is summed with float32 atomics, so its last bits vary from run to
    run; the other gradients are summed in a fixed order.
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
        d_src = torch.zeros(src_feats_bkhwc.shape, dtype=f32, device=device)
        d_cur = torch.empty((b, h * w, c), dtype=f32, device=device)
        partials = torch.empty((blocks, n_params), dtype=f32, device=device)
        d_params = torch.empty((n_params,), dtype=f32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [0 if t is None else t.data_ptr() for t in (
            src_feats_bkhwc, cur_bNc, proj, cur_invK_b44, depth_planes_bd,
            pose_meta_bk3, src_loc_bk3, w0, w0t, b0, w1, w1t, b1, w2, g_bdN,
            d_src, d_cur, partials, d_params)]
        rc = lib.fused_sweep_mlp_bwd(_build.DTYPE_CODES[w0.dtype], *ptrs,
                                     blocks, b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "fused_sweep_mlp_bwd", rc)
    fused_sweep_bwd.launches += 1
    sizes = (cin * HIDDEN, HIDDEN * HIDDEN, HIDDEN, HIDDEN, HIDDEN, 1)
    d_w0, d_w1, d_b0, d_b1, d_w2, d_b2 = torch.split(d_params, sizes)
    return (d_src, d_cur, d_w0.reshape(cin, HIDDEN), d_b0,
            d_w1.reshape(HIDDEN, HIDDEN), d_b1, d_w2.reshape(HIDDEN, 1), d_b2)


fused_sweep_bwd.launches = 0


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


def dot_sweep_backward(src_feats_bkhwc, cur_bNc, src_extrinsics_bk44,
                       src_Ks_bk44, cur_invK_b44, depth_planes_bd,
                       g_bdN) -> tuple:
    """Backward of the dot-product sweep, in plain PyTorch on any device,
    given the cotangent g (b, d, N) of its output: with m = mask * g per
    (view, plane, pixel),
        d_cur = sum over views and planes of m * sample,
        d_src = the bilinear transpose of m * cur (a scatter of the taps).
    Geometry gets none. Recomputes the warp chunk by chunk; returns float32
    (d_src (b,k,h,w,c), d_cur (b,N,c)).

    The JAX package has no backward kernel for the dot mode (it trains
    the dot model through autodiff of its XLA warp), so neither does the
    port. Its work shows in a profiler as the range "dot_sweep_backward".
    """
    b, k, h, w, c = src_feats_bkhwc.shape
    f32 = torch.float32
    with torch.profiler.record_function("dot_sweep_backward"):
        cur = cur_bNc.float()
        src = src_feats_bkhwc.float()
        g_bdN = g_bdN.to(f32)
        d_src = torch.zeros((b * k * h * w, c), dtype=f32, device=cur.device)
        d_cur = torch.zeros((b, h * w, c), dtype=f32, device=cur.device)
        for s in range(0, depth_planes_bd.shape[1], REFERENCE_PLANE_CHUNK):
            sl = slice(s, s + REFERENCE_PLANE_CHUNK)
            warp = cv_ops.sweep_warp(src, src_extrinsics_bk44, src_Ks_bk44,
                                     cur_invK_b44,
                                     depth_planes_bd[:, sl].float())
            m_bkdN = warp.mask_bkdN * g_bdN[:, None, sl]
            d_cur += torch.einsum("bkdn,bkdnc->bnc", m_bkdN,
                                  warp.sampled_bkdNc)
            _scatter_taps_(d_src, m_bkdN[..., None] * cur[:, None, None],
                           warp.pix_bkdN2, h, w)
    return d_src.reshape(b, k, h, w, c), d_cur


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
    if c != DOT_CHANNELS:
        raise ValueError(f"K1-dot takes {DOT_CHANNELS} feature channels, "
                         f"got {c}")
    for name, t in (("src_feats", src_feats_bkhwc), ("cur_feats", cur_bNc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "K1-dot's vector loads")
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
    dot_sweep.launches += 1
    return out


dot_sweep.launches = 0


class DotSweep(torch.autograd.Function):
    """The differentiable dot-product sweep: forward `dot_sweep` (K1-dot
    on the card, its plain version on the CPU), backward
    `dot_sweep_backward` (plain PyTorch). Gradients go to the source and
    reference features, in their dtype; geometry gets none."""

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
