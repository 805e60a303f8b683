"""The hero feature volume's two earlier sweep kernels (counterparts of
`fused_feature_volume` and `fused_warp_feature_volume` in
`simplerecon_tpu/ops/pallas_cv.py`), both inference only.

`fused_feature_volume` (K5, backend "pallas_v1") runs the 202-channel
metadata and the MLP over a stack that a plain warp has already sampled:
`stack_inputs` builds that stack with `ops/cost_volume.py::sweep_warp`,
as the JAX package builds it in XLA outside its kernel.
`fused_warp_feature_volume` (K4, backend "pallas_full") projects, warps
and runs the metadata and the MLP in one kernel, from the c-major source
maps and projection matrices of `warp_inputs`.

Both kernels are in `csrc/early_sweeps.cu` and share K1's metadata rows
and MLP (`csrc/sweep_common.cuh`): in bf16 K1's tensor-core tile
(`mma.sync`, `csrc/sweep_mma.cuh`), in float32 K1's CUDA-core MLP. Their
plain versions,
`fused_feature_volume_reference` and
`fused_warp_feature_volume_reference`, keep the JAX kernels' arguments,
layouts and rounding points:
- K5 takes its samples already rounded to the compute dtype, so its dot
  rows come from the rounded samples (K1 dots unrounded ones);
- K4 rounds its y-tap weights to the compute dtype and keeps the x-tap
  weights in float32, sampling y first and then x; its samples stay
  float32 for the dot rows;
- both build the MLP input from the given unnormalised rays (world point
  ray * plane) and round it once, then round each hidden activation.
The wrappers launch the kernels for CUDA tensors (or raise) and use the
plain versions only for CPU tensors. `InferenceOnly` puts either inside
autograd so that a backward through them raises: the JAX package has no
VJP for these backends either.
"""

from __future__ import annotations

import torch

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.ops import _build
from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops.cuda_cv import (REFERENCE_PLANE_CHUNK, _round,
                                               check_meta_args, mlp_reference)

STACK_BYTES = 1 << 30   # the JAX package's bound on one warp stack chunk
STACK_VECTOR = 8        # stack channels per vector load of K5


def stack_plane_chunk(b: int, k: int, n: int, c: int, d: int) -> int:
    """Planes per K5 launch, by the JAX package's rule
    (`models/cost_volume.py::MLPFeatureVolume._pallas_volume`): the largest
    divisor of d whose bf16 warp stack (b, k, planes, N, c) stays within
    1 GiB. 64 (one launch) at hero b1, 32 at hero b8."""
    per_plane = b * k * n * c * 2
    dc = max(1, min(d, STACK_BYTES // max(per_plane, 1)))
    while d % dc:
        dc -= 1
    return dc


def stack_inputs(src_feats_bkhwc, src_extrinsics_bk44, src_Ks_bk44,
                 cur_invK_b44, depth_planes_bd, cdt) -> tuple:
    """K5's pre-warped inputs for the planes (b, d): the stack
    (k, b*d*N, c) in `cdt`, rows ordered (b, d, N), and the float32 mask
    and projected depths (k, b*d*N). The plain gather warp samples the
    features in float32; the stack is rounded to `cdt` once."""
    b, k, h, w, c = src_feats_bkhwc.shape
    warp = cv_ops.sweep_warp(src_feats_bkhwc.float(), src_extrinsics_bk44,
                             src_Ks_bk44, cur_invK_b44, depth_planes_bd)
    # (b, k, ...) -> (k, b, ...) rows; the warp's outputs are strided views
    sampled = warp.sampled_bkdNc.to(cdt).transpose(0, 1).reshape(k, -1, c)
    mask = warp.mask_bkdN.float().transpose(0, 1).reshape(k, -1)
    depths = warp.depths_bkdN.transpose(0, 1).reshape(k, -1)
    return sampled.contiguous(), mask.contiguous(), depths.contiguous()


def warp_inputs(src_feats_bkhwc, src_extrinsics_bk44, src_Ks_bk44,
                cdt) -> tuple:
    """K4's source inputs: the maps (b, k, h, c*w) in `cdt` with c-major
    rows, and proj = K @ src_T_cur (b, k, 4, 4) float32."""
    b, k, h, w, c = src_feats_bkhwc.shape
    img = src_feats_bkhwc.to(cdt).permute(0, 1, 2, 4, 3).reshape(
        b, k, h, c * w).contiguous()
    proj = torch.matmul(src_Ks_bk44.float(), src_extrinsics_bk44.float())
    return img, proj.contiguous()


def _metadata_inputs(sampled, mask, depth, cur, rays, planes, pose_meta,
                     src_loc) -> torch.Tensor:
    """The float32 MLP input (b, dc, N, C_in) of `_metadata_mlp` for dc
    planes: samples (b, dc, N, k, c), which also give the dot rows; mask
    and depth (b, dc, N, k); cur (b, N, c); unnormalised rays (b, N, 3);
    planes (b, dc); pose_meta and src_loc (b, k, 3)."""
    b, dc, n, k, c = sampled.shape
    world = rays[:, None] * planes[:, :, None, None]              # (b,dc,N,3)
    ref = rays * torch.rsqrt((rays * rays).sum(-1, keepdim=True) + 1e-30)
    v = world[:, :, :, None] - src_loc[:, None, None]            # (..., k, 3)
    src = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-30)
    angle = (ref[:, None, :, None] * src).sum(-1)                 # (b,dc,N,k)
    dots = (sampled * cur[:, None, :, None]).sum(-1) * mask
    return torch.cat([
        sampled.reshape(b, dc, n, k * c),
        cur[:, None].expand(b, dc, n, c),
        mask, depth,
        planes[:, :, None, None].expand(b, dc, n, 1),
        dots, angle,
        ref[:, None].expand(b, dc, n, 3),
        src.reshape(b, dc, n, 3 * k),
        pose_meta.transpose(1, 2).reshape(b, 1, 1, 3 * k).expand(
            b, dc, n, 3 * k),
    ], dim=-1)


def fused_feature_volume_reference(sampled_kRc, mask_kR, depths_kR, cur_bNc,
                                   rays_bN3, planes_bd, pose_meta_bk3,
                                   src_loc_bk3, w0, b0, w1, b1, w2, b2
                                   ) -> torch.Tensor:
    """Plain PyTorch version of K5: metadata + MLP over the stack, in
    chunks of 8 planes. The samples are the stack's values in float32,
    for the visual rows and the dot rows alike. Returns (b, d, N)
    float32."""
    k, _, c = sampled_kRc.shape
    b, n, _ = cur_bNc.shape
    d = planes_bd.shape[1]
    stack = sampled_kRc.reshape(k, b, d, n, c)
    mask = mask_kR.reshape(k, b, d, n)
    depths = depths_kR.reshape(k, b, d, n)
    cur, rays = cur_bNc.float(), rays_bN3.float()
    pose_meta, src_loc = pose_meta_bk3.float(), src_loc_bk3.float()
    chunks = []
    for s in range(0, d, REFERENCE_PLANE_CHUNK):
        sl = slice(s, s + REFERENCE_PLANE_CHUNK)
        feats = _metadata_inputs(
            stack[:, :, sl].float().permute(1, 2, 3, 0, 4),
            mask[:, :, sl].float().permute(1, 2, 3, 0),
            depths[:, :, sl].float().permute(1, 2, 3, 0),
            cur, rays, planes_bd[:, sl].float(), pose_meta, src_loc)
        chunks.append(mlp_reference(feats, w0, b0, w1, b1, w2, b2))
    return torch.cat(chunks, dim=1)


def _two_hot(coord, size: int) -> tuple:
    """The taps of `_twohot_weights` along one axis: indices floor(coord)
    and floor(coord) + 1 and weights 1 - frac and frac, each index 0 and
    weight 0 outside [0, size)."""
    c0 = torch.floor(coord)
    f1 = coord - c0
    v0 = (c0 >= 0) & (c0 <= size - 1)
    v1 = (c0 + 1 >= 0) & (c0 + 1 <= size - 1)
    i0 = torch.where(v0, c0, 0.0).long()
    i1 = torch.where(v1, c0 + 1, 0.0).long()
    return (i0, i1, torch.where(v0, 1.0 - f1, 0.0),
            torch.where(v1, f1, 0.0))


def fused_warp_feature_volume_reference(img_bkhW, cur_bNc, rays_bN3,
                                        planes_bd, proj_bk44, pose_meta_bk3,
                                        src_loc_bk3, w0, b0, w1, b1, w2, b2
                                        ) -> torch.Tensor:
    """Plain PyTorch version of K4, in chunks of 8 planes: the projection
    with `project_points`' eps-safe divide, the separable two-hot samples
    (y weights rounded to the compute dtype, y first, then x in float32),
    then the metadata and the MLP as K5's. Returns (b, d, N) float32."""
    b, k, h, cw = img_bkhW.shape
    n, c = cur_bNc.shape[1:]
    w = cw // c
    d = planes_bd.shape[1]
    cdt = w0.dtype
    maps = img_bkhW.float().reshape(b, k, h, c, w).permute(
        0, 1, 2, 4, 3).reshape(b * k, h * w, c)
    bk = torch.arange(b * k, device=maps.device)[:, None]
    P = proj_bk44.float()[:, :, None, None]                  # (b,k,1,1,4,4)
    cur, rays = cur_bNc.float(), rays_bN3.float()
    pose_meta, src_loc = pose_meta_bk3.float(), src_loc_bk3.float()

    def tap(iy, ix):
        return maps[bk, (iy * w + ix).reshape(b * k, -1)].reshape(
            iy.shape + (c,))

    chunks = []
    for s in range(0, d, REFERENCE_PLANE_CHUNK):
        planes = planes_bd[:, s:s + REFERENCE_PLANE_CHUNK].float()
        world = rays[:, None] * planes[:, :, None, None]     # (b, dc, N, 3)
        wx, wy, wz = (world[None, ..., i].transpose(0, 1)    # (b, 1, dc, N)
                      for i in range(3))
        cx = wx * P[..., 0, 0] + wy * P[..., 0, 1] + wz * P[..., 0, 2] \
            + P[..., 0, 3]
        cy = wx * P[..., 1, 0] + wy * P[..., 1, 1] + wz * P[..., 1, 2] \
            + P[..., 1, 3]
        cz = wx * P[..., 2, 0] + wy * P[..., 2, 1] + wz * P[..., 2, 2] \
            + P[..., 2, 3]                                   # (b, k, dc, N)
        z_eps = cz + 1e-8
        scale = torch.where(cz.abs() > 1e-8, 1.0 / z_eps, 1.0)
        ix0, ix1, wx0, wx1 = _two_hot(cx * scale - 0.5, w)
        iy0, iy1, wy0, wy1 = _two_hot(cy * scale - 0.5, h)
        wy0, wy1 = _round(wy0, cdt)[..., None], _round(wy1, cdt)[..., None]
        r0 = wy0 * tap(iy0, ix0) + wy1 * tap(iy1, ix0)
        r1 = wy0 * tap(iy0, ix1) + wy1 * tap(iy1, ix1)
        sampled = wx0[..., None] * r0 + wx1[..., None] * r1  # (b,k,dc,N,c)
        feats = _metadata_inputs(
            sampled.permute(0, 2, 3, 1, 4),
            (z_eps > 0).float().permute(0, 2, 3, 1),
            z_eps.permute(0, 2, 3, 1), cur, rays, planes, pose_meta,
            src_loc)
        chunks.append(mlp_reference(feats, w0, b0, w1, b1, w2, b2))
    return torch.cat(chunks, dim=1)


def _check_pixel_args(cur_bNc, rays_bN3, planes_bd, cdt, device) -> tuple:
    """Raises on reference features, rays or planes the kernels do not
    take; returns (b, N, c, d)."""
    b, n, c = cur_bNc.shape
    d = planes_bd.shape[1]
    f32 = torch.float32
    _build.check("cur_feats", cur_bNc, cdt, (b, n, c), device)
    _build.check("rays", rays_bN3, f32, (b, n, 3), device)
    _build.check("depth_planes", planes_bd, f32, (b, d), device)
    return b, n, c, d


def fused_feature_volume(sampled_kRc, mask_kR, depths_kR, cur_bNc, rays_bN3,
                         planes_bd, pose_meta_bk3, src_loc_bk3,
                         w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Metadata + MLP over a pre-warped stack (K5). Returns (b, d, N)
    float32.

    Arguments follow the JAX `fused_feature_volume`: the stack
    (k, b*d*N, c) in the compute dtype (float32 or bfloat16, that of the
    weights), rows ordered (b, d, N); mask and projected depths
    (k, b*d*N), unnormalised rays (b, N, 3), planes (b, d), pose metadata
    and source camera centres (b, k, 3) in float32; reference features
    (b, N, c) in the compute dtype; MLP weights (in, out) and float32
    biases. On the card c is a multiple of 8, the stack and the reference
    features start on 16-byte boundaries, and all inputs are contiguous.
    CPU tensors go to `fused_feature_volume_reference`; CUDA tensors
    launch the kernel, or raise.
    """
    args = (sampled_kRc, mask_kR, depths_kR, cur_bNc, rays_bN3, planes_bd,
            pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2)
    device = _build.kernel_device(sampled_kRc, "fused_feature_volume")
    if device is None:
        return fused_feature_volume_reference(*args)
    cdt = sampled_kRc.dtype
    if cdt not in _build.DTYPE_CODES:
        raise TypeError(f"compute dtype {cdt} is not float32 or bfloat16")
    b, n, c, d = _check_pixel_args(cur_bNc, rays_bN3, planes_bd, cdt, device)
    k = sampled_kRc.shape[0]
    f32 = torch.float32
    _build.check("sampled", sampled_kRc, cdt, (k, b * d * n, c), device)
    _build.check("mask", mask_kR, f32, (k, b * d * n), device)
    _build.check("depths", depths_kR, f32, (k, b * d * n), device)
    check_meta_args(pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    b, k, c, cdt, device)
    if c % STACK_VECTOR:
        raise ValueError(f"K5 reads the stack in vectors of {STACK_VECTOR} "
                         f"channels; got c = {c}")
    for name, t in (("sampled", sampled_kRc), ("cur_feats", cur_bNc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             "K5's vector loads")
    lib = _build.load_library()
    with torch.cuda.device(device):
        out = torch.empty((b, d, n), dtype=f32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_feature_volume(
            _build.DTYPE_CODES[cdt], *[t.data_ptr() for t in args + (out,)],
            b, k, n, c, d, stream)
    _build.raise_on_error(lib, "fused_feature_volume", rc)
    tracing.count("launch.fused_feature_volume")
    return out


def fused_warp_feature_volume(img_bkhW, cur_bNc, rays_bN3, planes_bd,
                              proj_bk44, pose_meta_bk3, src_loc_bk3,
                              w0, b0, w1, b1, w2, b2) -> torch.Tensor:
    """Projection, warp, metadata and MLP in one kernel (K4). Returns
    (b, d, N) float32.

    Arguments follow the JAX `fused_warp_feature_volume`: source maps
    (b, k, h, c*w) with c-major rows and reference features (b, N, c) in
    the compute dtype (that of the weights); unnormalised rays (b, N, 3),
    planes (b, d), proj = K @ src_T_cur (b, k, 4, 4), pose metadata and
    source camera centres (b, k, 3) in float32; MLP weights (in, out) and
    float32 biases; all contiguous on the card. CPU tensors go to
    `fused_warp_feature_volume_reference`; CUDA tensors launch the kernel,
    or raise.
    """
    args = (img_bkhW, cur_bNc, rays_bN3, planes_bd, proj_bk44, pose_meta_bk3,
            src_loc_bk3, w0, b0, w1, b1, w2, b2)
    device = _build.kernel_device(img_bkhW, "fused_warp_feature_volume")
    if device is None:
        return fused_warp_feature_volume_reference(*args)
    cdt = img_bkhW.dtype
    if cdt not in _build.DTYPE_CODES:
        raise TypeError(f"compute dtype {cdt} is not float32 or bfloat16")
    b, n, c, d = _check_pixel_args(cur_bNc, rays_bN3, planes_bd, cdt, device)
    k, h, cw = img_bkhW.shape[1:]
    w = cw // c
    if h * w != n or w * c != cw:
        raise ValueError(f"source maps {tuple(img_bkhW.shape)} do not hold "
                         f"{n} pixels of {c} channels")
    _build.check("img", img_bkhW, cdt, (b, k, h, cw), device)
    _build.check("proj", proj_bk44, torch.float32, (b, k, 4, 4), device)
    check_meta_args(pose_meta_bk3, src_loc_bk3, w0, b0, w1, b1, w2, b2,
                    b, k, c, cdt, device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        out = torch.empty((b, d, n), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fused_warp_feature_volume(
            _build.DTYPE_CODES[cdt], *[t.data_ptr() for t in args + (out,)],
            b, k, h, w, c, d, stream)
    _build.raise_on_error(lib, "fused_warp_feature_volume", rc)
    tracing.count("launch.fused_warp_feature_volume")
    return out


class InferenceOnly(torch.autograd.Function):
    """Runs `fn(*args)`, one of the inference-only kernels (K4, K5),
    inside autograd: its output joins the graph of its inputs, and a
    backward through it raises instead of leaving the features and the
    MLP weights silently without gradient."""

    @staticmethod
    def forward(ctx, backend, fn, *args):
        ctx.backend = backend
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            f"cost_volume_backend {ctx.backend!r} is inference-only, as in "
            "the JAX package; train through 'pallas' or 'xla_fused' (the "
            "fused sweep K1 with its backward K2)")
