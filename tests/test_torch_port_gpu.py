"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the fused sweep (K1 forward, K2 backward), the order-free scatter
of the sweeps' gradient, the dot-product sweep (K1-dot) and its d_cur
mode, the stem pool
(K3 forward and backward) and the hero model's inference-only sweeps (K5
over a warped stack, K4 the full-width fused warp); the eval and training
programs on the card, the convolution stacks in channels_last with no
cuDNN transpose, and a full training checkpoint of card tensors
restored bit for bit. Marked `gpu`;
skipped where there is no CUDA device. Run on the H100 with
`python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py`.

K1 tolerances: float32 1e-4 * max(1, max |plain|): both sum the same
fp32 products in another order, from tap coordinates that round
differently. bf16 1e-2 * max(1, max |plain|): a last-bit difference in a
float32 sample can flip its rounding to bf16 (a 2^-8 relative step) in
the MLP input.

K2 tolerances, per gradient. float32 against the float32 plain
backward: at the small odd shape max |kernel - plain| <= 1e-4 max |plain|
(the same sums in another order; d_src in fixed point, the plain
version's in float32).
At the hero shape (100 M (pixel, plane, hidden unit) pre-activations) a
last-bit difference in a 202-term pre-activation sum flips the leaky
ReLU's slope between 1 and 0.01 for some of them, and each flip moves
that unit's gradient by 99%: there the check is
||kernel - plain|| <= 1e-2 ||plain|| (measured <= 2.1e-3 on an H100 80GB
HBM3 at 700 W).
bf16 against the float32 plain backward on the same bf16-valued inputs:
||kernel - plain|| <= 0.1 ||plain|| (measured <= 4.7e-2): the kernel
rounds at six points (the MLP input, h0, h1, d_h1p, d_h0p, d_s) by up to
2^-9 each, and the gradients sum those products with cancellation. The
plain backward in bf16 is as far from float32 (measured <= 4.6e-2).

bf16 K1 and K2 run on the tensor cores (work items of 128 and 32 cells):
at shapes whose pixel count is no multiple of either and whose plane
count is no multiple of any plane group, with c = 16 (16-byte tap loads)
and c = 4 (scalar taps and atomics), K1 is held as above and K2 to
||kernel - plain|| <= 2e-2 ||plain|| per gradient against the bf16 plain
backward (the same rounding points; a float32 sum in another order flips
a few bf16 roundings, which the gradients' cancelling sums amplify), and
to the 0.1 above against the float32 one. K2's d_cur and weight and
bias gradients are summed in a fixed order and d_src in fixed point: two
calls give the same bits, d_src included.

The scatter (`sweep_scatter`, K2's d_src and the dot backward's): max
|kernel - plain| <= 1e-4 * max(1, max |plain|) against
`sweep_scatter_reference`, which sums the same 64-bit integers: they
differ only where the projection's float32 sums, in another order, move
a tap weight by an ulp of the pixel coordinate. Two calls give the same
bits, whether a block sums in its shared-memory window (cameras as close
as in training) or adds straight to device memory (source views zoomed
in, so one plane's taps of a tile outgrow the window). The dot model's
backward on the card (its d_src from the scatter, its d_cur from K1-dot's
d_cur mode) gives the same bits from two calls.

K1-dot: max |kernel - plain| <= 1e-4 * max(1, max |plain|) in float32
and in bf16. Neither version rounds inside: both sample bf16 maps in
float32 and dot in float32, so the two differ only by the order of the
sums and by tap coordinates that round differently. Its d_cur mode, the
sum over planes and views of mask * g * sample, is held to its plain
version by the same bound for the same reasons, and gives the same bits
from two calls (each pixel's sum runs in a fixed order).

K5 and K4: as K1 (the same MLP, summed in another order, behind inputs
rounded at the same points), 1e-4 in float32 and 1e-2 in bf16, times
max(1, max |plain|).

K3, at an odd shape, an odd H with 16-byte rows, a width that no column
tile divides, a map that starts off a 16-byte boundary (staged element
by element) and the encoder's b1 shape; float32: max |kernel - plain|
<= 1e-5 * max(1, max |plain|) for the output and for dx (the same sums
of at most 36 positive-weight terms in another order). bf16: the kernel
sums in float32 and rounds once, so against the plain chain in float32
on the same bf16-valued input every element is within 2^-8 of the
reference's magnitude (one rounding, 2^-9, with room for the sum
order). dx must be nonzero at exactly the elements where the plain
autograd's is, for a positive cotangent (the first maximum of each 2x2
window, ties included). Two calls give the same bits.
"""

import math

import pytest
import torch

from simplerecon_tpu_torch.ops import (cuda_cv, early_sweeps,
                                      launch_counts, pool)
from simplerecon_tpu_torch.testing import (POOL_CASES, dot_case, pool_case,
                                           pool_cotangent, relative_errors,
                                           scatter_case, shifted, stack_case,
                                           sweep_case, sweep_cotangent,
                                           warp_case)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_MAX_TOL = 1e-4                          # float32, odd shape
BWD_L2_TOL = {torch.float32: 1e-2, torch.bfloat16: 0.1}
BWD_SAME_ROUNDING_TOL = 2e-2                # bf16 against the bf16 plain
DOT_TOL = 1e-4
DCUR_TOL = 1e-4
SCATTER_TOL = 1e-4
POOL_TOL = 1e-5                             # float32
POOL_BF16_REL = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 8, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
def test_kernel_matches_plain_version(cuda, dtype, shape):
    args = sweep_case(*shape, dtype=dtype, device=cuda, seed=1)
    before = launch_counts()["fused_sweep"]
    with torch.no_grad():
        got = cuda_cv.fused_sweep(*args)
        want = cuda_cv.fused_sweep_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["fused_sweep"] == before + 1
    b, k, h, w, c, d = shape
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.abs().max().item()), err


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    args = sweep_case(1, 2, 8, 8, 4, 3, dtype=torch.float32, device=cuda)
    bad = list(args)
    bad[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cv.fused_sweep(*bad)
    bad = list(args)
    bad[1] = args[1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_cv.fused_sweep(*bad)
    with pytest.raises(ValueError, match="shape"):
        cuda_cv.fused_sweep_bwd(*args, torch.zeros(1, 3, 63, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 8, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
def test_backward_kernel_matches_plain_version(cuda, dtype, shape):
    b, k, h, w, c, d = shape
    args = sweep_case(*shape, dtype=dtype, device=cuda, seed=1)
    g = sweep_cotangent(b, d, h * w, cuda, seed=2)
    before = launch_counts()["fused_sweep_bwd"]
    got = cuda_cv.fused_sweep_bwd(*args, g)
    torch.cuda.synchronize()
    assert launch_counts()["fused_sweep_bwd"] == before + 1
    want = cuda_cv.fused_sweep_backward_reference(
        *[a.float() for a in args], g)
    for a, ref in zip(got, want):
        assert a.shape == ref.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all()
    errs = relative_errors(got, want)
    if dtype == torch.float32 and shape[2] < 96:
        assert max(e[0] for e in errs.values()) <= BWD_MAX_TOL, errs
    assert max(e[1] for e in errs.values()) <= BWD_L2_TOL[dtype], errs


def test_autograd_through_the_kernels_launches_each_once(cuda):
    args = sweep_case(1, 2, 8, 8, 4, 3, dtype=torch.float32, device=cuda)
    for i in (0, 1, 8, 10, 12):
        args[i].requires_grad_()
    before = (launch_counts()["fused_sweep"],
              launch_counts()["fused_sweep_bwd"])
    cuda_cv.FusedSweep.apply(*args).square().sum().backward()
    assert (launch_counts()["fused_sweep"],
            launch_counts()["fused_sweep_bwd"]) == (before[0] + 1,
                                                  before[1] + 1)
    assert args[0].grad is not None and args[8].grad is not None


@pytest.mark.parametrize("shape", [(2, 7, 20, 30, 16, 7),
                                   (1, 2, 9, 11, 4, 3)],
                         ids=["ragged_c16", "ragged_c4"])
def test_bf16_tensor_core_kernels_match_plain_versions(cuda, shape):
    b, k, h, w, c, d = shape
    args = sweep_case(*shape, dtype=torch.bfloat16, device=cuda, seed=3)
    g = sweep_cotangent(b, d, h * w, cuda, seed=4)
    before = (launch_counts()["fused_sweep"],
              launch_counts()["fused_sweep_bwd"])
    with torch.no_grad():
        got = cuda_cv.fused_sweep(*args)
    grads = cuda_cv.fused_sweep_bwd(*args, g)
    torch.cuda.synchronize()
    assert (launch_counts()["fused_sweep"],
            launch_counts()["fused_sweep_bwd"]) == (before[0] + 1,
                                                  before[1] + 1)
    want = cuda_cv.fused_sweep_reference(*args)
    assert got.shape == (b, d, h * w) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL[torch.bfloat16] * max(1.0, want.abs().max().item())
    for a in grads:
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
    same = relative_errors(
        grads, cuda_cv.fused_sweep_backward_reference(*args, g))
    assert max(e[1] for e in same.values()) <= BWD_SAME_ROUNDING_TOL, same
    f32 = relative_errors(grads, cuda_cv.fused_sweep_backward_reference(
        *[a.float() for a in args], g))
    assert max(e[1] for e in f32.values()) <= BWD_L2_TOL[torch.bfloat16], f32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_kernel_sums_weights_in_a_fixed_order(cuda, dtype):
    shape = (2, 7, 20, 30, 16, 7)
    b, k, h, w, c, d = shape
    args = sweep_case(*shape, dtype=dtype, device=cuda, seed=5)
    g = sweep_cotangent(b, d, h * w, cuda, seed=6)
    first = cuda_cv.fused_sweep_bwd(*args, g)
    second = cuda_cv.fused_sweep_bwd(*args, g)
    torch.cuda.synchronize()
    for name, x, y in zip(("d_src", "d_cur", "d_w0", "d_b0", "d_w1", "d_b1",
                           "d_w2", "d_b2"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 16, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
def test_dot_kernel_matches_plain_version(cuda, dtype, shape):
    args = dot_case(*shape, dtype=dtype, device=cuda, seed=1)
    before = launch_counts()["dot_sweep"]
    got = cuda_cv.dot_sweep(*args)
    want = cuda_cv.dot_sweep_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["dot_sweep"] == before + 1
    b, k, h, w, c, d = shape
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= DOT_TOL * max(1.0, want.abs().max().item()), err


def test_dot_sweep_function_launches_the_kernel_once(cuda):
    args = dot_case(1, 2, 8, 8, 16, 3, dtype=torch.float32, device=cuda)
    args[0].requires_grad_()
    args[1].requires_grad_()
    counters = (cuda_cv.dot_sweep, cuda_cv.sweep_scatter,
                cuda_cv.dot_sweep_dcur)
    before = [launch_counts()[fn.__name__] for fn in counters]
    out = cuda_cv.DotSweep.apply(*args)
    g = torch.randn_like(out)
    out.backward(g)
    d_src, d_cur = cuda_cv.dot_sweep_backward(*[a.detach() for a in args],
                                              g)
    counts = launch_counts()
    assert [counts[fn.__name__] - n
            for fn, n in zip(counters, before)] == [1, 2, 2]
    # d_src is summed in fixed point by the scatter kernel, d_cur by K1-dot's
    # d_cur mode in a fixed order: two calls give the same bits
    assert torch.equal(args[0].grad, d_src)
    assert torch.equal(args[1].grad, d_cur)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 16, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
def test_dcur_mode_matches_plain_version(cuda, dtype, shape):
    b, k, h, w, c, d = shape
    src, _, extr, Ks, invK, planes = dot_case(*shape, dtype=dtype,
                                              device=cuda, seed=1)
    g = sweep_cotangent(b, d, h * w, cuda, seed=2)
    args = (src, extr, Ks, invK, planes, g)
    before = launch_counts()["dot_sweep_dcur"]
    got = cuda_cv.dot_sweep_dcur(*args)
    again = cuda_cv.dot_sweep_dcur(*args)
    want = cuda_cv.dot_sweep_dcur_reference(*args)
    torch.cuda.synchronize()
    assert launch_counts()["dot_sweep_dcur"] == before + 2
    assert got.shape == (b, h * w, c) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= DCUR_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 16, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
@pytest.mark.parametrize("mode", ["samples", "dot"])
def test_scatter_kernel_matches_plain_version(cuda, mode, dtype, shape):
    b, k, h, w, c, d = shape
    args, grads = scatter_case(*shape, dtype=dtype, device=cuda, seed=1,
                               dot=mode == "dot")
    before = launch_counts()["sweep_scatter"]
    got = cuda_cv.sweep_scatter(*args, **grads)
    again = cuda_cv.sweep_scatter(*args, **grads)
    torch.cuda.synchronize()
    assert launch_counts()["sweep_scatter"] == before + 2
    assert got.shape == (b, k, h, w, c) and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = cuda_cv.sweep_scatter_reference(*args, **grads)
    err = (got - want).abs().max().item()
    assert err <= SCATTER_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("geometry", ["close", "zoomed"])
def test_scatter_takes_each_path(cuda, geometry):
    """With cameras as close as in training, most blocks sum in their
    shared-memory window; with the source views zoomed in 4x, one plane's
    taps of a 16 x 16 tile span more pixels than the window holds, and the
    blocks add straight to device memory. Either way the kernel matches
    its plain version and gives the same bits twice."""
    shape = (1, 7, 96, 128, 16, 64)
    b, k, h, w, c, d = shape
    args, grads = scatter_case(*shape, dtype=torch.bfloat16, device=cuda,
                               seed=3, geometry="close")
    if geometry == "zoomed":
        proj = args[0].clone()
        proj[:, :, :2] *= 4.0
        args = (proj,) + args[1:]
    got = cuda_cv.sweep_scatter(*args, **grads)
    window, straight = cuda_cv.sweep_scatter.paths.tolist()
    again = cuda_cv.sweep_scatter(*args, **grads)
    want = cuda_cv.sweep_scatter_reference(*args, **grads)
    torch.cuda.synchronize()
    if geometry == "close":
        # near planes, where a camera moved toward the scene magnifies the
        # tile, may still go straight to device memory
        assert window > 10 * straight, (window, straight)
    else:
        assert straight > 0, (window, straight)
    assert torch.equal(got, again)
    assert want.abs().max() > 0
    err = (got - want).abs().max().item()
    assert err <= SCATTER_TOL * max(1.0, want.abs().max().item()), err


def _pool_errors(x, positive_g):
    """(output, dx) of the kernels and of the plain chain in float32."""
    got = pool.max_blur_pool(x)
    got_dx = pool.max_blur_pool_bwd(x, positive_g)
    want = pool.max_blur_pool_reference(x.float())
    want_dx = pool.max_blur_pool_backward_reference(x.float(),
                                                    positive_g.float())
    torch.cuda.synchronize()
    return (got, want), (got_dx, want_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(POOL_CASES), ids=list(POOL_CASES))
def test_pool_kernels_match_plain_versions(cuda, dtype, case):
    shape, offset = POOL_CASES[case]
    x = shifted(pool_case(shape, dtype, cuda, seed=3), offset)
    b, c, h, w = shape
    g = shifted(pool_cotangent((b, c) + pool.output_size(h, w), dtype, cuda,
                                seed=4, positive=True), offset)
    if offset:
        assert not pool.rows_by_16_bytes(x, w)   # element-wise staging
    if case == "encoder_b1":
        assert pool.rows_by_16_bytes(x, w)       # 16-byte staging
    before = (launch_counts()["max_blur_pool"],
              launch_counts()["max_blur_pool_bwd"])
    pairs = _pool_errors(x, g)
    assert (launch_counts()["max_blur_pool"],
            launch_counts()["max_blur_pool_bwd"]) == (before[0] + 1,
                                                 before[1] + 1)
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.isfinite(got).all()
        diff = (got.float() - want).abs()
        if dtype == torch.float32:
            assert diff.max() <= POOL_TOL * max(1.0, want.abs().max()), diff
        else:
            assert (diff <= POOL_BF16_REL * want.abs() + 1e-6).all(), diff
    got_dx, want_dx = pairs[1]
    assert torch.equal(got_dx != 0, want_dx != 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_pool_kernels_give_the_same_bits_twice(cuda, dtype):
    shape = POOL_CASES["encoder_b1"][0]
    x = pool_case(shape, dtype, cuda, seed=6)
    b, c, h, w = shape
    g = pool_cotangent((b, c) + pool.output_size(h, w), dtype, cuda, seed=7)
    assert torch.equal(pool.max_blur_pool(x), pool.max_blur_pool(x))
    assert torch.equal(pool.max_blur_pool_bwd(x, g),
                       pool.max_blur_pool_bwd(x, g))


def test_max_blur_pool_function_launches_each_kernel_once(cuda):
    x = pool_case((2, 4, 12, 16), torch.float32, cuda, seed=5)
    x.requires_grad_()
    before = (launch_counts()["max_blur_pool"],
              launch_counts()["max_blur_pool_bwd"])
    pool.MaxBlurPool.apply(x).square().sum().backward()
    assert (launch_counts()["max_blur_pool"],
            launch_counts()["max_blur_pool_bwd"]) == (before[0] + 1,
                                                 before[1] + 1)
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_new_wrappers_reject_what_their_kernels_do_not_take(cuda):
    x = pool_case((1, 2, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="h, w >= 4"):
        pool.max_blur_pool(x[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="shape"):
        pool.max_blur_pool_bwd(x, torch.zeros(1, 2, 3, 3, device=cuda))
    args = dot_case(1, 2, 8, 8, 16, 3, dtype=torch.float32, device=cuda)
    mixed = list(args)
    mixed[1] = args[1].to(torch.bfloat16)
    with pytest.raises(TypeError):
        cuda_cv.dot_sweep(*mixed)
    narrow = dot_case(1, 2, 8, 8, 8, 3, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="16 feature channels"):
        cuda_cv.dot_sweep(*narrow)
    shifted = list(args)
    shifted[0] = torch.empty(args[0].numel() + 1, device=cuda)[1:].view(
        args[0].shape).copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        cuda_cv.dot_sweep(*shifted)


EARLY_KERNELS = {
    "K5": (stack_case, early_sweeps.fused_feature_volume,
           early_sweeps.fused_feature_volume_reference),
    "K4": (warp_case, early_sweeps.fused_warp_feature_volume,
           early_sweeps.fused_warp_feature_volume_reference),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 13, 21, 8, 5),
                                   (1, 7, 96, 128, 16, 64)],
                         ids=["odd", "hero"])
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_early_kernels_match_plain_versions(cuda, kernel, dtype, shape):
    make_case, kernel_fn, plain_fn = EARLY_KERNELS[kernel]
    args = make_case(*shape, dtype=dtype, device=cuda, seed=1)
    before = launch_counts()[kernel_fn.__name__]
    with torch.no_grad():
        got = kernel_fn(*args)
        want = plain_fn(*args)
    torch.cuda.synchronize()
    assert launch_counts()[kernel_fn.__name__] == before + 1
    b, k, h, w, c, d = shape
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.abs().max().item()), err


def test_early_kernel_wrappers_reject_what_they_do_not_take(cuda):
    stack = stack_case(1, 2, 8, 8, 8, 3, dtype=torch.float32, device=cuda)
    bad = list(stack)
    bad[3] = stack[3].to(torch.bfloat16)            # cur in another dtype
    with pytest.raises(TypeError):
        early_sweeps.fused_feature_volume(*bad)
    bad = list(stack)
    bad[1] = stack[1].t().contiguous().t()         # mask not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        early_sweeps.fused_feature_volume(*bad)
    bad = list(stack)
    bad[4] = stack[4].cpu()                         # rays on the host
    with pytest.raises(ValueError, match="cpu"):
        early_sweeps.fused_feature_volume(*bad)
    narrow = stack_case(1, 2, 8, 8, 4, 3, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="vectors of 8"):
        early_sweeps.fused_feature_volume(*narrow)
    bad = list(stack)
    bad[0] = torch.empty(stack[0].numel() + 1, device=cuda)[1:].view(
        stack[0].shape).copy_(stack[0])            # off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        early_sweeps.fused_feature_volume(*bad)

    warp = warp_case(1, 2, 8, 8, 4, 3, dtype=torch.float32, device=cuda)
    bad = list(warp)
    bad[0] = warp[0][..., :-1].contiguous()         # not c * w per row
    with pytest.raises(ValueError, match="pixels"):
        early_sweeps.fused_warp_feature_volume(*bad)
    bad = list(warp)
    bad[7] = warp[7].to(torch.bfloat16)             # w0 in another dtype
    with pytest.raises(TypeError):
        early_sweeps.fused_warp_feature_volume(*bad)
    before = launch_counts()["fused_warp_feature_volume"]
    early_sweeps.fused_warp_feature_volume(*warp)
    assert launch_counts()["fused_warp_feature_volume"] == before + 1


def _eval_opts(out, *extra):
    from simplerecon_tpu_torch.options import OptionsHandler
    return OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", "configs/models/hero_model.yaml",
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--split", "test", "--run_fusion", "--cache_depths",
        "--output_base_path", str(out), "--image_height", "64",
        "--image_width", "96", "--num_images_in_tuple", "4",
        "--model_num_views", "4", "--matching_num_depth_bins", "8",
        "--precision", "32", "--batch_size", "16", "--num_workers", "2",
        *extra])


def test_eval_cli_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The eval CLI at 64x96 float32 on the card and on the CPU, the same
    seeded weights, over the whole 48-frame scene (45 tuples in batches
    of 16, 16, 13): cached depths, metrics and meshes within
    `testing.EVAL_TOL`; K1 launched once a batch."""
    from simplerecon_tpu_torch.data import synthetic
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.scripts import test as eval_cli
    from simplerecon_tpu_torch.testing import (compare_cached_depths,
                                               compare_meshes,
                                               compare_metrics,
                                               plane_ratio, spread_outputs_)
    from simplerecon_tpu_torch.utils.checkpoint import save_weights
    assert synthetic.DEFAULT_NUM_FRAMES == 48
    runs = {}
    for tag, device in (("cpu", "cpu"), ("gpu", cuda)):
        opts = _eval_opts(tmp_path / tag)
        if not runs:
            model = spread_outputs_(build_depth_model(opts, device="cpu",
                                                      seed=3), seed=3)
            ckpt = save_weights(str(tmp_path / "seeded.pt"), model, opts)
        opts.load_weights_from_checkpoint = ckpt
        before = launch_counts()["fused_sweep"]
        runs[tag] = eval_cli.main(opts, device=device)
        assert len(runs[tag][0].elem_metrics) == 45
        assert launch_counts()["fused_sweep"] - before == (
            3 if tag == "gpu" else 0)
    out = "hero_model/synthetic/default"
    compare_cached_depths(str(tmp_path / "gpu" / out / "depths/scene"),
                          str(tmp_path / "cpu" / out / "depths/scene"),
                          flip_ratio=plane_ratio(opts))
    (gpu_frames, gpu_scenes), (cpu_frames, cpu_scenes) = (runs["gpu"],
                                                          runs["cpu"])
    for got, want in zip(
            gpu_frames.elem_metrics + [gpu_scenes.final_metrics],
            cpu_frames.elem_metrics + [cpu_scenes.final_metrics]):
        compare_metrics(got, want, 64 * 96 * 0.5)
    compare_meshes(str(tmp_path / "gpu" / out / "meshes/4cm_3.0m/scene.ply"),
                   str(tmp_path / "cpu" / out / "meshes/4cm_3.0m/scene.ply"))


def test_our_fuser_on_the_card_matches_the_cpu(cuda):
    """The GT depths of 12 synthetic frames at 64x96 through `OurFuser` on
    the card and on the CPU: values and weights differ in at most 1e-3 of
    the voxels (the projection's float32 products, summed by cuBLAS on
    the card, can move a voxel's nearest pixel by one), and the meshes'
    counts within 1%."""
    from simplerecon_tpu_torch.fusion.fusers import OurFuser
    from simplerecon_tpu_torch.testing import (synthetic_gt_bounds,
                                               synthetic_gt_frames)
    frames = synthetic_gt_frames(12, 64, 96)
    fusers = {}
    for device in ("cpu", cuda):
        fuser = OurFuser(fusion_resolution=0.04, max_fusion_depth=3.0,
                         bounds_3x2=synthetic_gt_bounds(12, 64, 96),
                         device=device)
        for f in frames:
            fuser.fuse_frames(f["depth_b1hw"][None], f["K"][None],
                              f["cam_T_world"][None])
        fusers[str(device)] = fuser
    cpu, gpu = fusers["cpu"].fuser.tsdf, fusers[str(cuda)].fuser.tsdf
    for got, want in ((gpu.values, cpu.values), (gpu.weights, cpu.weights)):
        got, want = got.float().cpu().numpy(), want.float().numpy()
        assert (got != want).mean() <= 1e-3
    got_v, got_f = fusers[str(cuda)].get_mesh()
    want_v, want_f = fusers["cpu"].get_mesh()
    assert len(want_f) > 100
    assert abs(len(got_f) - len(want_f)) <= 0.01 * len(want_f)


def test_training_steps_repeat_their_bits(cuda):
    """Two hero b2 bf16 forward-and-backward passes from one state, as the
    training step runs them, in the card's channels_last layout: every
    gradient the same bits."""
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.parallel import train
    from simplerecon_tpu_torch.testing import hero_options, train_batch
    opts = hero_options()
    model = build_depth_model(opts, device=cuda, seed=0).train()
    assert model.memory_format == torch.channels_last
    batch = train.batch_to_device(train_batch(opts, 2, seed=7), cuda)
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        train.loss_and_backward(model, batch, flip=False)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert len(grads[0]) == len(list(model.parameters()))
    differ = [n for n, g in grads[0].items() if not torch.equal(g,
                                                                grads[1][n])]
    assert not differ, differ


# cuDNN's kernels that turn NCHW into NHWC and back around a convolution
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")
# the layout copies of a training step and of a request, besides the 4
# and 2 of each depthwise convolution (`layout.on_nchw`): the dot model's
# stem pool K3 takes NCHW maps (in and out, forward and backward)
LAYOUT_COPIES = {"hero": (0, 0), "dot": (4, 2)}


@pytest.mark.parametrize("name", ["hero", "dot"])
def test_convolutions_run_channels_last(cuda, name):
    """One small bf16 training step and one eval request on the card,
    profiled: every convolution's activations channels_last, forward and
    backward, but the depthwise ones' (NCHW), no cuDNN transpose kernel,
    and the layout copies of `LAYOUT_COPIES`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from simplerecon_tpu_torch import tracing
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.parallel import train
    from simplerecon_tpu_torch.scripts.test import make_forward_fn
    from simplerecon_tpu_torch.testing import (ConvolutionLayouts,
                                               dot_options, hero_options,
                                               train_batch)
    options = {"hero": hero_options, "dot": dot_options}[name]
    opts = options(image_height=64, image_width=96,
                   matching_num_depth_bins=8, model_num_views=4)
    model = build_depth_model(opts, device=cuda, seed=0)
    assert model.memory_format == torch.channels_last
    optimizer = train.make_optimizer(opts, model)
    batch = train.batch_to_device(train_batch(opts, 2, seed=1), cuda)
    generator = torch.Generator().manual_seed(0)
    forward = make_forward_fn(model)
    train.train_step(model, optimizer, batch, generator)
    forward(batch["cur"], batch["src"])
    torch.cuda.synchronize()

    def copies():
        return tracing.counters().get("layout_copies", 0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            ConvolutionLayouts() as convs:
        before = copies()
        train.train_step(model, optimizer, batch, generator)
        step = copies()
        forward(batch["cur"], batch["src"])
        torch.cuda.synchronize()
    counted = (step - before, copies() - step)
    kernels = {e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA}
    assert len(kernels) > 50
    assert not [k for k in kernels if any(t in k for t in TRANSPOSES)]
    assert len(convs.seen) > 600
    assert all(nchw if depthwise else cl
               for _, depthwise, cl, nchw in convs.seen)
    depthwise = sum(isinstance(m, torch.nn.Conv2d)
                    and m.groups == m.in_channels > 1
                    for m in model.modules())
    step_copies, request_copies = LAYOUT_COPIES[name]
    assert counted == (step_copies + 4 * depthwise,
                       request_copies + 2 * depthwise)


# the CUDA runtime's calls that make the host wait for the card
BLOCKING_CALLS =("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy")


def test_host_syncs_count_the_runtime_syncs_of_a_step(cuda):
    """The recorder's `host_syncs` of one hero training step against the
    CUDA runtime's synchronizing calls inside the profiled step: the same
    number, each inside an `sr.sync.<site>` span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from simplerecon_tpu_torch import tracing
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.parallel import train
    from simplerecon_tpu_torch.testing import hero_options, train_batch
    opts = hero_options(image_height=64, image_width=96,
                        matching_num_depth_bins=8, model_num_views=4)
    model = build_depth_model(opts, device=cuda, seed=0)
    optimizer = train.make_optimizer(opts, model)
    batch = train.batch_to_device(train_batch(opts, 2, seed=1), cuda)
    generator = torch.Generator().manual_seed(0)
    train.train_step(model, optimizer, batch, generator)
    torch.cuda.synchronize()
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.train_step(model, optimizer, batch, generator)
    after = tracing.counters()
    counted = {k: v - before.get(k, 0) for k, v in after.items()}

    def edges(e):
        if hasattr(e, "start_ns"):
            return e.start_ns(), e.end_ns()
        return e.start_us() * 1e3, (e.start_us() + e.duration_us()) * 1e3
    host = [(e.name(), *edges(e)) for e in prof.profiler.kineto_results
            .events() if e.device_type() == DeviceType.CPU]
    (step,) = [(s, t) for name, s, t in host if name == "sr.train_step"]
    syncs = [(s, t) for name, s, t in host
             if name in BLOCKING_CALLS and step[0] <= s <= step[1]]
    sites = [(s, t) for name, s, t in host if name.startswith("sr.sync.")]
    assert counted["train_steps"] == 1
    assert len(syncs) == counted["host_syncs"] >= 3, (syncs, counted)
    assert all(any(a <= s and t <= b for a, b in sites)
               for s, t in syncs), (syncs, sites)


def test_train_cli_on_the_card(cuda, tmp_path):
    """The training program at 64x96 bf16, batch 4, 4 steps with a
    validation at step 4 over 1 batch: K1, K2 and the scatter once a
    step and K1 once more for the validation, finite logged losses, the
    checkpoints and a panel; then a resumed run from step 4 to 5."""
    import json
    import os
    from simplerecon_tpu_torch.options import OptionsHandler
    from simplerecon_tpu_torch.scripts import train as train_cli

    def opts_for(*extra):
        return OptionsHandler().parse_and_merge_options(cl_args_list=[
            "--config_file", "configs/models/hero_model.yaml",
            "--dataset", "synthetic", "--single_debug_scan_id", "scene",
            "--image_height", "64", "--image_width", "96",
            "--num_images_in_tuple", "4", "--model_num_views", "4",
            "--matching_num_depth_bins", "8", "--batch_size", "4",
            "--val_batch_size", "4", "--log_interval", "1",
            "--val_interval", "4", "--val_batches", "1", "--num_workers", "2",
            "--num_devices", "1", "--log_dir", str(tmp_path), *extra])

    counters = (cuda_cv.fused_sweep, cuda_cv.fused_sweep_bwd,
                cuda_cv.sweep_scatter)
    before = [launch_counts()[fn.__name__] for fn in counters]
    state = train_cli.main(opts_for("--max_steps", "4"))
    counts = launch_counts()
    assert [counts[fn.__name__] - b
            for fn, b in zip(counters, before)] == [5, 4, 4]
    root = tmp_path / "hero_model"
    with open(root / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 4 and all(map(math.isfinite, losses)), rows
    assert os.listdir(root / "checkpoints") == ["step_4"]
    assert os.listdir(root / "best") == ["step_4"]
    assert os.path.isfile(root / "panels" / "step00000004_0.png")
    resumed = opts_for("--max_steps", "5")
    resumed.resume = str(root / "checkpoints")
    resumed.name = "resumed"
    state = train_cli.main(resumed)
    assert (state.step, state.optimizer.count) == (5, 5)


def test_full_state_checkpoint_of_card_tensors(cuda, tmp_path):
    """A training state on the card, two steps in, saved and restored into
    a fresh state on the card: parameters, buffers, AdamW moments,
    counters and the generator the same bits, on the card."""
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.parallel import train
    from simplerecon_tpu_torch.testing import hero_options, train_batch
    from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib
    opts = hero_options(image_height=64, image_width=96,
                        matching_num_depth_bins=8, model_num_views=4)

    def fresh(seed):
        model = build_depth_model(opts, device=cuda, seed=seed)
        return train.TrainState(model, train.make_optimizer(opts, model),
                                torch.Generator().manual_seed(seed))

    state = fresh(0)
    batch = train.batch_to_device(train_batch(opts, 2, seed=1), cuda)
    for _ in range(2):
        train.train_step(state.model, state.optimizer, batch,
                         state.generator)
        state.step += 1
    ckpt_lib.save_checkpoint(str(tmp_path), state, opts)
    other = ckpt_lib.restore_checkpoint(str(tmp_path), fresh(1))
    for (name, a), b in zip(state.model.state_dict().items(),
                            other.model.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), name
    want = state.optimizer.inner.state_dict()["state"]
    got = other.optimizer.inner.state_dict()["state"]
    for i, moments in want.items():
        for key, value in moments.items():
            assert torch.equal(value.cpu(), got[i][key].cpu()), (i, key)
            if key != "step":
                assert got[i][key].device.type == "cuda", (i, key)
    assert (other.step, other.optimizer.count) == (2, 2)
    assert torch.equal(other.generator.get_state(),
                       state.generator.get_state())


def test_scannet_reader_batches_through_device_prefetch(cuda, tmp_path):
    """The ScanNet reader's batches of a scan on disk
    (`testing.write_scannet_scan` at 64x96, 12 frames, 4-view tuples)
    moved to the card by `device_prefetch`: the CPU batches' values, bit
    for bit, and the frame ids passed through."""
    import numpy as np
    from simplerecon_tpu_torch.data.loader import DataLoader, device_prefetch
    from simplerecon_tpu_torch.data.scannet import ScannetDataset
    from simplerecon_tpu_torch.testing import (TUPLE_SUFFIX, synthetic_tuples,
                                               write_scannet_scan,
                                               write_tuples)
    root = str(tmp_path)
    write_scannet_scan(root, 12, 64, 96)
    write_tuples(root, synthetic_tuples(12, 4))
    dataset = ScannetDataset(root, "test", TUPLE_SUFFIX, image_height=64,
                             image_width=96, num_images_in_tuple=4,
                             include_full_res_depth=True,
                             include_full_depth_K=True, pass_frame_id=True)
    batches = list(DataLoader(dataset, batch_size=4, num_workers=2))
    moved = list(device_prefetch(batches, cuda))
    assert len(moved) == len(batches) == 3
    for got, want in zip(moved, batches):
        for part in ("cur", "src"):
            assert list(got[part]) == list(want[part])
            for key, value in want[part].items():
                if isinstance(value, np.ndarray):
                    assert got[part][key].device.type == "cuda", key
                    np.testing.assert_array_equal(
                        got[part][key].cpu().numpy(), value)
                else:
                    assert got[part][key] == value, key


def test_unet_model_on_the_card_matches_the_cpu(cuda):
    """The hero model with the UNet matching encoder, b1 at 192x256
    float32, on the card and on the CPU from the same seeded weights:
    the cost volume and the four log-depth maps within 2% of the CPU
    map's standard deviation (as `chip_smoke.py`'s card-against-CPU
    phases), which must be at least 1e-2; K1 launched once."""
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.online import make_batch
    from simplerecon_tpu_torch.testing import (hero_options, posed_stream,
                                               spread_outputs_)
    opts = hero_options(image_height=192, image_width=256, precision="32",
                        matching_encoder_type="unet_encoder")
    cpu_model = spread_outputs_(build_depth_model(opts, device="cpu",
                                                  seed=5), seed=5)
    gpu_model = build_depth_model(opts, device=cuda, seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    frames = posed_stream(8, 192, 256, seed=3)
    results = {}
    for tag, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        cur, src = make_batch(frames[7], frames[:7], opts.matching_scale,
                              next(model.parameters()).device)
        captured = {}
        model.cost_volume.register_forward_hook(
            lambda mod, args, out: captured.update(volume=out[0]))
        before = launch_counts()["fused_sweep"]
        with torch.no_grad():
            out = model(cur, src)
        assert launch_counts()["fused_sweep"] - before == (tag == "gpu")
        results[tag] = {k: v.cpu() for k, v in out.items()
                        if v is not None}
        results[tag]["cost_volume_bhwd"] = captured["volume"].cpu()
    for key in ["cost_volume_bhwd"] + [f"log_depth_pred_s{i}_bhw1"
                                       for i in range(4)]:
        ref, got = results["cpu"][key], results["gpu"][key]
        std = ref.std().item()
        assert std >= 1e-2, (key, std)
        assert (got - ref).abs().max().item() <= 0.02 * std, key


def test_point_cloud_pass_on_the_card_matches_the_cpu(cuda):
    """The consistency pass over 12 synthetic GT depth maps at 64x96 on
    the card and on the CPU: every reference frame's keep mask differs
    at no more than 1e-4 of its pixels (a projection that lands within
    an ulp of |z - sampled| = z_thresh may fall either way), the kept
    points within 1e-5 m where both keep them."""
    import numpy as np
    from simplerecon_tpu_torch.fusion.point_cloud import fuse_points
    from simplerecon_tpu_torch.testing import synthetic_gt_frames
    frames = synthetic_gt_frames(12, 64, 96)
    args = [np.stack([f[k] for f in frames]) for k in ("world_T_cam", "K",
                                                        "invK")]
    depths = np.stack([f["depth_b1hw"][0] for f in frames])
    cpu = fuse_points(depths, *args, device="cpu")
    gpu = fuse_points(depths, *args, device=cuda)
    for (p_cpu, k_cpu), (p_gpu, k_gpu) in zip(cpu, gpu):
        assert (k_cpu != k_gpu).mean() <= 1e-4
        both = k_cpu & k_gpu
        assert both.sum() > 100
        np.testing.assert_allclose(p_gpu[both], p_cpu[both], rtol=0,
                                   atol=1e-5)
