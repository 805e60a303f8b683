"""The order-free scatter of the sweeps' gradient (`sweep_scatter`'s
plain version, `sweep_scatter_reference`) on the CPU.

On the card `sweep_scatter` sums d_src for K2 and the dot model's
backward as 64-bit fixed-point integers, so that two runs give the same
bits. Its plain version sums the same integers with `index_add_`. Here:

- the fixed-point sums give identical bits whatever the order of the
  contributions (reversed, shuffled, split into chunks);
- they match the float32 `index_add_` scatter that the plain backwards
  keep on the CPU: elementwise |fixed - float| <= 2^-18 * sum |w * d_s|
  + n * 2^-S, where 2^-18 leaves room for float32 sums of up to 64
  contributions (each off by 2^-24 of the running sum) and n * 2^-S
  bounds the rounding of the n contributions to multiples of 2^-S;
- the wrapper's plain version, which projects with proj = K @ src_T_cur
  as the kernels do, matches the plain backwards' d_src (whose taps come
  from `sweep_warp`'s projection) within 1e-5 * max |d_src|: the same
  sums over tap coordinates that round differently.

The kernel is held against this plain version on the card
(tests/test_torch_port_gpu.py, chip_smoke.py phases 6 and 9).
"""

import math

import numpy as np
import pytest
import torch

from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.ops import launch_counts
from simplerecon_tpu_torch.testing import (GEOMETRIES, dot_case,
                                           scatter_case, sweep_cotangent)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

SHAPE = (2, 3, 13, 21, 8, 5)     # b, k, h, w, c, d
GEOMETRY_TOL = 1e-5


def _samples(scale: float, seed: int = 0) -> tuple:
    """Sample gradients (b, k, d, N, c) and pixel coords (b, k, d, N, 2)
    that reach past every border of the (h, w) map."""
    b, k, h, w, c, d = SHAPE
    rng = np.random.RandomState(seed)
    d_s = rng.randn(b, k, d, h * w, c) * scale
    pix = rng.uniform([-2.0, -2.0], [w + 2.0, h + 2.0], (b, k, d, h * w, 2))
    return (torch.from_numpy(d_s.astype(np.float32)),
            torch.from_numpy(pix.astype(np.float32)))


def _fixed(d_s, pix, max_abs, count) -> torch.Tensor:
    b, k, _, _, c = d_s.shape
    h, w = SHAPE[2:4]
    shift = cuda_cv.fixed_point_shift(max_abs, count)
    acc = torch.zeros((b * k * h * w, c), dtype=torch.int64)
    cuda_cv._scatter_taps_fixed_(acc, d_s, pix, h, w, shift)
    return cuda_cv._fixed_to_float(acc, max_abs, shift)


def _reordered(d_s, pix, order: str) -> list:
    """(d_s, pix) pieces holding the same contributions in another
    order."""
    flat_s = d_s.flatten(2, 3)
    flat_p = pix.flatten(2, 3)
    size = flat_s.shape[2]
    if order == "chunked":
        cut = size // 3
        return [(flat_s[:, :, i:j, None], flat_p[:, :, i:j, None])
                for i, j in ((cut, size), (0, cut))]
    perm = (torch.arange(size - 1, -1, -1) if order == "reversed"
            else torch.from_numpy(np.random.RandomState(1).permutation(size)))
    return [(flat_s[:, :, perm, None], flat_p[:, :, perm, None])]


@pytest.mark.parametrize("order", ["reversed", "shuffled", "chunked"])
def test_fixed_point_sums_do_not_depend_on_the_order(order):
    d_s, pix = _samples(1.0)
    b, k, h, w, c, d = SHAPE
    max_abs, count = d_s.abs().max().item(), 4 * d * h * w
    want = _fixed(d_s, pix, max_abs, count)
    shift = cuda_cv.fixed_point_shift(max_abs, count)
    acc = torch.zeros((b * k * h * w, c), dtype=torch.int64)
    floats = torch.zeros((b * k * h * w, c))
    for part_s, part_p in _reordered(d_s, pix, order):
        cuda_cv._scatter_taps_fixed_(acc, part_s, part_p, h, w, shift)
        cuda_cv._scatter_taps_(floats, part_s, part_p, h, w)
    got = cuda_cv._fixed_to_float(acc, max_abs, shift)
    assert torch.equal(got, want)
    # the float32 sums of the same contributions do depend on the order
    in_order = torch.zeros((b * k * h * w, c))
    cuda_cv._scatter_taps_(in_order, d_s, pix, h, w)
    assert not torch.equal(floats, in_order)


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20],
                         ids=["unit", "tiny", "huge"])
def test_fixed_point_sums_match_index_add(scale):
    d_s, pix = _samples(scale, seed=2)
    b, k, h, w, c, d = SHAPE
    max_abs, count = d_s.abs().max().item(), 4 * d * h * w
    got = _fixed(d_s, pix, max_abs, count)
    want = torch.zeros((b * k * h * w, c))
    cuda_cv._scatter_taps_(want, d_s, pix, h, w)
    abs_sum = torch.zeros((b * k * h * w, c), dtype=torch.float64)
    cuda_cv._scatter_taps_(abs_sum, d_s.abs().double(), pix, h, w)
    contributions = torch.zeros(b * k * h * w, dtype=torch.float64)
    for idx, wgt in cuda_cv._taps(pix, h, w):
        contributions.index_add_(0, idx.reshape(-1),
                                 (wgt > 0).double().reshape(-1))
    assert contributions.max() <= 64
    shift = cuda_cv.fixed_point_shift(max_abs, count)
    limit = 2.0 ** -18 * abs_sum + contributions[:, None] * 2.0 ** -shift
    diff = (got.double() - want.double()).abs()
    assert (diff <= limit).all(), (diff - limit).max()
    assert want.abs().max() > 0.1 * scale


@pytest.mark.parametrize("mode", ["samples", "dot"])
def test_scatter_reference_matches_the_plain_backwards(mode):
    b, k, h, w, c, d = SHAPE
    src, cur, extr, Ks, invK, planes = dot_case(*SHAPE, dtype=torch.float32,
                                                device="cpu", seed=3)
    proj = Ks @ extr
    warp = cv_ops.sweep_warp(src, extr, Ks, invK, planes)
    want = torch.zeros((b * k * h * w, c))
    if mode == "dot":
        # the dot backward's d_src: the transpose of m * cur, m = mask * g
        g = sweep_cotangent(b, d, h * w, "cpu", seed=4)
        m = warp.mask_bkdN * g[:, None]
        cuda_cv._scatter_taps_(want, m[..., None] * cur[:, None, None],
                               warp.pix_bkdN2, h, w)
        bound = (g.abs().amax() * cur.abs().amax()).reshape(1)
        got = cuda_cv.sweep_scatter_reference(proj, invK, planes, bound, h,
                                              w, g_bdN=g, cur_bNc=cur)
        # which is what the dot backward returns on the CPU
        assert torch.equal(got, cuda_cv.dot_sweep_backward(
            src, cur, extr, Ks, invK, planes, g)[0])
    else:
        d_s = _samples(1.0, seed=5)[0]
        cuda_cv._scatter_taps_(want, d_s, warp.pix_bkdN2, h, w)
        got = cuda_cv.sweep_scatter_reference(proj, invK, planes,
                                              d_s.abs().max(), h, w,
                                              d_s_bkdNc=d_s)
    want = want.reshape(b, k, h, w, c)
    assert got.shape == (b, k, h, w, c) and got.dtype == torch.float32
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= GEOMETRY_TOL * scale


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_scatter_reference_bits_do_not_depend_on_the_order(geometry):
    """The wrapper's plain version on `scatter_case`'s sample gradients,
    with cameras far apart ("wide") and as close as in training
    ("close", where neighbouring pixels and consecutive planes share
    taps): the same bits as the same integers summed over the planes in
    reverse and over the pixels shuffled."""
    b, k, h, w, c, d = SHAPE
    args, grads = scatter_case(*SHAPE, dtype=torch.float32, device="cpu",
                               seed=8, geometry=geometry)
    proj, invK, planes, bound, _, _ = args
    d_s = grads["d_s_bkdNc"]
    got = cuda_cv.sweep_scatter_reference(*args, **grads)
    shift = cuda_cv.fixed_point_shift(bound.item(), 4 * d * h * w)
    pix = cuda_cv._project(proj, invK, planes, h, w)[0]
    perm = torch.from_numpy(np.random.RandomState(9).permutation(h * w))
    acc = torch.zeros((b * k * h * w, c), dtype=torch.int64)
    shared = torch.zeros(b * k * h * w)
    for di in reversed(range(d)):
        sl = slice(di, di + 1)
        cuda_cv._scatter_taps_fixed_(acc, d_s[:, :, sl][:, :, :, perm],
                                     pix[:, :, sl][:, :, :, perm], h, w,
                                     shift)
        for idx, wgt in cuda_cv._taps(pix[:, :, sl], h, w):
            shared.index_add_(0, idx.reshape(-1),
                              (wgt > 0).float().reshape(-1))
    want = cuda_cv._fixed_to_float(acc, bound.item(), shift)
    assert torch.equal(got, want.reshape(b, k, h, w, c))
    if geometry == "close":
        # most taps land inside the image, each reached from several
        # samples
        assert (shared > 0).float().mean() > 0.9
        assert shared.max() >= 4 * d


def test_scatter_wrapper_runs_its_plain_version_on_the_cpu():
    b, k, h, w, c, d = SHAPE
    _, cur, extr, Ks, invK, planes = dot_case(*SHAPE, dtype=torch.float32,
                                              device="cpu", seed=6)
    g = sweep_cotangent(b, d, h * w, "cpu", seed=7)
    bound = torch.tensor([4.0])
    before = launch_counts()["sweep_scatter"]
    got = cuda_cv.sweep_scatter(Ks @ extr, invK, planes, bound, h, w,
                                g_bdN=g, cur_bNc=cur)
    assert launch_counts()["sweep_scatter"] == before
    want = cuda_cv.sweep_scatter_reference(Ks @ extr, invK, planes, bound, h,
                                           w, g_bdN=g, cur_bNc=cur)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="takes d_s_bkdNc, or"):
        cuda_cv.sweep_scatter(Ks @ extr, invK, planes, bound, h, w,
                              d_s_bkdNc=torch.zeros(b, k, d, h * w, c),
                              g_bdN=g, cur_bNc=cur)
    # a bound that is not finite has no fixed-point form: NaN, as a
    # float32 sum of a non-finite gradient would give
    nan = cuda_cv.sweep_scatter(Ks @ extr, invK, planes,
                                torch.tensor([math.inf]), h, w, g_bdN=g,
                                cur_bNc=cur)
    assert torch.isnan(nan).all()


@pytest.mark.parametrize("max_abs, count, shift", [
    (1.0, 1, 61),            # 1 < 2^1, count <= 2^0
    (0.75, 4, 60),           # 0.75 < 2^0, count <= 2^2
    (3.0, 5, 57),            # 3 < 2^2, count <= 2^3
    (0.0, 10, 0),
    (math.nan, 10, 0),
    (1e-30, 8, 100),         # clamped: 2^S stays a normal float32
    (1e30, 2 ** 40, -78),    # 1e30 < 2^100, count <= 2^40
])
def test_fixed_point_shift(max_abs, count, shift):
    assert cuda_cv.fixed_point_shift(max_abs, count) == shift
