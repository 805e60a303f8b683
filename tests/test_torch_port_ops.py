"""The port's geometry, sampling, plane sweep and feature volume against
the JAX package, on the CPU in float32.

Inputs are made with numpy from a seed and handed to both packages. JAX
runs under `default_matmul_precision("highest")`; its Pallas sweep kernel
runs in interpret mode, as tests/test_pallas_cv.py runs it.

Tolerances: geometry and sampling atol 1e-6 at O(1) magnitudes (float32
rounding of the same expressions in another order), scaled by the
magnitude for projected coordinates, and 1e-5 for features warped at
those coordinates; the fused sweep's
plain version atol/rtol 2e-4, the tolerance tests/test_pallas_cv.py
holds the JAX kernel to against the XLA path (a 202 -> 128 -> 128 -> 1
MLP summed in another order over bilinear taps whose coordinates round
differently); `lowest_cost` 1e-5 (a plane depth picked by argmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.cost_volume import \
    MLPFeatureVolume as JaxMLPFeatureVolume
from simplerecon_tpu.ops import cost_volume as jcv
from simplerecon_tpu.ops import geometry as jgeo
from simplerecon_tpu.ops import pallas_cv
from simplerecon_tpu.ops import sampling as jsampling
from simplerecon_tpu_torch.models.cost_volume import MLPFeatureVolume
from simplerecon_tpu_torch.ops import cost_volume as tcv
from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.ops import launch_counts
from simplerecon_tpu_torch.ops import geometry as tgeo
from simplerecon_tpu_torch.ops import sampling as tsampling
from simplerecon_tpu_torch.utils.weights import jax_to_state_dict

GEO_ATOL = 1e-6
SWEEP_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Tier-1 runs several test workers on one machine; torch's default
    of a thread per core oversubscribes it and slows small ops tenfold.
    Module-scoped, so that it holds in a module's fixtures too (pytest
    sets up fixtures of a wider scope first: a function-scoped one came
    after them, and a port CLI run in a module fixture took 69 s with 8
    threads in a run of 6 workers, 9 s with 2).

    It also hands torch's global random state back as it found it: the
    port's modules draw their default init from it before the seeded
    redraw, and a later test in the same worker that builds a model from
    the global state (`tests/test_full_model_golden.py`) would otherwise
    see a state that depends on which port files ran before it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(torch_out, jax_out, atol, rtol=0.0):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), atol=atol, rtol=rtol)


def _rot(axis, angle):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = m[j, j] = c
    m[i, j], m[j, i] = -s, s
    return m


def sweep_geometry(b, k, h, w, seed, wide=False):
    """src_cam_T_cur_cam extrinsics, cur_cam_T_src_cam poses, source K and
    reference invK. `wide` adds large rotations and a camera turned
    around, so epipolar lines span the whole image height, many taps
    fall off the image and some points land behind a source camera."""
    rng = np.random.RandomState(seed)
    extr = np.zeros((b, k, 4, 4))
    for bi in range(b):
        for vi in range(k):
            ang = (0.6 if wide else 0.05) * (vi + 1)
            m = (_rot(0, rng.uniform(-ang, ang))
                 @ _rot(1, rng.uniform(-ang, ang)))
            if wide and vi == k - 1:
                m = _rot(1, 2.2) @ m
            m[:3, 3] = rng.uniform(-0.3, 0.3, 3) * (3.0 if wide else 1.0)
            extr[bi, vi] = m
    poses = np.linalg.inv(extr)
    K = np.eye(4)
    K[0, 0], K[1, 1] = 0.9 * w, 1.1 * h
    K[0, 2], K[1, 2] = w / 2 - 0.3, h / 2 + 0.2
    Ks = np.broadcast_to(K, (b, k, 4, 4))
    invK = np.broadcast_to(np.linalg.inv(K), (b, 4, 4))
    return [np.ascontiguousarray(a, np.float32)
            for a in (extr, poses, Ks, invK)]


# --------------------------------------------------------------------------
# geometry and sampling
# --------------------------------------------------------------------------

def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    _close(tgeo.pixel_grid(5, 7), jgeo.pixel_grid(5, 7), 0.0)

    pts = rng.uniform(-1, 1, (2, 3, 50, 3)).astype(np.float32)
    pts[..., 2] += 2.0
    pts[0, 0, :5, 2] = 0.0            # exercises the eps-safe divide
    pts[0, 1, :5, 2] = -1.0           # behind the camera
    K = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    K[..., 0, 0] = K[..., 1, 1] = 0.8
    K[..., 0, 2], K[..., 1, 2] = 0.1, -0.05
    T = np.stack([[_rot(1, 0.1 * i) for i in range(3)]] * 2).astype(np.float32)
    T[..., :3, 3] = rng.uniform(-0.2, 0.2, (2, 3, 3))
    _close(tgeo.project_points(_t(pts), _t(K), _t(T)),
           jgeo.project_points(pts, K, T), GEO_ATOL)

    v = rng.randn(4, 10, 3).astype(np.float32)
    v[0, 0] = 0.0
    _close(tgeo.normalize(_t(v)), jgeo.normalize(v), GEO_ATOL)
    _close(tgeo.cosine_similarity(_t(v), _t(v[::-1].copy())),
           jgeo.cosine_similarity(v, v[::-1]), GEO_ATOL)

    poses = T.copy()
    poses[0, 0] = np.eye(4)           # identity: the clamped sqrt
    for got, want in zip(tgeo.pose_distance(_t(poses)),
                         jgeo.pose_distance(poses)):
        _close(got, want, GEO_ATOL)


def test_sampling_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2, 9, 13, 4)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 200, 2)).astype(np.float32)
    _close(tsampling.grid_sample(_t(img), _t(grid)),
           jsampling.grid_sample(jnp.asarray(img), jnp.asarray(grid)),
           GEO_ATOL)
    up = tsampling.upsample2x(_t(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(up, jsampling.upsample2x(jnp.asarray(img)), GEO_ATOL)


def test_sweep_primitives_match_jax():
    b, k, h, w, c, d = 2, 3, 8, 12, 4, 5
    rng = np.random.RandomState(2)
    src = rng.uniform(-1, 1, (b, k, h, w, c)).astype(np.float32)
    extr, _, Ks, invK = sweep_geometry(b, k, h, w, seed=2, wide=True)
    planes = np.asarray(jcv.generate_depth_planes(b, d, 0.25, 5.0))
    _close(tcv.generate_depth_planes(b, d, 0.25, 5.0), planes, GEO_ATOL)

    got = tcv.sweep_warp(_t(src), _t(extr), _t(Ks), _t(invK), _t(planes))
    want = jcv.sweep_warp(src, extr, Ks, invK, planes, backend="gather")
    for name in ("world_points_bdN3", "depths_bkdN", "pix_bkdN2"):
        scale = np.abs(np.asarray(getattr(want, name))).max()
        _close(getattr(got, name), getattr(want, name), GEO_ATOL * scale)
    _close(got.mask_bkdN, want.mask_bkdN, 0.0)
    # pixel coords up to ~40 px carry float32 rounding of ~4e-6 px, which
    # moves a bilinear sample by that times the feature gradient (<= 2)
    _close(got.sampled_bkdNc, want.sampled_bkdNc, 1e-5)

    mask = tcv.overall_source_mask(got, h, w)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jcv.overall_source_mask(want, h, w)))
    assert 0 < mask.float().mean() < 1

    vol = rng.randn(b, h, w, d).astype(np.float32)
    _close(tcv.lowest_cost_depth(_t(vol), _t(planes)),
           jcv.lowest_cost_depth(vol, planes), 0.0)


# --------------------------------------------------------------------------
# K1's plain version against the JAX Pallas kernel
# --------------------------------------------------------------------------

def sweep_inputs(b, k, h, w, c, d, seed, wide=False):
    rng = np.random.RandomState(seed)
    extr, poses, Ks, invK = sweep_geometry(b, k, h, w, seed, wide)
    penalty, r, t = (np.asarray(x) for x in jgeo.pose_distance(poses))
    cin = cuda_cv.mlp_in_channels(k, c)

    def dense(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    return dict(
        src=rng.randn(b, k, h, w, c).astype(np.float32),
        cur=rng.randn(b, h * w, c).astype(np.float32),
        extr=extr, Ks=Ks, invK=invK,
        planes=np.ascontiguousarray(
            np.asarray(jcv.generate_depth_planes(b, d, 0.25, 5.0))),
        pose_meta=np.stack([penalty, r, t], -1).astype(np.float32),
        src_loc=np.ascontiguousarray(poses[..., :3, 3]),
        w0=dense(cin, 128), b0=(0.1 * rng.randn(128)).astype(np.float32),
        w1=dense(128, 128), b1=(0.1 * rng.randn(128)).astype(np.float32),
        w2=dense(128, 1), b2=(0.1 * rng.randn(1)).astype(np.float32))


ORDER = ("src", "cur", "extr", "Ks", "invK", "planes", "pose_meta",
         "src_loc", "w0", "b0", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("wide", [False, True], ids=["banded", "full_height"])
def test_fused_sweep_reference_matches_jax_kernel(wide):
    b, k, h, w, c, d = 2, 3, 16, 32, 16, 6
    bands = (4, 8)
    inp = sweep_inputs(b, k, h, w, c, d, seed=3, wide=wide)
    args = [inp[n] for n in ORDER]

    # which tier of the JAX kernel these inputs take
    prep = pallas_cv._banded_prep(
        jnp.asarray(inp["src"]), jnp.asarray(inp["cur"]), inp["Ks"],
        inp["extr"], inp["invK"], inp["planes"], jnp.float32, 4, 128, bands)
    fits = [bool(f) for f in prep["fits"]]
    assert (not any(fits)) if wide else fits[-1], fits

    with jax.default_matmul_precision("highest"):
        want = pallas_cv.banded_warp_feature_volume(
            *[jnp.asarray(a) for a in args], bands=bands, interpret=True)
    got = cuda_cv.fused_sweep(*[_t(a) for a in args])
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    _close(got, want, SWEEP_TOL, SWEEP_TOL)
    assert np.asarray(want).std() > 1e-2


def test_fused_sweep_wrapper_uses_plain_version_only_on_cpu():
    inp = sweep_inputs(1, 2, 4, 8, 4, 3, seed=4)
    args = [_t(inp[n]) for n in ORDER]
    before = launch_counts()["fused_sweep"]
    torch.testing.assert_close(cuda_cv.fused_sweep(*args),
                               cuda_cv.fused_sweep_reference(*args),
                               rtol=0, atol=0)
    assert launch_counts()["fused_sweep"] == before   # no kernel launched
    with pytest.raises(ValueError):
        cuda_cv.fused_sweep(*[a.to("meta") for a in args])


# --------------------------------------------------------------------------
# MLPFeatureVolume
# --------------------------------------------------------------------------

def test_mlp_feature_volume_matches_jax():
    b, k, h, w, c, d = 2, 3, 16, 32, 16, 6
    rng = np.random.RandomState(5)
    cur = rng.randn(b, h, w, c).astype(np.float32)
    src = rng.randn(b, k, h, w, c).astype(np.float32)
    extr, poses, Ks, invK = sweep_geometry(b, k, h, w, seed=5, wide=True)

    jmod = JaxMLPFeatureVolume(num_depth_bins=d, num_source_views=k,
                               matching_dim_size=c,
                               backend="pallas_interpret", dtype=jnp.float32)
    # the module's only parameters, its MLP's three layers, drawn as
    # flax's default init draws them (no init is traced or compiled)
    widths = (cuda_cv.mlp_in_channels(k, c), 128, 128, 1)
    params = {"mlp": {f"dense{i}": {
        "kernel": (rng.randn(widths[i], widths[i + 1])
                   / np.sqrt(widths[i])).astype(np.float32),
        "bias": np.zeros(widths[i + 1], np.float32)} for i in range(3)}}
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda *a: jmod.apply(
            {"params": params}, *a, return_mask=True))(
                cur, src, extr, poses, Ks, invK)

    tmod = MLPFeatureVolume(num_depth_bins=d, num_source_views=k,
                            matching_dim_size=c)
    sd = jax_to_state_dict({"cost_volume": params}, {})
    tmod.load_state_dict({key.removeprefix("cost_volume."): _t(v)
                          for key, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmod(_t(cur), _t(src), _t(extr), _t(poses), _t(Ks), _t(invK),
                   return_mask=True)

    vol_t, low_t, planes_t, mask_t = got
    vol_j, low_j, planes_j, mask_j = want
    _close(vol_t, vol_j, SWEEP_TOL, SWEEP_TOL)
    _close(low_t, low_j, 1e-5, 1e-5)
    _close(planes_t, planes_j, GEO_ATOL)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert 0 < mask_t.float().mean() < 1


def test_kernel_library_name_follows_the_sources(tmp_path, monkeypatch):
    from simplerecon_tpu_torch.ops import _build

    for src in _build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    name = _build.library_path().name
    assert name == _build.library_path().name
    cu = tmp_path / "fused_sweep.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _build.library_path().name != name

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.find_nvcc()


@pytest.mark.parametrize("mode, pads, hw", [
    ("reflect", (1, 2, 1, 2), (6, 7)), ("reflect", (1, 2, 2, 1), (4, 3)),
    ("replicate", (1, 1, 1, 1), (6, 7)), ("replicate", (2, 0, 3, 1), (6, 7))],
    ids=["reflect", "reflect_small", "replicate", "replicate_uneven"])
def test_fixed_order_pad_matches_f_pad(mode, pads, hw):
    """`pad_edges` gives F.pad's values bit for bit, and its backward
    F.pad's to float64 rounding (another order of the same sums); on a
    map whose two borders copy the same elements too."""
    from simplerecon_tpu_torch.ops.image import pad_edges
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 3, *hw))
    x.requires_grad_(True)
    want = torch.nn.functional.pad(x, pads, mode=mode)
    got = pad_edges(x, pads, mode)
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.RandomState(1).randn(*want.shape))
    np.testing.assert_allclose(torch.autograd.grad(got, x, g)[0].numpy(),
                               torch.autograd.grad(want, x, g)[0].numpy(),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 1)],
                         ids=["odd", "one_pixel"])
def test_fixed_order_upsample_backward_matches_interpolate(shape):
    """`upsample2x` is F.interpolate's bilinear x2 forward, bit for bit,
    with its transpose as two fixed stencils: within float64 rounding of
    F.interpolate's backward."""
    x = torch.from_numpy(np.random.RandomState(2).randn(*shape))
    x.requires_grad_(True)
    want = torch.nn.functional.interpolate(x, scale_factor=2,
                                           mode="bilinear",
                                           align_corners=False)
    got = tsampling.upsample2x(x)
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.RandomState(3).randn(*want.shape))
    np.testing.assert_allclose(torch.autograd.grad(got, x, g)[0].numpy(),
                               torch.autograd.grad(want, x, g)[0].numpy(),
                               rtol=0, atol=1e-12)
