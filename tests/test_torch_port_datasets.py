"""The port's file-backed dataset readers against the JAX package's, on
the CPU, over small scans written from a seed in each layout (the JAX
tests' writers where they are functions: `test_data.make_scannet_fixture`
and `make_vdr_fixture`, `test_sens_reader.write_fake_sens`; the others as
`test_more_datasets.py` writes them inline).

Items (`__getitem__` of the test and the train split, the train split's
colour jitter and flips drawn from the same seeded `RandomState`), key
for key: poses, intrinsics, masks, depth and frame ids equal
(`np.testing.assert_array_equal`, dtypes too); colour, after the imagenet
normalisation, within a tolerance in [0, 1] units divided by the
smallest imagenet std: 0 for PNG colour at its size, 1/255 for resized
PNG colour (Pillow's BILINEAR on the same pixels, rounded to 8 bits) and
2/255 for resized JPEG colour (a decode a level off, then the resize).
Measured: 0 everywhere here, the port's decoder and resamplers giving
Pillow's bits. The valid-frame lists are equal too.

The `.sens` reader's header, frames, depth, colour and exports are
Pillow's and the JAX reader's; its colour re-export writes JPEGs whose
decoded pixels (Pillow's decoder) are the JAX method's, at the frames'
size and resized.

The CPU twin of `chip_smoke.py` phase 25: the eval CLI at 64x96 over the
synthetic scene written in ScanNet's layout gives the cached depths it
gives over the synthetic dataset, bit for bit (the model's inputs are the
same bits).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from simplerecon_tpu.data.registry import get_dataset as jax_get_dataset
from simplerecon_tpu_torch.data.registry import get_dataset
from test_data import make_scannet_fixture, make_vdr_fixture
from test_torch_port_ops import few_torch_threads  # noqa: F401

H, W = 64, 96
NAMES = ["scannet", "7scenes", "vdr", "arkit", "colmap", "scanniverse"]
# the colour tolerance in [0, 1] by layout (see the docstring)
COLOUR_TOL = {"scannet": 2 / 255, "7scenes": 1 / 255, "vdr": 2 / 255,
              "arkit": 1 / 255, "colmap": 2 / 255, "scanniverse": 2 / 255}
COLOUR_KEYS = ("image_b3hw", "high_res_color_b3hw")
IMAGENET_STD_MIN = 0.224


def _tuples(root, scan, ids, suffix="_tuple.txt"):
    tdir = os.path.join(root, "tuples")
    os.makedirs(tdir, exist_ok=True)
    for split in ("test", "train"):
        with open(os.path.join(tdir, f"{split}{suffix}"), "w") as f:
            f.write(f"{scan} {' '.join(ids)}\n{scan} "
                    f"{' '.join(ids[1:] + ids[:1])}\n")


def _noise(rng, h, w):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def write_scannet(root):
    """`make_scannet_fixture` (JPEG colour, 16-bit depth), with colour
    cached as PNGs at the loaded size for two of the frames and the
    test split's folder linked to the train split's."""
    make_scannet_fixture(root)
    scan = "scene0000_00"
    sensor = os.path.join(root, "scans", scan, "sensor_data")
    rng = np.random.RandomState(11)
    for i in (0, 1):
        Image.fromarray(_noise(rng, H, W)).save(
            os.path.join(sensor, f"frame-{i:06d}.color.{W}.png"))
    os.symlink("scans", os.path.join(root, "scans_test"))
    return scan, "_eight_view_deepvmvs.txt"


def write_seven_scenes(root):
    scan = "chess/seq-01"
    sdir = os.path.join(root, scan)
    os.makedirs(sdir)
    rng = np.random.RandomState(0)
    for i in range(3):
        fid = f"{i:06d}"
        Image.fromarray(_noise(rng, 480, 640)).save(
            os.path.join(sdir, f"frame-{fid}.color.png"))
        depth = (rng.rand(480, 640) * 3000 + 500).astype(np.uint16)
        depth[::7, ::5] = 0
        Image.fromarray(depth).save(
            os.path.join(sdir, f"frame-{fid}.depth.proj.png"))
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        np.savetxt(os.path.join(sdir, f"frame-{fid}.pose.txt"), pose)
    _tuples(root, scan, ["000000", "000001", "000002"])
    return scan, "_tuple.txt"


def write_arkit(root):
    """Images wider than 4:3, so the reader's centre crop runs."""
    scan = "scan0"
    sdir = os.path.join(root, "scans", scan)
    for d in ("images", "poses", "intrinsics"):
        os.makedirs(os.path.join(sdir, d))
    rng = np.random.RandomState(0)
    for i in range(3):
        fid = f"{i:06d}"
        Image.fromarray(_noise(rng, 480, 700)).save(
            os.path.join(sdir, "images", f"{fid}.png"))
        pose = np.eye(4)
        pose[1, 3] = 0.1 * i
        np.savetxt(os.path.join(sdir, "poses", f"{fid}.txt"), pose)
        np.savetxt(os.path.join(sdir, "intrinsics", f"{fid}.txt"),
                   np.array([500.0, 500.0, 320.0, 240.0, 640, 480]))
    _tuples(root, scan, ["000000", "000001", "000002"])
    return scan, "_tuple.txt"


def write_colmap(root):
    scan = "scan0"
    sparse = os.path.join(root, "scans", scan, "undistorted", "sparse")
    os.makedirs(os.path.join(sparse, "images_low_res"))
    rng = np.random.RandomState(0)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# cameras\n1 PINHOLE 640 480 500.0 505.0 320.0 240.0\n")
    lines = ["# images"]
    for i in range(3):
        name = f"img{i}"
        Image.fromarray(_noise(rng, 48, 64)).save(
            os.path.join(sparse, "images_low_res", f"{name}.JPG"),
            quality=85)
        q = np.array([1.0, 0.05 * i, -0.02 * i, 0.01])
        q /= np.linalg.norm(q)
        lines.append(f"{i + 1} {' '.join(str(v) for v in q)} {0.1 * i} 0 0 "
                     f"1 {name}.JPG")
        lines.append("0 0 -1")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    _tuples(root, scan, ["img0", "img1", "img2"])
    return scan, "_tuple.txt"


def write_scanniverse(root):
    scan = "scan0"
    sdir = os.path.join(root, "scans", scan)
    os.makedirs(sdir)
    rng = np.random.RandomState(0)
    blocks = []
    for i in range(3):
        Image.fromarray(_noise(rng, 48, 64)).save(
            os.path.join(sdir, f"IMG_{i}.jpg"), subsampling=1)
        q = np.array([0.03 * i, 0.1, -0.02, 1.0])
        q /= np.linalg.norm(q)
        blocks.append(f"""frames {{
  id: {i}
  camera {{
    width: 640
    height: 480
    f: 500.0
    px: 322.5
    py: 241.0
  }}
  pose {{
    rotation: [{q[0]}, {q[1]}, {q[2]}, {q[3]}] translation: [{0.1 * i}, 0, 0]
  }}
}}""")
    with open(os.path.join(sdir, "frames.txt"), "w") as f:
        f.write("\n".join(blocks) + "\n")
    _tuples(root, scan, ["0", "1", "2"])
    return scan, "_tuple.txt"


def write_vdr(root):
    make_vdr_fixture(root)
    scan = "vdr0"
    _tuples(root, scan, ["0", "1", "2"])
    conf = np.fromfile(os.path.join(root, "scans", scan, "confidence_1.bin"),
                       np.uint8).reshape(192, 256)
    conf[::3, ::4] = 0
    conf.tofile(os.path.join(root, "scans", scan, "confidence_1.bin"))
    return scan, "_tuple.txt"


WRITERS = {"scannet": write_scannet, "7scenes": write_seven_scenes,
           "vdr": write_vdr, "arkit": write_arkit, "colmap": write_colmap,
           "scanniverse": write_scanniverse}


def assert_items_equal(got, want, colour_tol, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for key in want:
            tol = colour_tol if key in COLOUR_KEYS else 0.0
            assert_items_equal(got[key], want[key], tol, f"{where}/{key}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_items_equal(g, w, colour_tol, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        if colour_tol:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=where,
                                       atol=colour_tol / IMAGENET_STD_MIN)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", NAMES)
def test_registered_reader_gives_the_jax_items(name, tmp_path):
    """`get_dataset(name)` gives the port's reader; its items of the test
    and the train split and its valid frames are the JAX reader's."""
    root = str(tmp_path)
    scan, suffix = WRITERS[name](root)
    cls, scans = get_dataset(name, None, scan, verbose=False)
    jax_cls, _ = jax_get_dataset(name, None, scan, verbose=False)
    assert cls.__module__.startswith("simplerecon_tpu_torch.data.")
    assert cls.__name__ == jax_cls.__name__ and scans == [scan]
    has_depth = name in ("scannet", "7scenes", "vdr")
    for split in ("test", "train"):
        kw = dict(dataset_path=root, split=split, mv_tuple_file_suffix=suffix,
                  tuple_info_file_location=os.path.join(root, "tuples"),
                  image_height=H, image_width=W, include_full_depth_K=True,
                  include_full_res_depth=has_depth,
                  include_high_res_color=name == "scannet",
                  pass_frame_id=True)
        port = cls(**kw, rng=np.random.RandomState(7))
        ref = jax_cls(**kw, rng=np.random.RandomState(7))
        assert len(port) == len(ref) == 2
        for i in range(len(ref)):
            for _ in range(2 if split == "train" else 1):  # flips, jitter
                assert_items_equal(port[i], ref[i], COLOUR_TOL[name],
                                   f"{split} item {i}")
        assert port.get_valid_frame_ids(split, scan, store_computed=False) \
            == ref.get_valid_frame_ids(split, scan, store_computed=False)


def test_unknown_dataset_names_raise():
    with pytest.raises(ValueError, match="unknown dataset 'nope'"):
        get_dataset("nope")


def test_sens_reader_is_the_jax_reader(tmp_path):
    from simplerecon_tpu.data.sens_reader import SensorData as JaxSensorData
    from simplerecon_tpu_torch.data import codec
    from simplerecon_tpu_torch.data.sens_reader import SensorData
    from test_sens_reader import write_fake_sens
    path = str(tmp_path / "scan.sens")
    depths = write_fake_sens(path, n_frames=3, color_hw=(48, 64),
                             depth_hw=(24, 32))
    port, ref = SensorData(path), JaxSensorData(path)
    for key in ("sensor_name", "color_compression_type",
                "depth_compression_type", "color_width", "color_height",
                "depth_width", "depth_height", "depth_shift"):
        assert getattr(port, key) == getattr(ref, key), key
    for key in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
                "extrinsic_depth"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key))
    for fp, fr in zip(port.frames, ref.frames):
        np.testing.assert_array_equal(fp.camera_to_world, fr.camera_to_world)
        assert fp.decompress_depth(port.depth_compression_type) \
            == fr.decompress_depth(ref.depth_compression_type)
        np.testing.assert_array_equal(
            fp.decompress_color(port.color_compression_type),
            fr.decompress_color(ref.color_compression_type))
    for size in (None, (16, 20)):
        out = {}
        for tag, sd in (("port", port), ("jax", ref)):
            out[tag] = str(tmp_path / f"{tag}_{size}")
            sd.export_depth_images(os.path.join(out[tag], "sensor_data"),
                                   image_size=size)
            sd.export_poses(os.path.join(out[tag], "sensor_data"))
            sd.export_color_images(os.path.join(out[tag], "sensor_data"),
                                   image_size=size)
            sd.export_intrinsics(os.path.join(out[tag], "intrinsic"))
        for sub in ("sensor_data", "intrinsic"):
            names = sorted(os.listdir(os.path.join(out["jax"], sub)))
            assert sorted(os.listdir(os.path.join(out["port"], sub))) == names
            for n in names:
                got = os.path.join(out["port"], sub, n)
                want = os.path.join(out["jax"], sub, n)
                if n.endswith(".jpg"):
                    pixels = np.asarray(Image.open(got))
                    assert pixels.shape == ((48, 64) if size is None
                                            else size) + (3,)
                    np.testing.assert_array_equal(
                        pixels, np.asarray(Image.open(want)))
                elif n.endswith(".png"):
                    pixels = np.asarray(Image.open(got))
                    assert pixels.dtype == np.uint16
                    np.testing.assert_array_equal(pixels,
                                                  np.asarray(Image.open(want)))
                    np.testing.assert_array_equal(codec.read_image(got),
                                                  pixels)
                else:
                    with open(got) as g, open(want) as w:
                        assert g.read() == w.read(), n
    np.testing.assert_array_equal(
        codec.read_image(str(tmp_path / "port_None" / "sensor_data"
                             / "frame-000002.depth.png")), depths[2])


def test_written_scan_is_read_back_as_the_synthetic_scene(tmp_path):
    """`testing.write_scannet_scan`: the ScanNet reader gives the synthetic
    dataset's colour, poses and intrinsics bit for bit; its depth,
    sampled from the 5/4-size render by Pillow's nearest neighbour where
    the synthetic dataset strides through the image-size render, agrees
    where both hit the room: median within 1 cm, everywhere within 5%
    (a slanted wall, a pixel's width apart)."""
    from simplerecon_tpu_torch.data.scannet import ScannetDataset
    from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
    from simplerecon_tpu_torch.testing import (SCAN_ID, TUPLE_SUFFIX,
                                               synthetic_tuples,
                                               write_scannet_scan,
                                               write_tuples)
    root = str(tmp_path)
    write_scannet_scan(root, num_frames=9, image_height=H, image_width=W)
    write_tuples(root, synthetic_tuples(9, 4))
    scan = ScannetDataset(root, "test", TUPLE_SUFFIX, image_height=H,
                          image_width=W, num_images_in_tuple=4,
                          include_full_res_depth=True,
                          include_full_depth_K=True)
    synth = SyntheticDataset(num_frames=9, image_height=H, image_width=W,
                             num_images_in_tuple=4, split="test")
    assert len(scan) == len(synth) == 6
    for i in range(len(scan)):
        (cur, src), (want_cur, want_src) = scan[i], synth[i]
        for got, want in ((cur, want_cur), (src, want_src)):
            for key in ("image_b3hw", "world_T_cam_b44", "cam_T_world_b44",
                        *[f"{k}_s{s}_b44" for k in ("K", "invK")
                          for s in range(5)]):
                np.testing.assert_array_equal(got[key], want[key], key)
            both = got["mask_b_b1hw"] & want["mask_b_b1hw"]
            assert both.mean() > 0.5
            diff = np.abs(got["depth_b1hw"] - want["depth_b1hw"])[both]
            assert np.median(diff) < 0.01
            np.testing.assert_allclose(got["depth_b1hw"][both],
                                       want["depth_b1hw"][both], rtol=0.05)
        assert cur["full_res_depth_b1hw"].shape == (1, H * 5 // 4, W * 5 // 4)


def test_eval_cli_over_the_written_scan_is_the_synthetic_run(tmp_path,
                                                             monkeypatch):
    """The CPU twin of `chip_smoke.py` phase 25 at 64x96 (the hero YAML's
    widths and 8 views, float32, 12 frames, 5 tuples)."""
    from simplerecon_tpu_torch.data import synthetic
    from simplerecon_tpu_torch.options import OptionsHandler
    from simplerecon_tpu_torch.scripts import test as eval_cli
    from simplerecon_tpu_torch.testing import (SCAN_ID, compare_scan_depths,
                                               synthetic_tuples,
                                               write_scannet_scan,
                                               write_tuples)
    frames = 12
    monkeypatch.setattr(synthetic, "DEFAULT_NUM_FRAMES", frames)
    root = str(tmp_path / "scannet")
    write_scannet_scan(root, num_frames=frames, image_height=H,
                       image_width=W)
    write_tuples(root, synthetic_tuples(frames, 8))
    common = ["--config_file", "configs/models/hero_model.yaml",
              "--split", "test", "--cache_depths", "--image_height", str(H),
              "--image_width", str(W), "--precision", "32",
              "--batch_size", "4", "--num_workers", "2"]
    runs = {}
    for tag, extra in (
            ("synthetic", ["--dataset", "synthetic",
                           "--single_debug_scan_id", "scene"]),
            ("scannet", ["--dataset", "scannet", "--dataset_path", root,
                         "--single_debug_scan_id", SCAN_ID])):
        opts = OptionsHandler().parse_and_merge_options(cl_args_list=[
            *common, *extra, "--output_base_path", str(tmp_path / tag)])
        frame_avg, _ = eval_cli.main(opts, device="cpu")
        assert frame_avg.run_stats["frames"] == frames - 7
        runs[tag] = os.path.join(str(tmp_path / tag), opts.name,
                                 opts.dataset, opts.frame_tuple_type,
                                 "depths")
    result = compare_scan_depths(os.path.join(runs["scannet"], SCAN_ID),
                                 os.path.join(runs["synthetic"], "scene"))
    assert result["frames"] == frames - 7 and result["same_bits"], result
    with open(os.path.join(root, "tuples", "test_eight_view_deepvmvs.txt")
              ) as f:
        assert json.dumps(f.readline().split()) == json.dumps(
            [SCAN_ID] + [f"{i:06d}" for i in (7, 0, 1, 2, 3, 4, 5, 6)])
