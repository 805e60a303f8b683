"""The port's tuple generation and data scripts against the JAX
package's, on the CPU: equal output for equal input.

- Test tuples of every type (default, offline, dense, dense_offline) and
  train chains (8 views, and the 2-view pairs) on the synthetic scene's
  trajectory with a tracking gap: the same lines.
- `scripts/generate_tuples.py` on a ScanNet scan written by
  `test_data.make_scannet_fixture`: the same tuple file for a test and a
  train split (the port's also with 2 worker processes: the same lines,
  which the JAX script cannot run, its dataset factory being a closure).
- `precompute_valid_frames.py`: the same `valid_frames.txt`;
  `generate_gt_min_max_cache.py`: the same pickle;
  `preprocess_7scenes.py`: the same 16-bit registered depth pixels;
  `load_meshes_and_include_normals.py`: the same PLY bytes.
"""

import os
import pickle
import random
import shutil

import numpy as np
import pytest
from PIL import Image

from simplerecon_tpu.data import tuple_generation as jax_tuples
from simplerecon_tpu_torch.data import tuple_generation as port_tuples
from test_data import make_scannet_fixture
from test_torch_port_ops import few_torch_threads  # noqa: F401

SCAN = "scene0000_00"


class PoseScan:
    """A scan of the synthetic trajectory's poses, frames 20-22 missing
    (tracking lost), for the tuple functions of both packages."""

    split = "test"

    def __init__(self, n: int = 60):
        from simplerecon_tpu_torch.data.synthetic import camera_trajectory
        self.poses = camera_trajectory(n)
        self.valid = [i for i in range(n) if not 20 <= i <= 22]

    def get_valid_frame_ids(self, split, scan, store_computed=True):
        lines, last = [], -1
        for i in self.valid:
            lines.append(f"{scan} {i:06d} {i - last - 1}")
            last = i
        return lines

    def load_pose(self, scan, frame_id):
        pose = self.poses[int(frame_id)].astype(np.float32)
        return pose, np.linalg.inv(pose)


def seeded(fn, *args):
    np.random.seed(42)
    random.seed(42)
    return fn(*args)


@pytest.mark.parametrize("tuple_type", ["default", "offline", "dense",
                                        "dense_offline"])
def test_test_tuples_are_the_jax_tuples(tuple_type):
    scan = PoseScan()
    port = seeded(port_tuples.generate_test_tuples_for_scan, scan, SCAN,
                  tuple_type, 8)
    ref = seeded(jax_tuples.generate_test_tuples_for_scan, scan, SCAN,
                 tuple_type, 8)
    assert port == ref and len(port) > 30
    ids = {f"{i:06d}" for i in scan.valid}
    for line in port:
        parts = line.split(" ")
        assert parts[0] == SCAN and len(parts) == 9 and set(parts[1:]) <= ids


@pytest.mark.parametrize("views", [8, 2])
def test_train_tuples_are_the_jax_tuples(views):
    scan = PoseScan()
    port = seeded(port_tuples.generate_train_tuples_for_scan, scan, SCAN,
                  views)
    ref = seeded(jax_tuples.generate_train_tuples_for_scan, scan, SCAN,
                 views)
    assert port == ref and len(port) > 0
    assert all(len(line.split(" ")) == views + 1 for line in port)


def _options(package: str, *args):
    if package == "port":
        from simplerecon_tpu_torch.options import OptionsHandler
    else:
        from simplerecon_tpu.options import OptionsHandler
    return OptionsHandler().parse_and_merge_options(cl_args_list=list(args))


def _scannet_root(tmp_path, frames: int = 30) -> str:
    root = str(tmp_path / "scannet")
    make_scannet_fixture(root, n_frames=frames)
    os.symlink("scans", os.path.join(root, "scans_test"))
    return root


@pytest.mark.parametrize("split", ["test", "train"])
def test_generate_tuples_writes_the_jax_file(split, tmp_path):
    from simplerecon_tpu.scripts import generate_tuples as jax_script
    from simplerecon_tpu_torch.scripts import generate_tuples as port_script
    root = _scannet_root(tmp_path)
    written = {}
    for package, script, workers in (("jax", jax_script, 1),
                                     ("port", port_script, 1),
                                     ("port_workers", port_script, 2)):
        out = str(tmp_path / package)
        opts = _options(package[:4], "--dataset", "scannet",
                        "--dataset_path", root, "--split", split,
                        "--single_debug_scan_id", SCAN,
                        "--frame_tuple_type", "dense",
                        "--num_images_in_tuple", "8",
                        "--tuple_info_file_location", out,
                        "--num_workers", str(workers))
        script.main(opts)
        with open(os.path.join(out, f"{split}_eight_view_deepvmvs.txt")) as f:
            written[package] = f.read().splitlines()
    assert written["port"] == written["jax"] and len(written["jax"]) >= 3
    # one scan: a worker process reseeds as the parent does
    assert sorted(written["port_workers"]) == sorted(written["jax"])


def test_precompute_valid_frames_writes_the_jax_file(tmp_path):
    from simplerecon_tpu.scripts import precompute_valid_frames as jax_script
    from simplerecon_tpu_torch.scripts import \
        precompute_valid_frames as port_script
    root = _scannet_root(tmp_path, frames=6)
    sensor = os.path.join(root, "scans", SCAN, "sensor_data")
    os.remove(os.path.join(sensor, "frame-000002.depth.png"))
    np.savetxt(os.path.join(sensor, "frame-000004.pose.txt"),
               np.full((4, 4), np.inf))
    path = os.path.join(root, "scans", SCAN, "valid_frames.txt")
    written = {}
    for package, script in (("jax", jax_script), ("port", port_script)):
        script.main(_options(package, "--dataset", "scannet",
                             "--dataset_path", root, "--split", "train",
                             "--single_debug_scan_id", SCAN,
                             "--num_workers", "1"))
        with open(path) as f:
            written[package] = f.read()
        os.remove(path)
    assert written["port"] == written["jax"]
    assert written["jax"].splitlines() == [
        f"{SCAN} 000000 0", f"{SCAN} 000001 0", f"{SCAN} 000003 1",
        f"{SCAN} 000005 1"]


def test_gt_min_max_cache_is_the_jax_pickle(tmp_path):
    from simplerecon_tpu.scripts import generate_gt_min_max_cache as jax_script
    from simplerecon_tpu_torch.scripts import \
        generate_gt_min_max_cache as port_script
    root = _scannet_root(tmp_path, frames=5)
    caches = {}
    for package, script in (("jax", jax_script), ("port", port_script)):
        opts = _options(package, "--dataset", "scannet",
                        "--dataset_path", root, "--split", "test",
                        "--single_debug_scan_id", SCAN,
                        "--tuple_info_file_location",
                        os.path.join(root, "tuples"), "--image_height",
                        "64", "--image_width", "96", "--output_base_path",
                        str(tmp_path / package))
        script.main(opts)
        path = os.path.join(str(tmp_path / package), opts.name, "scannet",
                            "default", "viz", "gt_min_max_cache.pickle")
        with open(path, "rb") as f:
            caches[package] = pickle.load(f)
    assert caches["port"] == caches["jax"]
    assert len(caches["jax"][SCAN]) == 1


def test_preprocess_7scenes_writes_the_jax_depth(tmp_path):
    from simplerecon_tpu.scripts import preprocess_7scenes as jax_script
    from simplerecon_tpu_torch.data import codec
    from simplerecon_tpu_torch.scripts import preprocess_7scenes as port_script
    rng = np.random.RandomState(0)
    src = tmp_path / "src" / "chess" / "seq-01"
    os.makedirs(src)
    for i in range(2):
        depth = (rng.rand(48, 64) * 3000 + 500).astype(np.uint16)
        depth[::5, ::3] = 0
        depth[1::7, ::4] = 65535
        Image.fromarray(depth).save(src / f"frame-{i:06d}.depth.png")
    scenes = {}
    for package, script in (("jax", jax_script), ("port", port_script)):
        shutil.copytree(tmp_path / "src", tmp_path / package)
        script.process_scene(str(tmp_path / package / "chess"))
        scenes[package] = tmp_path / package / "chess" / "seq-01"
    for i in range(2):
        name = f"frame-{i:06d}.depth.proj.png"
        want = np.asarray(Image.open(scenes["jax"] / name))
        got = np.asarray(Image.open(scenes["port"] / name))
        assert got.dtype == want.dtype == np.uint16 and want.any()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(codec.read_image(
            str(scenes["port"] / name)), want)


def test_load_meshes_and_include_normals_writes_the_jax_ply(tmp_path):
    from simplerecon_tpu.scripts import \
        load_meshes_and_include_normals as jax_script
    from simplerecon_tpu_torch.data.synthetic import make_room_mesh
    from simplerecon_tpu_torch.fusion.mesh import write_ply
    from simplerecon_tpu_torch.scripts import \
        load_meshes_and_include_normals as port_script
    meshes = tmp_path / "meshes"
    os.makedirs(meshes)
    v, f, _ = make_room_mesh(tess=8)
    write_ply(str(meshes / "room.ply"), v, f)
    for package, script in (("jax", jax_script), ("port", port_script)):
        script.main(["--input_path", str(meshes), "--output_path",
                     str(tmp_path / package)])
    with open(tmp_path / "jax" / "room.ply", "rb") as a, \
            open(tmp_path / "port" / "room.ply", "rb") as b:
        assert a.read() == b.read()
