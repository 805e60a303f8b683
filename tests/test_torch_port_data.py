"""The port's data layer against the JAX package's, on the CPU.

The synthetic scene goes through the same C++ rasterizer source and the
same numpy, so items and batches must be equal bit for bit:
- `SyntheticDataset` items at 64x96 with 4 views (every tuple, in the
  eval CLI's configuration: full-resolution depth, its intrinsics and
  frame ids) and one item at 384x512 with 8 views, key for key;
- the port's `DataLoader` batches against the JAX loader's, and after
  `to_train_schema`;
- `device_prefetch` to the CPU gives the same values as tensors and
  passes frame-id strings through.
- The train-time colour jitter and the scaled intrinsics (flipped and
  not) equal the JAX package's, bit for bit.
The file-backed readers are held in `test_torch_port_datasets.py`.
"""

import numpy as np
import pytest
import torch

from simplerecon_tpu.data import loader as jloader
from simplerecon_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from simplerecon_tpu_torch.data import loader as tloader
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.data.synthetic import SyntheticDataset

EVAL_KW = dict(split="test", include_full_res_depth=True,
               include_full_depth_K=True, pass_frame_id=True)


def assert_bit_equal(got, want, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for key in want:
            assert_bit_equal(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


def test_synthetic_items_are_the_jax_items():
    kw = dict(image_height=64, image_width=96, num_images_in_tuple=4,
              **EVAL_KW)
    port, ref = SyntheticDataset(**kw), JaxSynthetic(**kw)
    assert port.frame_tuples == ref.frame_tuples and len(port) == 45
    for i in range(len(port)):
        assert_bit_equal(port[i], ref[i], f"item {i}")


def test_full_size_item_is_the_jax_item():
    kw = dict(num_frames=9, image_height=384, image_width=512,
              num_images_in_tuple=8, **EVAL_KW)
    assert_bit_equal(SyntheticDataset(**kw)[1], JaxSynthetic(**kw)[1])


def test_loader_batches_are_the_jax_batches():
    kw = dict(num_frames=9, image_height=64, image_width=96,
              num_images_in_tuple=4, **EVAL_KW)
    port = list(tloader.DataLoader(SyntheticDataset(**kw), batch_size=4,
                                   num_workers=2))
    ref = list(jloader.DataLoader(JaxSynthetic(**kw), batch_size=4,
                                  num_workers=2))
    assert [len(b["cur"]["frame_id_string"]) for b in port] == [4, 2]
    for got, want in zip(port, ref):
        assert_bit_equal(got, want)
        assert_bit_equal(tloader.to_train_schema(got),
                         jloader.to_train_schema(want))

    moved = list(tloader.device_prefetch(port, "cpu"))
    assert len(moved) == len(port)
    for got, want in zip(moved, port):
        assert got["cur"]["frame_id_string"] == want["cur"]["frame_id_string"]
        for part in ("cur", "src"):
            for key, value in want[part].items():
                if isinstance(value, np.ndarray):
                    assert isinstance(got[part][key], torch.Tensor), key
                    np.testing.assert_array_equal(got[part][key].numpy(),
                                                  value)


def test_registry_gives_the_synthetic_scene():
    cls, scans = get_dataset("synthetic", None, "scene", verbose=False)
    assert cls is SyntheticDataset and scans == ["scene"]


def test_train_colour_jitter_is_the_jax_jitter():
    from simplerecon_tpu.data.io import ColorJitter as JaxJitter
    from simplerecon_tpu_torch.data.io import ColorJitter
    image = np.random.RandomState(1).rand(3, 16, 24).astype(np.float32)
    port = ColorJitter(rng=np.random.RandomState(5))
    ref = JaxJitter(rng=np.random.RandomState(5))
    for _ in range(4):
        assert_bit_equal(port(image), ref(image))


@pytest.mark.parametrize("flip", [False, True])
def test_scaled_intrinsics_are_the_jax_ones(flip):
    from simplerecon_tpu.data.generic_dataset import \
        GenericMVSDataset as JaxGeneric
    from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset
    K = np.array([[500.0, 0, 318.5, 0], [0, 498.0, 241.2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    args = (K, 640.0, 480.0, 256, 192, flip, True)
    assert_bit_equal(GenericMVSDataset._scaled_intrinsics(*args),
                     JaxGeneric._scaled_intrinsics(*args))
