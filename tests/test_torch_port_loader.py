"""The loader's random draws repeat (the port alone, on the CPU).

Every item draws its flip coin, colour jitter and `shuffle_tuple`
shuffle from a state made from (seed, epoch, index)
(`data/loader.py::item_rng`), and the epoch's order from the loader's
seeded state, so:
- the synthetic train split (flips) gives the same batches bit for bit
  over two epochs with 8 decode threads and with 1, and its two epochs
  differ;
- a rank's shard (`DataLoader(shard=(rank, world))`, and
  `parallel/mesh.py::shard_batch`) is the matching rows of the
  single-process batch;
- a ScanNet scan written to disk (train split: colour jitter and flips)
  gives the same batches on two runs, and the same as the dataset's
  items called with those states;
- the training CLI's loaders build no unseeded `RandomState`.
"""

import numpy as np
import pytest

from simplerecon_tpu_torch.data.loader import (DataLoader, collate,
                                               item_rng, to_train_schema)
from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
from simplerecon_tpu_torch.parallel import mesh
from test_torch_port_data import assert_bit_equal
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

H, W = 64, 96
SEED = 5


def synthetic_train(**kw):
    return SyntheticDataset(num_frames=12, image_height=H, image_width=W,
                            num_images_in_tuple=4, split="train", **kw)


def epochs(loader, n=2):
    return [list(loader) for _ in range(n)]


@pytest.fixture(scope="module")
def single_run():
    """Two epochs of the synthetic train split, batch 4, one thread."""
    return epochs(DataLoader(synthetic_train(), batch_size=4, shuffle=True,
                             num_workers=1, drop_last=True, seed=SEED))


def test_batches_do_not_depend_on_the_threads(single_run):
    threaded = epochs(DataLoader(synthetic_train(), batch_size=4,
                                 shuffle=True, num_workers=8,
                                 drop_last=True, seed=SEED))
    assert [len(e) for e in single_run] == [2, 2]
    assert_bit_equal(threaded, single_run)
    # the flips are drawn (a flipped pose's rotation has determinant -1),
    # and drawn anew each epoch
    flipped = [bool(np.linalg.det(b["cur"]["world_T_cam_b44"][i, :3, :3])
                    < 0) for e in single_run for b in e for i in range(4)]
    assert any(flipped) and not all(flipped), flipped
    first, second = single_run
    assert any(not np.array_equal(a["cur"]["image_b3hw"],
                                  b["cur"]["image_b3hw"])
               for a, b in zip(first, second))


@pytest.mark.parametrize("world", [2, 4])
def test_a_rank_takes_its_rows_of_the_single_batch(single_run, world):
    for rank in range(world):
        shard = epochs(DataLoader(synthetic_train(), batch_size=4,
                                  shuffle=True, num_workers=2,
                                  drop_last=True, seed=SEED,
                                  shard=(rank, world)))
        rows = mesh.rank_rows(4, rank, world)
        want = [[mesh.shard_batch(b, rank, world) for b in e]
                for e in single_run]
        assert_bit_equal(shard, want)
        assert want[0][0]["cur"]["image_b3hw"].shape[0] \
            == rows.stop - rows.start


def test_batches_must_divide_over_the_ranks(single_run):
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch(single_run[0][0], 0, 3)
    with pytest.raises(ValueError, match="divide"):
        DataLoader(synthetic_train(), batch_size=4, drop_last=True,
                   shard=(0, 3))
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(synthetic_train(), batch_size=4, shard=(0, 2))


def test_scan_on_disk_repeats_its_draws(tmp_path):
    from simplerecon_tpu_torch.data.scannet import ScannetDataset
    from simplerecon_tpu_torch.testing import (TUPLE_SUFFIX,
                                               synthetic_tuples,
                                               write_scannet_scan,
                                               write_tuples)
    root = str(tmp_path)
    write_scannet_scan(root, num_frames=8, image_height=H, image_width=W)
    write_tuples(root, synthetic_tuples(8, 4), splits=("train",))

    def dataset():
        return ScannetDataset(root, "train", TUPLE_SUFFIX, image_height=H,
                              image_width=W, num_images_in_tuple=4)

    runs = [epochs(DataLoader(dataset(), batch_size=2, shuffle=True,
                              num_workers=workers, drop_last=True,
                              seed=SEED, adapter=to_train_schema))
            for workers in (4, 1)]
    assert_bit_equal(runs[0], runs[1])
    # the loader's items are the dataset's, called with those states
    order = np.arange(5)
    np.random.RandomState(SEED).shuffle(order)
    plain = dataset()
    for b, batch in enumerate(runs[0][0]):
        items = [plain.__getitem__(i, item_rng(SEED, 0, i))
                 for i in order[2 * b:2 * b + 2]]
        assert_bit_equal(batch, to_train_schema(collate(items)))
    # the colour jitter ran: the same item with another state differs
    a = plain.__getitem__(0, item_rng(SEED, 0, 0))[0]["image_b3hw"]
    b = plain.__getitem__(0, item_rng(SEED, 1, 0))[0]["image_b3hw"]
    assert not np.array_equal(a, b)


def test_training_loaders_build_no_unseeded_state(monkeypatch, tmp_path):
    from simplerecon_tpu_torch.options import OptionsHandler
    from simplerecon_tpu_torch.scripts import train as train_cli
    from simplerecon_tpu_torch.data import synthetic
    built = []
    plain_state = np.random.RandomState

    class Checked(plain_state):
        def __init__(self, seed=None):
            built.append(seed)
            assert seed is not None, "an unseeded RandomState"
            super().__init__(seed)

    monkeypatch.setattr(synthetic, "DEFAULT_NUM_FRAMES", 9)
    monkeypatch.setattr(np.random, "RandomState", Checked)
    opts = OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--image_height", str(H), "--image_width", str(W),
        "--num_images_in_tuple", "4", "--batch_size", "2",
        "--val_batch_size", "2", "--num_workers", "2",
        "--log_dir", str(tmp_path)])
    train_loader, val_loader = train_cli.build_dataloaders(opts, (1, 2))
    batch = next(iter(train_loader))
    assert batch["cur"]["image_b3hw"].shape[0] == 1
    next(iter(val_loader))
    assert built
