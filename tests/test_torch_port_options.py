"""The port's options (`simplerecon_tpu_torch/options.py`) against the JAX
package's, on the CPU.

- Every YAML under `configs/` parses to the same mapping as the JAX
  package's `load_options_yaml` (PyYAML's `safe_load`), value and type.
- The YAML 1.1 scalar rules on a document of edge cases, against PyYAML;
  numbers and dates in the forms it does not convert raise.
- `OptionsHandler.parse_and_merge_options` gives the JAX handler's
  `to_dict()` for two-file layering, a `store_true` flag, `--lr_steps`,
  `--gpus` and an `Optional[int]`.
- `save_options_yaml` writes a file that both readers read back as the
  options.
- `testing.hero_options()` and `dot_options()`, now read from the YAML,
  hold the values the hand-written dicts held before.
"""

import glob
import os

import pytest
import yaml

from simplerecon_tpu import options as joptions
from simplerecon_tpu_torch import options as toptions
from simplerecon_tpu_torch.testing import dot_options, hero_options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


def assert_same_typed(got: dict, want: dict):
    assert got == want
    for key in want:
        assert type(got[key]) is type(want[key]), key


def test_every_config_parses_as_the_jax_reader():
    assert len(CONFIGS) == 16
    for path in CONFIGS:
        assert_same_typed(toptions.load_options_yaml(path),
                          joptions.load_options_yaml(path))


EDGE_CASES = """# comment line
!!python/object:options.Options
int_plain: 16
str_quoted: "16"
str_single: '16'
float_dot: 0.0001
float_exp: 1.0e-4
str_exp_no_dot: 1e-4
bool_true: true
bool_off: off
bool_yes: Yes
null_tilde: ~
null_empty:
null_word: null   # trailing comment
text: hello world   # trailing comment
hash_inside: a#b
flow: [1, 2.5, 'x, y', "q"]
block:
- 70000
- 80000
negative: -3
float_signed: +2.
float_lead_dot: .5
str_signed_lead_dot: -.5
str_dot_underscore: ._5
escaped: 'it''s'
double_quoted: "a: b # c"
"""


def test_scalar_rules_follow_pyyaml():
    got = toptions.parse_options_yaml(EDGE_CASES)
    want = yaml.safe_load(EDGE_CASES.replace(
        "!!python/object:options.Options\n", ""))
    assert_same_typed(got, want)


@pytest.mark.parametrize("value", ["0x1F", "017", "0b101", "1_000", "1.5_0",
                                   "1:30", "1:30.5", ".inf", "-.Inf", ".nan",
                                   "2026-10-17"])
def test_other_yaml11_numbers_raise(value):
    """Numbers and dates that YAML 1.1 reads in forms no config uses
    raise, where the reader would otherwise keep them as strings."""
    assert not isinstance(yaml.safe_load(f"k: {value}")["k"], str)
    with pytest.raises(ValueError, match="does not convert"):
        toptions.parse_options_yaml(f"k: {value}")


HERO = os.path.join(REPO, "configs", "models", "hero_model.yaml")
DATA = os.path.join(REPO, "configs", "data", "scannet_dense_test.yaml")


@pytest.mark.parametrize("cl_args", [
    ["--config_file", HERO, "--data_config_file", DATA],
    ["--config_file", HERO, "--run_fusion", "--lr", "3e-4"],
    ["--config_file", HERO, "--lr_steps", "1", "2"],
    ["--gpus", "4", "--precision", "32"],
    ["--num_images_in_tuple", "5", "--skip_frames", "2",
     "--single_debug_scan_id", "scene"],
], ids=["two_files", "store_true", "lr_steps", "gpus", "optional_int"])
def test_handler_merges_as_the_jax_handler(cl_args):
    got = toptions.OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args)
    want = joptions.OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args)
    assert_same_typed(got.to_dict(), want.to_dict())
    assert got.compute_dtype == want.compute_dtype
    assert (got.matching_height, got.matching_width) == (
        want.matching_height, want.matching_width)


def test_saved_options_read_back_in_both_readers(tmp_path):
    opts = toptions.OptionsHandler().parse_and_merge_options(
        cl_args_list=["--config_file", HERO, "--lr", "1e-5",
                      "--notes", "it's: # not a comment"])
    path = str(tmp_path / "options.yaml")
    toptions.save_options_yaml(path, opts)
    assert_same_typed(toptions.load_options_yaml(path), opts.to_dict())
    assert_same_typed(joptions.load_options_yaml(path), opts.to_dict())


# the values `testing.py` held by hand before it read the YAML
HERO_BEFORE = dict(
    feature_volume_type="mlp_feature_volume", matching_encoder_type="resnet",
    image_height=384, image_width=512, matching_scale=1,
    matching_num_depth_bins=64, min_matching_depth=0.25,
    max_matching_depth=5.0, matching_feature_dims=16,
    matching_pool_impl="reference", model_num_views=8, precision="16",
    cost_volume_backend="xla_fused", fast_cost_volume=False,
    test_keyframe_buffer_size=30, lr=1e-4, wd=1e-4,
    lr_steps=[70000, 80000], grad_clip=0.0)
DOT_BEFORE = dict(HERO_BEFORE, feature_volume_type="simple_cost_volume",
                  matching_pool_impl="pallas")


@pytest.mark.parametrize("make, before", [(hero_options, HERO_BEFORE),
                                          (dot_options, DOT_BEFORE)],
                         ids=["hero", "dot"])
def test_model_options_keep_their_values(make, before):
    opts = make()
    for key, value in before.items():
        got = getattr(opts, key)
        assert got == value and type(got) is type(value), key
    assert opts.compute_dtype == "bfloat16"
    assert make(precision="32", image_height=192).image_height == 192
