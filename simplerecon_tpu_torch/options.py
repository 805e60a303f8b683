"""Experiment configuration (counterpart of `simplerecon_tpu/options.py`):
the `Options` dataclass with the same fields and defaults, config files
layered under command-line flags, and a reader and writer for the flat
`key: value` YAML files of `configs/` that needs no YAML library.

Merge precedence (last wins): config_file < data_config_file < CLI.
Reference-style files tagged `!!python/object:options.Options` are read
with the tag stripped.

The reader types plain scalars as PyYAML's `safe_load` (YAML 1.1) does:
`16` is an int and `"16"` a string, `0.0001` a float but `1e-4` (no dot)
a string, `yes`/`no`/`on`/`off`/`true`/`false` booleans, `~`/`null`/an
empty value None. It reads a mapping of scalars and of sequences of
scalars (flow `[a, b]` or block `- a` lines), quoted scalars without
backslash escapes, and raises on anything else.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Options:
    """All experiment flags, as in the JAX package's `Options`."""

    random_seed: int = 0

    # ------------------------------- logs ---------------------------------
    name: str = "debug"
    log_dir: str = os.path.join(os.path.expanduser("~"), "tmp/tensorboard")
    notes: str = ""
    log_interval: int = 100
    val_interval: int = 1000
    val_batches: int = 100

    # ------------------------------- data ---------------------------------
    dataset: str = "scannet"
    dataset_path: str = "/mnt/scannet-data-png"
    num_workers: int = 12
    tuple_info_file_location: str = ""
    mv_tuple_file_suffix: str = "_eight_view_deepvmvs.txt"
    frame_tuple_type: str = "default"
    model_num_views: int = 8
    num_images_in_tuple: Optional[int] = None
    dataset_scan_split_file: str = ""
    split: str = "train"
    image_width: int = 512
    image_height: int = 384
    shuffle_tuple: bool = False
    test_keyframe_buffer_size: int = 30

    # --------------------------- hyperparameters --------------------------
    lr: float = 1e-4
    wd: float = 1e-4
    grad_clip: float = 0.0
    num_sanity_val_steps: int = 0
    max_steps: int = 110000
    batch_size: int = 16
    val_batch_size: int = 16
    num_devices: int = 1
    # "16"/"bf16": bfloat16 compute with float32 parameters; "32"/"fp32"
    precision: str = "16"
    lr_steps: List[int] = field(default_factory=lambda: [70000, 80000])

    # ------------------------------ models --------------------------------
    resume: Optional[str] = None
    load_weights_from_checkpoint: Optional[str] = None
    image_encoder_name: str = "efficientnet"
    depth_decoder_name: str = "unet_pp"
    loss_type: str = "log_l1"
    matching_encoder_type: str = "resnet"
    matching_feature_dims: int = 16
    matching_norm: str = "batch"
    # stem pool: "reference" (the plain chain) or "pallas" (the fused
    # max-blur-pool kernel K3); the JAX package's "fused" is its
    # reference chain in another form
    matching_pool_impl: str = "reference"
    matching_scale: int = 1
    matching_num_depth_bins: int = 64
    min_matching_depth: float = 0.25
    max_matching_depth: float = 5.0
    cv_encoder_type: str = "multi_scale_encoder"
    feature_volume_type: str = "mlp_feature_volume"

    # ----------------------------- inference ------------------------------
    output_base_path: str = "outputs"
    run_fusion: bool = False
    fuse_color: bool = False
    fusion_max_depth: float = 3.0
    fusion_resolution: float = 0.04
    depth_fuser: str = "ours"
    single_debug_scan_id: Optional[str] = None
    skip_frames: Optional[int] = None
    skip_to_frame: Optional[int] = None
    pc_fusion_z_thresh: float = 0.04
    n_consistent_thresh: int = 3
    voxel_downsample: float = 0.02
    mask_pred_depth: bool = False
    cache_depths: bool = False
    fusion_use_raw_lowest_cost: bool = False
    high_res_validation: bool = False
    data_parallel_eval: bool = False
    fast_cost_volume: bool = False
    # the hero model's sweep, through `models/depth_model.py::HERO_SWEEPS`
    cost_volume_backend: str = "xla_fused"
    # read and kept for the JAX package's files; the port's sweeps have
    # one form each
    cost_volume_band_axis: str = "x"
    cost_volume_custom_vjp: object = "pallas_bwd"
    remat_submodules: bool = False

    # --------------------------- visualization ----------------------------
    standard_fps: int = 30
    dump_depth_visualization: bool = False
    use_precomputed_partial_meshes: bool = False
    viz_render_width: int = 640
    viz_render_height: int = 480
    cam_marker_size: float = 0.7
    back_face_alpha: float = 0.5

    # ------------------------------ helpers -------------------------------
    @property
    def compute_dtype(self) -> str:
        return "bfloat16" if str(self.precision) in ("16", "bf16") else "float32"

    @property
    def num_source_views(self) -> int:
        return self.model_num_views - 1

    @property
    def matching_height(self) -> int:
        return self.image_height // (2 ** (self.matching_scale + 1))

    @property
    def matching_width(self) -> int:
        return self.image_width // (2 ** (self.matching_scale + 1))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Options":
        opts = cls()
        opts.update_from(d)
        return opts

    def set(self, key: str, value):
        """Sets a flag; `gpus` is the reference's name for `num_devices`,
        and `precision` is kept as a string. Unknown keys are kept in
        `_unknown`."""
        if key == "gpus":
            key, value = "num_devices", int(value)
        if key == "precision":
            value = str(value)
        if not hasattr(self, key):
            self._unknown = getattr(self, "_unknown", {})
            self._unknown[key] = value
            return
        setattr(self, key, value)

    def update_from(self, d: dict):
        for k, v in d.items():
            self.set(k, v)


# ---------------------------------------------------------------------------
# YAML 1.1 plain scalars, as PyYAML's resolver reads them
# ---------------------------------------------------------------------------

_PY_OBJECT_TAG = re.compile(r"!!python/object:\S+")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# the forms of `_INT` and `_FLOAT` (subsets of them) that the reader
# converts: plain decimals, as the configs write them
_DECIMAL_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_DECIMAL_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)"
                            r"(?:[eE][-+][0-9]+)?$")


def _plain_scalar(text: str):
    """A plain (unquoted) scalar, typed as YAML 1.1 resolves it. A number
    in another form than a plain decimal (base 2, 8 or 16, `_`
    separators, sexagesimal, .inf, .nan) and a timestamp raise."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _DECIMAL_INT.match(text):
        return int(text)
    if _DECIMAL_FLOAT.match(text):
        return float(text)
    if _INT.match(text) or _FLOAT.match(text) or _TIMESTAMP.match(text):
        raise ValueError(f"YAML 1.1 reads {text!r} as a number or date in "
                         "a form this reader does not convert")
    return text


def _quoted_end(text: str) -> int:
    """Index just past the quoted scalar that opens `text`."""
    quote = text[0]
    i = 1
    while i < len(text):
        if quote == "'" and text[i] == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if text[i] == "\\":
                i += 2
                continue
            if text[i] == '"':
                return i + 1
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(text: str) -> str:
    """Drops a ` #` comment and surrounding spaces from a plain value."""
    m = re.search(r"(^|\s)#", text)
    return (text[:m.start()] if m else text).strip()


def _scalar(text: str):
    """One scalar (plain or quoted) with any trailing comment."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        end = _quoted_end(text)
        rest = _strip_comment(text[end:])
        if rest:
            raise ValueError(f"text after a quoted scalar: {text!r}")
        body = text[1:end - 1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"escapes in double-quoted YAML are not read: "
                             f"{text!r}")
        return body
    if text[:1] in ("{", "&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML value: {text!r}")
    return _plain_scalar(_strip_comment(text))


def _flow_sequence(text: str) -> list:
    text = _strip_comment(text)
    if not text.endswith("]"):
        raise ValueError(f"unsupported flow sequence: {text!r}")
    body = text[1:-1].strip()
    if not body:
        return []
    items, i = [], 0
    while i <= len(body):
        rest = body[i:].lstrip()
        start = len(body) - len(rest)
        if rest[:1] in ("'", '"'):
            end = start + _quoted_end(rest)
            comma = body.find(",", end)
        else:
            comma = body.find(",", start)
        stop = len(body) if comma < 0 else comma
        items.append(_scalar(body[start:stop]))
        if comma < 0:
            break
        i = comma + 1
    return items


def parse_options_yaml(text: str) -> dict:
    """The mapping of a flat `key: value` YAML document."""
    text = _PY_OBJECT_TAG.sub("", text)
    data: dict = {}
    block_key = None    # the key whose block sequence may follow
    for raw in text.splitlines():
        line = raw.rstrip()
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or stripped in ("---",
                                                                    "..."):
            continue
        if stripped == "-" or stripped.startswith("- "):
            if block_key is None:
                raise ValueError(f"sequence item outside a key: {raw!r}")
            if data[block_key] is None:
                data[block_key] = []
            data[block_key].append(_scalar(stripped[1:]))
            continue
        if line[0].isspace():
            raise ValueError(f"nested YAML is not read: {raw!r}")
        m = re.match(r"^([^\s:#'\"][^:]*?)\s*:(?:\s+(.*))?$", line)
        if m is None:
            raise ValueError(f"not a `key: value` line: {raw!r}")
        key, value = m.group(1), (m.group(2) or "")
        if key in data:
            raise ValueError(f"duplicate key {key!r}")
        block_key = None
        if value.startswith("["):
            data[key] = _flow_sequence(value)
        elif value.startswith(("'", '"')) or _strip_comment(value):
            data[key] = _scalar(value)
        else:   # an empty value: None, or the head of a block sequence
            data[key] = None
            block_key = key
    return data


def load_options_yaml(path: str) -> dict:
    """Loads a YAML options file into a plain dict, as the JAX package's
    `load_options_yaml` (a reference `!!python/object` tag is stripped)."""
    with open(path, "r") as f:
        return parse_options_yaml(f.read())


def _yaml_value(value) -> str:
    """One value as a YAML scalar (or flow sequence) that reads back as
    the same value and type."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if not math.isfinite(value):
            raise ValueError(f"the reader does not read {value!r} back")
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if "." not in mantissa:     # YAML 1.1 floats need a dot
            mantissa += ".0"
        if exponent and exponent[0] not in "+-":
            exponent = "+" + exponent
        return mantissa + ("e" + exponent if exponent else "")
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_value(v) for v in value) + "]"
    return "'" + str(value).replace("'", "''") + "'"


def save_options_yaml(path: str, opts: Options):
    """Writes the options as a flat YAML mapping, keys sorted, that both
    this reader and PyYAML's `safe_load` read back to the same values."""
    d = opts.to_dict()
    with open(path, "w") as f:
        for key in sorted(d):
            f.write(f"{key}: {_yaml_value(d[key])}\n")


class OptionsHandler:
    """Parses config files and command-line flags into an `Options`:
    --config_file first, then --data_config_file, then explicit flags.
    The flags are built from `Options`' fields, whose types are strings
    (`from __future__ import annotations`), as in the JAX package."""

    def __init__(self, required_flags: Optional[List[str]] = None):
        self.options = Options()
        self.required_flags = required_flags or []
        self.parser = argparse.ArgumentParser(
            description="simplerecon_tpu_torch options")
        self.parser.add_argument("--config_file", type=str, default=None)
        self.parser.add_argument("--data_config_file", type=str,
                                 default=None)
        self._populate_argparse()

    def _populate_argparse(self):
        for f in dataclasses.fields(Options):
            if f.type in (bool, "bool"):
                self.parser.add_argument(f"--{f.name}", action="store_true",
                                         default=None)
            elif f.name == "lr_steps":
                self.parser.add_argument(f"--{f.name}", type=int, nargs="+",
                                         default=None)
            else:
                base = {int: int, float: float, str: str,
                        "int": int, "float": float, "str": str,
                        "Optional[int]": int, "Optional[str]": str,
                        Optional[int]: int, Optional[str]: str}.get(f.type, str)
                self.parser.add_argument(f"--{f.name}", type=base,
                                         default=None)
        self.parser.add_argument("--gpus", type=int, default=None)

    def parse_and_merge_options(self, config_filepaths=None,
                                ignore_cl_args: bool = False,
                                cl_args_list=None) -> Options:
        cl_args = None
        if not ignore_cl_args:
            cl_args = self.parser.parse_args(cl_args_list)

        paths = []
        if config_filepaths is not None:
            paths = (config_filepaths if isinstance(config_filepaths, list)
                     else [config_filepaths])
        elif cl_args is not None:
            if cl_args.config_file:
                paths.append(cl_args.config_file)
            if cl_args.data_config_file:
                paths.append(cl_args.data_config_file)

        for p in paths:
            self.options.update_from(load_options_yaml(p))
        self.config_filepaths = paths

        if cl_args is not None:
            for key, value in vars(cl_args).items():
                if key in ("config_file", "data_config_file") or value is None:
                    continue
                if isinstance(value, bool) and not value:
                    continue
                self.options.set(key, value)

        for flag in self.required_flags:
            if getattr(self.options, flag, None) is None:
                raise ValueError(f"missing required config argument '{flag}'")
        return self.options

    def pretty_print_options(self):
        print("#" * 27 + " Options " + "#" * 27)
        for f in dataclasses.fields(Options):
            print(f"    {f.name}: {getattr(self.options, f.name)}")
        print("#" * 63)
