"""Inputs made from `--seed`, on the device, in a few large calls: the
model's weights (one state dict, loaded into the program and into the
reference alike) and pools of batches drawn by one general generator from
a traffic mix's parameters (`traffic/<mix>.json`).

The same seed gives the same tensors on the same card.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

# salts that separate the streams drawn from one seed
_SALTS = {"weights": 1, "batches": 2, "flips": 3, "sample": 4}


def derived_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for `stream` (and `index` within it) from `seed`."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + _SALTS[stream] * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def device_generator(seed: int, stream: str, device, index: int = 0):
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, stream, index))
    return gen


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def _leaf_rule(name: str, shape, norms) -> tuple:
    """(scale, offset, exponentiate) of a state-dict entry drawn as
    offset + scale * N(0, 1): convolution and linear weights N(0, 1/fan_in)
    (flax's default), other biases N(0, 0.01^2), the scales of the norms
    in `norms` 1 + N(0, 0.1^2) and their shifts N(0, 0.1^2), running means
    N(0, 0.1^2) and running variances exp(N(0, 0.2^2))."""
    if name.endswith("running_var"):
        return 0.2, 0.0, True
    if name.endswith("running_mean"):
        return 0.1, 0.0, False
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0, False
    if name.rsplit(".", 1)[0] in norms:
        return (0.1, 1.0 if name.endswith("weight") else 0.0, False)
    return 0.01, 0.0, False


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 fixed: Dict[str, torch.Tensor], norms=frozenset()
                 ) -> Dict[str, torch.Tensor]:
    """A state dict over `shapes` (name -> shape) drawn from `seed` with
    one normal draw on `device`; entries in `fixed` (constant buffers,
    such as the blur filter) are taken as given, step counters are 0;
    `norms` names the norm modules (`_leaf_rule`)."""
    drawn = [(n, s) for n, s in shapes.items()
             if n not in fixed and not n.endswith("num_batches_tracked")]
    sizes = [math.prod(s) for _, s in drawn]
    rules = [_leaf_rule(n, s, norms) for n, s in drawn]
    gen = device_generator(seed, "weights", device)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([r[0] for r in rules], device=device), counts)
    offset = torch.repeat_interleave(
        torch.tensor([r[1] for r in rules], device=device), counts)
    expo = torch.repeat_interleave(
        torch.tensor([r[2] for r in rules], device=device), counts)
    flat = flat * scale + offset
    flat = torch.where(expo, torch.exp(flat), flat)
    out, start = {}, 0
    for (name, shape), size in zip(drawn, sizes):
        out[name] = flat[start:start + size].view(shape)
        start += size
    for name, shape in shapes.items():
        if name in fixed:
            out[name] = fixed[name].to(device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.long, device=device)
    return out


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

def _rot(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rotations about x or y by `angle` (...)."""
    c, s = torch.cos(angle), torch.sin(angle)
    m = torch.zeros(angle.shape + (4, 4), device=angle.device)
    m[..., 3, 3] = 1.0
    if axis == "y":
        m[..., 0, 0], m[..., 0, 2], m[..., 1, 1] = c, s, 1.0
        m[..., 2, 0], m[..., 2, 2] = -s, c
    else:
        m[..., 0, 0], m[..., 1, 1], m[..., 1, 2] = 1.0, c, -s
        m[..., 2, 1], m[..., 2, 2] = s, c
    return m


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _depth_maps(gen, shape, dh, dw, p, device):
    """Smooth depth: 2 m + tilts + amp sin(f x) cos(f y), with one
    rectangular NaN hole (a quarter of the height by a fifth of the width)
    a map at a random place in its upper-left quarter."""
    n = math.prod(shape)
    yy = torch.linspace(0, 1, dh, device=device)[:, None]
    xx = torch.linspace(0, 1, dw, device=device)[None, :]
    tilt = _uniform(gen, (n, 2, 1, 1), -1.0, 1.0, device)
    amp = _uniform(gen, (n, 1, 1), *p["wave_amplitude"], device=device)
    freq = _uniform(gen, (n, 1, 1), *p["wave_frequency"], device=device)
    maps = (p["mean_depth"] + tilt[:, 0] * (xx - 0.5) + tilt[:, 1] * (yy - 0.5)
            + amp * torch.sin(freq * xx) * torch.cos(freq * yy))
    y0 = torch.randint(0, dh // 2, (n, 1, 1), generator=gen, device=device)
    x0 = torch.randint(0, dw // 2, (n, 1, 1), generator=gen, device=device)
    rows = torch.arange(dh, device=device)[None, :, None]
    cols = torch.arange(dw, device=device)[None, None, :]
    hole = ((rows >= y0) & (rows < y0 + dh // 4)
            & (cols >= x0) & (cols < x0 + dw // 5))
    maps = torch.where(hole, torch.full_like(maps, float("nan")), maps)
    return maps.reshape(*shape, dh, dw)


def _intrinsics(b, k, height, width, scale, device):
    """Pinhole K (fx = 0.9 w, fy = 1.2 h, centred) at 1 / `scale` of the
    image, (b, k, 4, 4), and its inverse."""
    w, h = width / scale, height / scale
    K = torch.eye(4, device=device)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.9 * w, 1.2 * h, w / 2, h / 2
    return (K.expand(b, k, 4, 4).contiguous(),
            torch.linalg.inv(K).expand(b, 4, 4).contiguous())


def make_batch(config: Dict, mix: Dict, seed: int, index: int, device
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Batch `index` of the pool: the program's batch schema (images
    (b, 3, h, w) and (b, k, 3, h, w) from N(0, 1); GT depth at half the
    image with NaN holes and its mask; cameras a few centimetres and
    degrees apart; intrinsics at s0 (1/2) and at the matching scale)."""
    gen = device_generator(seed, "batches", device, index)
    b = mix["batch_size"]
    k = config["model_num_views"] - 1
    h, w = config["image_height"], config["image_width"]
    dh, dw = h // 2, w // 2
    m = config["matching_scale"]
    geo = mix["cameras"]
    cur_image = torch.randn((b, 3, h, w), generator=gen, device=device)
    src_image = torch.randn((b, k, 3, h, w), generator=gen, device=device)
    depth = _depth_maps(gen, (b,), dh, dw, mix["depth"], device)
    src_depth = _depth_maps(gen, (b, k), dh, dw, mix["depth"], device)
    world_T_cur = _rot("y", _uniform(gen, (b,), *geo["reference_yaw"],
                                     device=device))
    world_T_cur[:, :3, 3] = _uniform(gen, (b, 3), *geo["reference_position"],
                                     device=device)
    rel = (_rot("x", _uniform(gen, (b, k), *geo["source_pitch"],
                              device=device))
           @ _rot("y", _uniform(gen, (b, k), *geo["source_yaw"],
                                device=device)))
    rel[..., :3, 3] = _uniform(gen, (b, k, 3), *geo["source_offset"],
                               device=device)
    world_T_src = world_T_cur[:, None] @ rel
    K_s0, invK_s0 = _intrinsics(b, k, h, w, 2, device)
    K_m, invK_m = _intrinsics(b, k, h, w, 2 ** (m + 1), device)
    cur = {
        "image_b3hw": cur_image, "depth_bhw": depth,
        "mask_b_bhw": torch.isfinite(depth), "invK_s0_b44": invK_s0,
        f"invK_s{m}_b44": invK_m, "world_T_cam_b44": world_T_cur,
        "cam_T_world_b44": torch.linalg.inv(world_T_cur),
    }
    src = {
        "image_b3hw": src_image, "depth_bkhw": src_depth, "K_s0_bk44": K_s0,
        f"K_s{m}_b44": K_m, "world_T_cam_b44": world_T_src,
        "cam_T_world_b44": torch.linalg.inv(world_T_src),
    }
    return {"cur": cur, "src": src}


def make_pool(config: Dict, mix: Dict, seed: int, device) -> List[Dict]:
    """The mix's pool of `pool` distinct batches."""
    return [make_batch(config, mix, seed, i, device)
            for i in range(mix["pool"])]


def flip_coins(seed: int, count: int) -> List[bool]:
    """The first `count` flip coins of the generator `flip_generator`
    gives, heads with probability 1/2, as the training step draws them."""
    gen = flip_generator(seed)
    return [bool(torch.rand((), generator=gen) < 0.5) for _ in range(count)]


def flip_generator(seed: int) -> torch.Generator:
    """The host generator of the training step's flip coins."""
    gen = torch.Generator()
    gen.manual_seed(derived_seed(seed, "flips"))
    return gen
