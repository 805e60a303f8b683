"""The plain reference of SimpleRecon's depth model (Sayed et al., ECCV
2022, "SimpleRecon: 3D Reconstruction Without 3D Convolutions";
nianticlabs/simplerecon): EfficientNetV2-S image prior, ResNet matching
encoder, the metadata-MLP feature volume (hero) or the dot-product cost
volume, the multi-scale cost-volume encoder and the UNet++ decoder.

Plain PyTorch in float32 (the caller turns TF32 off), NCHW, with the
reference state-dict names, so one state dict loads here and into the
measured program. The plane sweep is written out: the gather warp of
every source view at each plane, then the metadata and the MLP, in
chunks of 8 planes, each chunk recomputed in the backward
(`checkpoint_sweep`) so that a b16 step fits beside the program's state.

`precision="fp8"` is the control: every convolution's and linear
layer's operands and outputs, the matching features and the volume
rounded to fp8 (e4m3 forward, e5m2 gradients), where the program's
autocast rounds them to bf16.

Departures from the published model: none in the equations; batch norms
keep flax's running-statistics rule (biased batch variance), as the
program does.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from benchmark.reference import ops

HIDDEN = 128
PLANE_CHUNK = 8


def mlp_in_channels(k: int, c: int) -> int:
    """The metadata MLP's input width: k + 1 feature maps of c channels,
    10 metadata values a view and 4 more (202 at k=7, c=16)."""
    return c * (1 + k) + 10 * k + 4


class Precise(nn.Module):
    """A module whose products round their operands by `precision`."""
    precision = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rounded(x, self.precision)


class Conv2d(nn.Conv2d, Precise):
    """Conv2d with "zeros", "replicate" or TF "same" padding."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 groups=1, pad_mode="zeros"):
        nn.Conv2d.__init__(self, cin, cout, k, stride, padding, bias=bias,
                           groups=groups)
        self.pad_mode = pad_mode

    def forward(self, x):
        pad = 0
        if self.pad_mode == "same":
            ih, iw = x.shape[-2:]
            kh, kw = self.kernel_size
            sh, sw = self.stride
            ph = max((-(-ih // sh) - 1) * sh + kh - ih, 0)
            pw = max((-(-iw // sw) - 1) * sw + kw - iw, 0)
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        elif self.pad_mode == "replicate":
            ph, pw = self.padding
            x = F.pad(x, (pw, pw, ph, ph), mode="replicate")
        else:
            pad = self.padding
        return self.q(F.conv2d(self.q(x), self.q(self.weight), self.bias,
                               self.stride, pad, 1, self.groups))


class Linear(nn.Linear, Precise):
    def forward(self, x):
        return self.q(F.linear(self.q(x), self.q(self.weight), self.bias))


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm; in train mode running = 0.9 running + 0.1 batch, with
    the biased batch variance (flax's rule)."""

    def __init__(self, n, eps=1e-5):
        super().__init__(n, eps=eps, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean.detach())
            self.running_var.mul_(0.9).add_(0.1 * var.detach())
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
                * self.weight[None, :, None, None]
                + self.bias[None, :, None, None])


def instance_norm(x, eps=1e-5):
    mean = x.mean((2, 3), keepdim=True)
    var = x.var((2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


# --------------------------------------------------------------------------
# EfficientNetV2-S (timm names), features after stages 0, 1, 2, 4, 5
# --------------------------------------------------------------------------

V2_S = (("cn", 2, 1, 1, 24, 0.0), ("er", 4, 2, 4, 48, 0.0),
        ("er", 4, 2, 4, 64, 0.0), ("ir", 6, 2, 4, 128, 0.25),
        ("ir", 9, 1, 6, 160, 0.25), ("ir", 15, 2, 6, 256, 0.25))
V2_S_FEATURE_STAGES = (0, 1, 2, 4, 5)
V2_S_CHANNELS = (24, 48, 64, 160, 256)


def _conv(cin, cout, k, stride=1, groups=1):
    if k == 1:
        return Conv2d(cin, cout, 1, bias=False)
    return Conv2d(cin, cout, k, stride, bias=False, groups=groups,
                  pad_mode="same")


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = _conv(cin, cout, 3, stride)
        self.bn1 = BatchNorm2d(cout, 1e-3)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = F.silu(self.bn1(self.conv(x)))
        return out + x if self.has_skip else out


class EdgeResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_exp = _conv(cin, mid, 3, stride)
        self.bn1 = BatchNorm2d(mid, 1e-3)
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn2 = BatchNorm2d(cout, 1e-3)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return out + x if self.has_skip else out


class SqueezeExcite(nn.Module):
    def __init__(self, ch, rd):
        super().__init__()
        self.conv_reduce = Conv2d(ch, rd, 1)
        self.conv_expand = Conv2d(rd, ch, 1)

    def forward(self, x):
        s = F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.conv_expand(s))


class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand, se_ratio):
        super().__init__()
        mid = cin * expand
        self.conv_pw = _conv(cin, mid, 1)
        self.bn1 = BatchNorm2d(mid, 1e-3)
        self.conv_dw = _conv(mid, mid, 3, stride, groups=mid)
        self.bn2 = BatchNorm2d(mid, 1e-3)
        self.se = SqueezeExcite(mid, max(1, round(cin * se_ratio)))
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn3 = BatchNorm2d(cout, 1e-3)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = F.silu(self.bn1(self.conv_pw(x)))
        out = F.silu(self.bn2(self.conv_dw(out)))
        out = self.bn3(self.conv_pwl(self.se(out)))
        return out + x if self.has_skip else out


class EfficientNetV2S(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_stem = _conv(3, 24, 3, 2)
        self.bn1 = BatchNorm2d(24, 1e-3)
        stages, cin = [], 24
        for btype, repeats, stride, expand, cout, se in V2_S:
            blocks = []
            for i in range(repeats):
                s = stride if i == 0 else 1
                if btype == "cn":
                    blocks.append(ConvBnAct(cin, cout, s))
                elif btype == "er":
                    blocks.append(EdgeResidual(cin, cout, s, expand))
                else:
                    blocks.append(InvertedResidual(cin, cout, s, expand, se))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)

    def forward(self, x) -> List[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(x)))
        feats = []
        for i, stage in enumerate(self.blocks):
            x = stage(x)
            if i in V2_S_FEATURE_STAGES:
                feats.append(x)
        return feats


# --------------------------------------------------------------------------
# ResNet matching encoder (net.0 ... net.9 as in the published state dict)
# --------------------------------------------------------------------------

def blur_filter(channels: int) -> torch.Tensor:
    """The depthwise [1,3,3,1] x [1,3,3,1] / 64 filter, (C, 1, 4, 4)."""
    a = torch.tensor((1.0, 3.0, 3.0, 1.0))
    filt = a[:, None] * a[None, :]
    return (filt / filt.sum())[None, None].repeat(channels, 1, 1, 1)


class BlurPool(nn.Module):
    """antialiased_cnns.BlurPool(filt_size=4, stride=2)."""

    def __init__(self, channels):
        super().__init__()
        self.register_buffer("filt", blur_filter(channels))

    def forward(self, x):
        x = F.pad(x, (1, 2, 1, 2), mode="reflect")
        return F.conv2d(x, self.filt, stride=2, groups=x.shape[1])


class ResNetBasicBlock(nn.Module):
    def __init__(self, planes=64):
        super().__init__()
        self.conv1 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class ResnetMatchingEncoder(nn.Module):
    def __init__(self, num_ch_out=16):
        super().__init__()
        self.net = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            BatchNorm2d(64), nn.ReLU(),
            nn.Sequential(nn.MaxPool2d(2, stride=1), BlurPool(64)),
            nn.Sequential(ResNetBasicBlock(64), ResNetBasicBlock(64)),
            Conv2d(64, 128, 1), InstanceNorm(), nn.LeakyReLU(0.2),
            Conv2d(128, num_ch_out, 3, padding=1, pad_mode="replicate"),
            InstanceNorm())

    def forward(self, x):
        return self.net(x)


# --------------------------------------------------------------------------
# cost-volume encoder and UNet++ decoder
# --------------------------------------------------------------------------

class BasicBlock(nn.Module):
    """conv3x3 + bias, LeakyReLU(0.2), conv3x3 + bias, shortcut (1x1 conv
    when the channels change, 3x3 at stride 2), LeakyReLU(0.2)."""

    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, stride, padding=1)
        self.conv2 = Conv2d(cout, cout, 3, 1, padding=1)
        self.downsample = None
        if cin != cout or stride != 1:
            conv = (Conv2d(cin, cout, 1) if stride == 1
                    else Conv2d(cin, cout, 3, stride, padding=1))
            self.downsample = nn.Sequential(conv, nn.Identity())

    def forward(self, x):
        out = self.conv2(F.leaky_relu(self.conv1(x), 0.2))
        identity = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(out + identity, 0.2)


class CVEncoder(nn.Module):
    num_ch_outs = (64, 128, 256, 384)

    def __init__(self, num_ch_cv, num_ch_enc):
        super().__init__()
        self.convs = nn.ModuleDict()
        for i, cout in enumerate(self.num_ch_outs):
            cin = num_ch_cv if i == 0 else self.num_ch_outs[i - 1]
            self.convs[f"ds_conv_{i}"] = BasicBlock(cin, cout,
                                                    1 if i == 0 else 2)
            self.convs[f"conv_{i}"] = nn.Sequential(
                BasicBlock(num_ch_enc[i] + cout, cout), BasicBlock(cout, cout))

    def forward(self, x, img_feats):
        outputs = []
        for i in range(len(self.num_ch_outs)):
            x = self.convs[f"ds_conv_{i}"](x)
            x = self.convs[f"conv_{i}"](torch.cat([x, img_feats[i]], 1))
            outputs.append(x)
        return outputs


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class DepthDecoderPP(nn.Module):
    num_ch_dec = (64, 64, 128, 256)

    def __init__(self, num_ch_enc):
        super().__init__()
        dec = self.num_ch_dec
        self.convs = nn.ModuleDict()
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                cout = dec[i]
                cin = num_ch_enc[i + 1] if j == 1 else dec[i + 1]
                self.convs[f"diag_conv_{i + 1}{j - 1}"] = BasicBlock(cin, cout)
                cin = num_ch_enc[i] if j == 1 else dec[i]
                self.convs[f"right_conv_{i}{j - 1}"] = BasicBlock(cin, cout)
                total = 2 * cout
                if i + j != 4:
                    self.convs[f"up_conv_{i + 1}{j}"] = BasicBlock(dec[i + 1],
                                                                   cout)
                    total += cout
                self.convs[f"in_conv_{i}{j}"] = nn.Sequential(
                    BasicBlock(total, cout), BasicBlock(cout, cout))
        for i in range(4):
            self.convs[f"output_{i}"] = nn.Sequential(
                BasicBlock(dec[i], dec[i]) if i != 0 else nn.Identity(),
                Conv2d(dec[i], 1, 1))

    def forward(self, feats) -> Dict[str, torch.Tensor]:
        row = list(feats)
        outputs = {}
        for j in range(1, 5):
            prev, below = list(row), None
            for i in range(4 - j, -1, -1):
                inputs = [self.convs[f"right_conv_{i}{j - 1}"](prev[i]),
                          upsample2x(self.convs[f"diag_conv_{i + 1}{j - 1}"](
                              prev[i + 1]))]
                if i + j != 4:
                    inputs.append(upsample2x(
                        self.convs[f"up_conv_{i + 1}{j}"](below)))
                node = self.convs[f"in_conv_{i}{j}"](torch.cat(inputs, 1))
                row[i] = below = node
                if j == 4 - i:
                    outputs[f"log_depth_pred_s{i}_b1hw"] = \
                        self.convs[f"output_{i}"](node)
        return outputs


# --------------------------------------------------------------------------
# the plane sweep, written out
# --------------------------------------------------------------------------

def depth_planes(b, d, min_depth, max_depth, device):
    ramp = torch.linspace(0.0, 1.0, d, dtype=torch.float32, device=device)
    lo = torch.tensor(min_depth, dtype=torch.float32, device=device)
    hi = torch.tensor(max_depth, dtype=torch.float32, device=device)
    return torch.exp(torch.log(lo) + torch.log(hi / lo) * ramp)[None].expand(
        b, d)


def pixel_rays(invK_b44, h, w):
    return ops.pixel_grid(h, w, invK_b44.device) @ invK_b44[:, :3, :3
                                                            ].transpose(1, 2)


def sweep_warp(src_bkhwc, extr_bk44, Ks_bk44, invK_b44, planes_bd):
    """Every source view sampled at each plane point of each reference
    pixel: (world points (b, d, N, 3), samples (b, k, d, N, c), source
    depths (b, k, d, N), z > 0 (b, k, d, N), pixels (b, k, d, N, 2))."""
    b, k, h, w, c = src_bkhwc.shape
    d, n = planes_bd.shape[1], h * w
    world = pixel_rays(invK_b44, h, w)[:, None] * planes_bd[..., None, None]
    uvz = ops.project_points(world[:, None], Ks_bk44[:, :, None],
                             extr_bk44[:, :, None])
    pix, depths = uvz[..., :2], uvz[..., 2]
    scale = torch.tensor([2.0 / w, 2.0 / h], device=pix.device)
    samples = ops.grid_sample(src_bkhwc.reshape(b * k, h, w, c),
                              (pix * scale - 1.0).reshape(b * k, d * n, 2)
                              ).reshape(b, k, d, n, c)
    return world, samples, depths, (depths > 0).float(), pix


def source_mask(src_bkhwc, extr, Ks, invK, planes_bd, h, w):
    """Where any view sees the farthest plane in front of it and any view
    lands 2 pixels inside its border: (b, h, w) bool."""
    _, _, _, mask, pix = sweep_warp(src_bkhwc[..., :1], extr, Ks, invK,
                                    planes_bd[:, -1:])
    x, y = pix[:, :, -1, :, 0], pix[:, :, -1, :, 1]
    inside = (x > 2) & (x < w - 2) & (y > 2) & (y < h - 2)
    ok = torch.any(mask[:, :, -1] > 0, 1) & torch.any(inside, 1)
    return ok.reshape(-1, h, w)


def metadata_inputs(src, cur_bNc, extr, Ks, invK, planes, pose_meta_bk3,
                    loc_bk3):
    """The MLP's input (b, dc, N, 202) for a chunk of planes, channels
    [samples (k*c, view-major) | ref (c)] mask(k) depth(k) plane(1)
    dot(k) ray angle(k) [ref ray (3) | src rays (3k)] penalty(k) R(k)
    t(k)."""
    b, k, h, w, c = src.shape
    dc, n = planes.shape[1], h * w
    world, samples, depths, mask, _ = sweep_warp(src, extr, Ks, invK, planes)
    dot = torch.einsum("bkdnc,bnc->bkdn", samples, cur_bNc) * mask
    cur_rays = ops.normalize(world)
    src_rays = ops.normalize(world[:, None] - loc_bk3[:, :, None, None, :])
    angle = ops.cosine_similarity(cur_rays[:, None], src_rays)
    return torch.cat([
        samples.permute(0, 2, 3, 1, 4).reshape(b, dc, n, k * c),
        cur_bNc[:, None].expand(b, dc, n, c),
        mask.permute(0, 2, 3, 1), depths.permute(0, 2, 3, 1),
        planes[:, :, None, None].expand(b, dc, n, 1),
        dot.permute(0, 2, 3, 1), angle.permute(0, 2, 3, 1), cur_rays,
        src_rays.permute(0, 2, 3, 1, 4).reshape(b, dc, n, 3 * k),
        pose_meta_bk3.transpose(1, 2).reshape(b, 1, 1, 3 * k
                                              ).expand(b, dc, n, 3 * k),
    ], -1)


class MLP(nn.Module):
    """Linear layers with LeakyReLU(0.01) between them (`net.0`, `net.2`,
    `net.4`)."""

    def __init__(self, channels):
        super().__init__()
        layers = []
        for i in range(len(channels) - 1):
            layers += [Linear(channels[i], channels[i + 1]),
                       nn.LeakyReLU(0.01)]
        self.net = nn.Sequential(*layers[:-1])

    def forward(self, x):
        return self.net(x)


class MLPFeatureVolume(nn.Module):
    def __init__(self, d, min_depth, max_depth, c, k):
        super().__init__()
        self.d, self.min_depth, self.max_depth = d, min_depth, max_depth
        self.mlp = MLP([mlp_in_channels(k, c), HIDDEN, HIDDEN, 1])
        self.checkpoint_sweep = True

    def _chunk(self, src, cur, extr, Ks, invK, planes, meta, loc):
        feats = metadata_inputs(src, cur, extr, Ks, invK, planes, meta, loc)
        return self.mlp(feats)[..., 0]

    def forward(self, cur_bhwc, src_bkhwc, extr, poses, Ks, invK):
        b, h, w, c = cur_bhwc.shape
        planes = depth_planes(b, self.d, self.min_depth, self.max_depth,
                              cur_bhwc.device)
        penalty, r, t = ops.pose_distance(poses)
        meta = torch.stack([penalty, r, t], -1)
        loc = poses[..., :3, 3]
        cur = cur_bhwc.reshape(b, h * w, c)
        chunks = []
        for s in range(0, self.d, PLANE_CHUNK):
            args = (src_bkhwc, cur, extr, Ks, invK,
                    planes[:, s:s + PLANE_CHUNK], meta, loc)
            if self.checkpoint_sweep and torch.is_grad_enabled():
                chunks.append(ckpt.checkpoint(self._chunk, *args,
                                              use_reentrant=False))
            else:
                chunks.append(self._chunk(*args))
        return torch.cat(chunks, 1), planes


class DotProductCostVolume(nn.Module):
    def __init__(self, d, min_depth, max_depth):
        super().__init__()
        self.d, self.min_depth, self.max_depth = d, min_depth, max_depth
        self.checkpoint_sweep = True

    @staticmethod
    def _chunk(src, cur, extr, Ks, invK, planes):
        _, samples, _, mask, _ = sweep_warp(src, extr, Ks, invK, planes)
        return (torch.einsum("bkdnc,bnc->bkdn", samples, cur) * mask).sum(1)

    def forward(self, cur_bhwc, src_bkhwc, extr, poses, Ks, invK):
        b, h, w, c = cur_bhwc.shape
        planes = depth_planes(b, self.d, self.min_depth, self.max_depth,
                              cur_bhwc.device)
        cur = cur_bhwc.reshape(b, h * w, c)
        chunks = []
        for s in range(0, self.d, PLANE_CHUNK):
            args = (src_bkhwc, cur, extr, Ks, invK,
                    planes[:, s:s + PLANE_CHUNK])
            if self.checkpoint_sweep and torch.is_grad_enabled():
                chunks.append(ckpt.checkpoint(self._chunk, *args,
                                              use_reentrant=False))
            else:
                chunks.append(self._chunk(*args))
        return torch.cat(chunks, 1), planes


# --------------------------------------------------------------------------
# the depth model
# --------------------------------------------------------------------------

class DepthModel(nn.Module):
    """`feature_volume_type` "mlp_feature_volume" (hero) or
    "simple_cost_volume" (dot product); matching scale 1. The matching
    encoder is `matching_model`, by default the ResNet encoder: another
    reference passes its own, which maps (n, 3, h, w) images to
    (n, matching_feature_dims, h / 4, w / 4) features."""

    def __init__(self, feature_volume_type="mlp_feature_volume",
                 matching_num_depth_bins=64, min_matching_depth=0.25,
                 max_matching_depth=5.0, matching_feature_dims=16,
                 model_num_views=8, matching_model=None):
        super().__init__()
        d = matching_num_depth_bins
        self.encoder = EfficientNetV2S()
        self.matching_model = (
            ResnetMatchingEncoder(matching_feature_dims)
            if matching_model is None else matching_model)
        if feature_volume_type == "simple_cost_volume":
            self.cost_volume = DotProductCostVolume(d, min_matching_depth,
                                                    max_matching_depth)
        elif feature_volume_type == "mlp_feature_volume":
            self.cost_volume = MLPFeatureVolume(
                d, min_matching_depth, max_matching_depth,
                matching_feature_dims, model_num_views - 1)
        else:
            raise ValueError(feature_volume_type)
        self.cost_volume_net = CVEncoder(d, V2_S_CHANNELS[1:])
        self.depth_decoder = DepthDecoderPP(
            [V2_S_CHANNELS[0]] + list(CVEncoder.num_ch_outs))
        self.set_precision("float32")

    def set_precision(self, precision: str) -> "DepthModel":
        """"float32", or the control's "fp8"."""
        ops.rounded(torch.zeros(1), precision)
        self.precision = precision
        for mod in self.modules():
            if isinstance(mod, Precise):
                mod.precision = precision
        return self

    def set_checkpoint_sweep(self, on: bool) -> "DepthModel":
        self.cost_volume.checkpoint_sweep = on
        return self

    def forward(self, cur: Dict, src: Dict, flip: bool = False,
                return_mask: bool = False) -> Dict[str, torch.Tensor]:
        q = lambda x: ops.rounded(x, self.precision)  # noqa: E731
        cur_image, src_image = cur["image_b3hw"], src["image_b3hw"]
        b, k = src_image.shape[:2]
        h, w = cur_image.shape[-2:]
        src_cam_T_cur = (src["cam_T_world_b44"]
                         @ cur["world_T_cam_b44"][:, None])
        cur_cam_T_src = (cur["cam_T_world_b44"][:, None]
                         @ src["world_T_cam_b44"])
        if flip:
            cur_image = torch.flip(cur_image, (-1,))
            src_image = torch.flip(src_image, (-1,))
        cur_feats = self.encoder(cur_image)
        matching = self.matching_model(torch.cat(
            [cur_image[:, None], src_image], 1).reshape(b * (k + 1), 3, h, w))
        mc, mh, mw = matching.shape[1:]
        matching = q(matching).reshape(b, k + 1, mc, mh, mw).permute(
            0, 1, 3, 4, 2)
        if flip:
            matching = torch.flip(matching, (3,))
        Ks, invK = src["K_s1_b44"], cur["invK_s1_b44"]
        volume_bdN, planes = self.cost_volume(
            matching[:, 0], matching[:, 1:], src_cam_T_cur, cur_cam_T_src,
            Ks, invK)
        volume_bhwd = volume_bdN.transpose(1, 2).reshape(b, mh, mw, -1)
        idx = torch.argmax(volume_bhwd.detach(), -1)
        lowest = torch.gather(planes, 1, idx.reshape(b, -1)).reshape(idx.shape)
        mask = (source_mask(matching[:, 1:].detach(), src_cam_T_cur, Ks, invK,
                            planes, mh, mw) if return_mask else None)
        volume = q(volume_bhwd.permute(0, 3, 1, 2))
        if flip:
            volume = torch.flip(volume, (-1,))
        cv_feats = self.cost_volume_net(volume, cur_feats[1:])
        depth_outputs = self.depth_decoder(cur_feats[:1] + cv_feats)
        outputs = {}
        for key, log_depth in depth_outputs.items():
            log_depth = log_depth.permute(0, 2, 3, 1)
            if flip:
                log_depth = torch.flip(log_depth, (2,))
            key = key.replace("_b1hw", "_bhw1")
            outputs[key] = log_depth
            outputs[key.replace("log_", "")] = torch.exp(
                torch.clamp(log_depth, -8.0, 8.0))
        if flip:
            lowest = torch.flip(lowest, (2,))
        outputs["lowest_cost_bhw"] = lowest
        outputs["overall_mask_bhw"] = mask
        return outputs


MODEL_KEYS = ("feature_volume_type", "matching_num_depth_bins",
              "min_matching_depth", "max_matching_depth",
              "matching_feature_dims", "model_num_views")


def build(config: Dict, matching_model=None) -> DepthModel:
    """The reference model of `config` (its own init), with
    `matching_model` as its matching encoder where given."""
    return DepthModel(**{k: config[k] for k in MODEL_KEYS},
                      matching_model=matching_model)
