"""BiSeNet face parser (ResNet18 context path, 19 classes).

Counterpart of `adaface_tpu/models/bisenet.py`: the modules mirror
`init_bisenet_params`'s tree key for key (`layers.1.0.down.bn` is
`p["layers"][1][0]["down"]["bn"]`), and `BiSeNet.forward` follows
`bisenet_forward` in both modes. NCHW images in, NCHW logits out; in train
mode (`model.train()`) the forward returns `(out, out16, out32)`.

Inside, activations are NCHW tensors in channels_last memory, so each
one permuted to NHWC is a contiguous [N·H·W, C] view: what the BN kernels
read, and the layout cuDNN prefers. The train-mode BNs (31 per forward:
the stem, 19 in the ResNet blocks, 2 in each attention-refinement module,
the two context heads, the global-context conv, the FFM and the three
output heads) go through `ops.fused_norm.fused_bn_act`. Eval-mode BN uses
the running statistics and is plain PyTorch, as the JAX package used XLA.

Running statistics: the JAX train mode never updates `mean`/`var`. Here
train mode updates them as torch's BatchNorm does (momentum 0.1, unbiased
variance), from the mean and rstd the statistics pass returns.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.ops.fused_norm import fused_bn_act_stats
from adaface_tpu_torch.ops.resize import resize_bilinear_align_corners, resize_nearest
from adaface_tpu_torch.tools.convert_sd import arr

N_CLASSES = 19
# face-parsing class ids (CelebAMask-HQ convention): skin 1 … neck 14 etc.
FACE_CLASS_IDS = tuple(range(1, 14))
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _conv(cin, cout, k, stride=1, padding=None):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if padding is None else padding,
                     bias=False)


class BatchNormAct(nn.Module):
    """BN with ReLU (`relu`) or none; the fused kernels in train mode."""

    def __init__(self, c: int, relu: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.relu = relu

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             training=False, eps=BN_EPS)
            return F.relu(y) if self.relu else y
        y, mean, rstd = fused_bn_act_stats(x.permute(0, 2, 3, 1), self.weight, self.bias,
                                           slope=0.0 if self.relu else 1.0, eps=BN_EPS)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            var = (rstd.pow(-2) - BN_EPS) * (n / max(n - 1, 1))
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), BN_MOMENTUM)
            self.running_var.lerp_(var.to(self.running_var.dtype), BN_MOMENTUM)
        return y.permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """`{"conv": {"w"}, "bn": {...}}`: conv (no bias), BN, optional ReLU."""

    def __init__(self, cin, cout, k=3, stride=1, padding=None, relu=True):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride, padding)
        self.bn = BatchNormAct(cout, relu)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = BatchNormAct(cout)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = BatchNormAct(cout, relu=False)
        self.down = (ConvBN(cin, cout, 1, stride, 0, relu=False)
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        h = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        return F.relu(h + (x if self.down is None else self.down(x)))


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBN(cin, cout)
        self.atten = ConvBN(cout, cout, 1, padding=0, relu=False)

    def forward(self, x):
        feat = self.conv(x)
        return feat * torch.sigmoid(self.atten(feat.mean((2, 3), keepdim=True)))


class FeatureFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.convblk = ConvBN(256, 256, 1)
        self.conv1 = _conv(256, 64, 1, padding=0)
        self.conv2 = _conv(64, 256, 1, padding=0)

    def forward(self, feat8, f16_up):
        feat = self.convblk(torch.cat([feat8, f16_up], dim=1))
        att = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean((2, 3), keepdim=True)))))
        return feat * att + feat


class Head(nn.Module):
    def __init__(self, cin, cmid):
        super().__init__()
        self.conv = ConvBN(cin, cmid)
        self.cls = _conv(cmid, N_CLASSES, 1, padding=0)

    def forward(self, x, out_hw):
        # the final logits upsample is bilinear align_corners=True in the
        # reference (`model.py:251-253`); internal fusions stay nearest
        return resize_bilinear_align_corners(self.cls(self.conv(x)), out_hw, spatial_axes=(2, 3))


def _upsample_to(x, hw):
    return resize_nearest(x, hw, spatial_axes=(2, 3)).contiguous(
        memory_format=torch.channels_last)


class BiSeNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNormAct(64)
        layers, cin = [], 64
        for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
            layers.append(nn.ModuleList([BasicBlock(cin, cout, stride),
                                         BasicBlock(cout, cout, 1)]))
            cin = cout
        self.layers = nn.ModuleList(layers)
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head16 = ConvBN(128, 128)
        self.conv_head32 = ConvBN(128, 128)
        self.conv_avg = ConvBN(512, 128, 1)
        self.ffm = FeatureFusion()
        self.out = Head(256, 256)
        self.out16 = Head(128, 64)
        self.out32 = Head(128, 64)

    def forward(self, x):
        """x [B, 3, H, W] normalized (imagenet) → logits [B, 19, H, W]
        (and the aux16/aux32 heads in train mode)."""
        hw = tuple(x.shape[2:])
        h = self.bn1(self.conv1(x.contiguous(memory_format=torch.channels_last)))
        # torch MaxPool2d(3, 2, padding=1): symmetric pads, as `bisenet.py:154-158`
        h = F.max_pool2d(h, 3, 2, 1)
        feats = []
        for blocks in self.layers:
            for block in blocks:
                h = block(h)
            feats.append(h)
        feat8, feat16, feat32 = feats[1:]

        avg = self.conv_avg(feat32.mean((2, 3), keepdim=True))  # global context
        f32 = self.arm32(feat32) + avg
        f32_up = self.conv_head32(_upsample_to(f32, feat16.shape[2:]))
        f16 = self.arm16(feat16) + f32_up
        f16_up = self.conv_head16(_upsample_to(f16, feat8.shape[2:]))

        out = self.out(self.ffm(feat8, f16_up), hw)
        if self.training:
            return out, self.out16(f16_up, hw), self.out32(f32_up, hw)
        return out


def init_bisenet_weights_(model: BiSeNet, gen: torch.Generator) -> None:
    """`init_bisenet_params` scales: conv weights N(0, 2/fan_in), BN scale 1,
    bias 0, mean 0, var 1; drawn on the generator's device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(2.0 / m.weight[0].numel())
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen, device=gen.device) * std)
            elif isinstance(m, BatchNormAct):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def build_bisenet(device, gen: torch.Generator) -> BiSeNet:
    """A trainable fp32 BiSeNet on `device`, channels_last, random weights
    at the JAX initialiser's scales, in train mode."""
    with torch.device("meta"):
        model = BiSeNet()
    model = model.to_empty(device=device)
    init_bisenet_weights_(model, gen)
    return model.to(memory_format=torch.channels_last).train()


def parsing_to_face_mask(parsing: np.ndarray, face_classes=FACE_CLASS_IDS) -> np.ndarray:
    """argmax parsing [H, W] → binary face mask (skin+features), the
    binarization step of `gen_masks.py`."""
    return np.isin(parsing, np.asarray(face_classes)).astype(np.uint8) * 255


def convert_bisenet_state_dict(sd) -> dict:
    """The torch face-parsing BiSeNet checkpoint (`79999_iter.pth` layout) →
    the JAX package's BiSeNet tree (`adaface_tpu/models/bisenet.py:208`), in
    numpy; `core.bridge.load` (or `tools.convert_sd.load_module`) lands it in
    `BiSeNet`."""

    def conv(pre):
        return {"w": arr(np.asarray(sd[f"{pre}.weight"]).transpose(2, 3, 1, 0).copy())}

    def bn(pre):
        return {"scale": arr(sd[f"{pre}.weight"]), "bias": arr(sd[f"{pre}.bias"]),
                "mean": arr(sd[f"{pre}.running_mean"]), "var": arr(sd[f"{pre}.running_var"])}

    def cbr(pre):
        return {"conv": conv(f"{pre}.conv"), "bn": bn(f"{pre}.bn")}

    def block(pre):
        p = {"conv1": conv(f"{pre}.conv1"), "bn1": bn(f"{pre}.bn1"),
             "conv2": conv(f"{pre}.conv2"), "bn2": bn(f"{pre}.bn2")}
        if f"{pre}.downsample.0.weight" in sd:
            p["down"] = {"conv": conv(f"{pre}.downsample.0"), "bn": bn(f"{pre}.downsample.1")}
        return p

    def arm(pre):
        return {"conv": cbr(f"{pre}.conv"),
                "atten": {"conv": conv(f"{pre}.conv_atten"), "bn": bn(f"{pre}.bn_atten")}}

    def head(pre):
        return {"conv": cbr(f"{pre}.conv"), "cls": conv(f"{pre}.conv_out")}

    cp = "cp.resnet"
    return {"conv1": conv(f"{cp}.conv1"), "bn1": bn(f"{cp}.bn1"),
            "layers": [[block(f"{cp}.layer{li}.{bi}") for bi in range(2)] for li in range(1, 5)],
            "arm16": arm("cp.arm16"), "arm32": arm("cp.arm32"),
            "conv_head16": cbr("cp.conv_head16"), "conv_head32": cbr("cp.conv_head32"),
            "conv_avg": cbr("cp.conv_avg"),
            "ffm": {"convblk": cbr("ffm.convblk"), "conv1": conv("ffm.conv1"),
                    "conv2": conv("ffm.conv2")},
            "out": head("conv_out"), "out16": head("conv_out16"), "out32": head("conv_out32")}


def load_bisenet(path: str | None, device, gen: torch.Generator | None = None) -> BiSeNet:
    """An eval-mode fp32 BiSeNet on `device`: from the checkpoint `path`,
    either the port's own (the state dict `train.face_parsing_train.main`
    saves) or the reference's (`79999_iter.pth`, through
    `convert_bisenet_state_dict`); random from `gen` when `path` is None."""
    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.tools.ckpt_lib import load_state_dict

    if path is None:
        return build_bisenet(device, gen).requires_grad_(False).eval()
    sd = load_state_dict(path)
    with torch.device("meta"):
        model = BiSeNet()
    model = model.to_empty(device=device)
    if set(sd) == set(model.state_dict()):
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    else:
        bridge.load(model, convert_bisenet_state_dict(sd))
    return model.requires_grad_(False).to(memory_format=torch.channels_last).eval()
