"""ArcFace resnet_face18: grayscale 128×128 face → 512-d identity embedding.

Counterpart of `adaface_tpu/models/arcface.py` (`arcface_embed`,
`:152-172`), plain PyTorch (XLA code there, no Pallas kernel): IRBlocks
[2, 2, 2, 2] with squeeze-excitation, inference-mode BatchNorm (running
statistics as buffers), PReLU with one slope a block that both of the
block's activations share (`:108-120`), a 2×2 max-pool after the stem, and
torch's NCHW flatten before `fc5`. Parameter names mirror the JAX pytree.
`convert_arcface_state_dict` maps the torch `arcface-resnet18_110.pth`
layout onto this module.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import normal_

LAYERS = [2, 2, 2, 2]
CHANNELS = [64, 128, 256, 512]
STRIDES = [1, 2, 2, 2]


class InferenceBatchNorm(nn.Module):
    """BatchNorm with frozen statistics: (x − mean)·rsqrt(var + 1e-5)·w + b
    over dim 1; the JAX `_bn` (scale, bias, mean, var) → weight, bias,
    running_mean, running_var."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


class PReLU(nn.Module):
    """One learned slope `a` for every channel."""

    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.a * x)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


class SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = nn.Linear(c, c // 16)
        self.prelu = PReLU()
        self.fc2 = nn.Linear(c // 16, c)

    def forward(self, x):
        s = torch.sigmoid(self.fc2(self.prelu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class IRBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, use_se: bool = True):
        super().__init__()
        self.bn0 = InferenceBatchNorm(cin)
        self.conv1 = _conv3(cin, cin)
        self.bn1 = InferenceBatchNorm(cin)
        self.prelu = PReLU()
        self.conv2 = _conv3(cin, cout, stride)
        self.bn2 = InferenceBatchNorm(cout)
        self.se = SE(cout) if use_se else None
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.ModuleDict({
                "conv": nn.Conv2d(cin, cout, 1, stride, bias=False),
                "bn": InferenceBatchNorm(cout)})

    def forward(self, x):
        out = self.prelu(self.bn1(self.conv1(self.bn0(x))))
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = self.se(out)
        residual = x
        if self.downsample is not None:
            residual = self.downsample["bn"](self.downsample["conv"](x))
        return self.prelu(out + residual)


class ArcFace(nn.Module):
    """x [B, 1, 128, 128] grayscale in [−1, 1] → [B, 512] (not normalised);
    convolutions in full fp32 (`core.device.fp32_convolutions`)."""

    def __init__(self, use_se: bool = True):
        super().__init__()
        self.conv1 = _conv3(1, 64)
        self.bn1 = InferenceBatchNorm(64)
        self.prelu = PReLU()
        stages, cin = [], 64
        for planes, n, stride in zip(CHANNELS, LAYERS, STRIDES):
            stages.append(nn.ModuleList(
                IRBlock(cin if i == 0 else planes, planes, stride if i == 0 else 1, use_se)
                for i in range(n)))
            cin = planes
        self.layers = nn.ModuleList(stages)
        self.bn4 = InferenceBatchNorm(512)
        self.fc5 = nn.Linear(512 * 8 * 8, 512)
        self.bn5 = InferenceBatchNorm(512)

    @fp32_convolutions()
    def forward(self, x):
        h = F.max_pool2d(self.prelu(self.bn1(self.conv1(x))), 2)
        for blocks in self.layers:
            for blk in blocks:
                h = blk(h)
        h = self.bn4(h)
        return self.bn5(self.fc5(h.flatten(1)))


def init_arcface_weights_(model: ArcFace, gen: torch.Generator) -> None:
    """`init_arcface_params` scales: conv weights N(0, 2/fan_in), the SE's
    dense layers N(0, 1/fan_in), fc5 N(0, 0.01²), biases 0, BN 1/0 with
    statistics 0/1, PReLU slopes 0.25."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, math.sqrt(2.0 / m.weight[0].numel()), gen)
        elif isinstance(m, nn.Linear):
            normal_(m.weight, 0.01 if m is model.fc5 else m.in_features ** -0.5, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, InferenceBatchNorm):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                         (m.running_var, 1.0)):
                nn.init.constant_(t, v)
        elif isinstance(m, PReLU):
            nn.init.constant_(m.a, 0.25)


def convert_arcface_state_dict(sd: Mapping[str, np.ndarray],
                               use_se: bool = True) -> dict[str, torch.Tensor]:
    """torch resnet_face18 state dict (`conv1`, `layer1.0.bn0`, `se.fc.0`,
    `downsample.0/1`, `prelu.weight`, …) → this module's state dict."""
    out: dict[str, torch.Tensor] = {}

    def t(key):
        return torch.as_tensor(np.asarray(sd[key]), dtype=torch.float32)

    def copy(src, dst, leaves=("weight",)):
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = t(f"{src}.{leaf}")

    def bn(src, dst):
        copy(src, dst, ("weight", "bias", "running_mean", "running_var"))

    def prelu(src, dst):
        out[f"{dst}.a"] = t(f"{src}.weight").reshape(-1)

    copy("conv1", "conv1")
    bn("bn1", "bn1")
    prelu("prelu", "prelu")
    for li, n in enumerate(LAYERS):
        for bi in range(n):
            src, dst = f"layer{li + 1}.{bi}", f"layers.{li}.{bi}"
            bn(f"{src}.bn0", f"{dst}.bn0")
            copy(f"{src}.conv1", f"{dst}.conv1")
            bn(f"{src}.bn1", f"{dst}.bn1")
            prelu(f"{src}.prelu", f"{dst}.prelu")
            copy(f"{src}.conv2", f"{dst}.conv2")
            bn(f"{src}.bn2", f"{dst}.bn2")
            if use_se:
                copy(f"{src}.se.fc.0", f"{dst}.se.fc1", ("weight", "bias"))
                prelu(f"{src}.se.fc.1", f"{dst}.se.prelu")
                copy(f"{src}.se.fc.2", f"{dst}.se.fc2", ("weight", "bias"))
            if f"{src}.downsample.0.weight" in sd:
                copy(f"{src}.downsample.0", f"{dst}.downsample.conv")
                bn(f"{src}.downsample.1", f"{dst}.downsample.bn")
    bn("bn4", "bn4")
    copy("fc5", "fc5", ("weight", "bias"))
    bn("bn5", "bn5")
    return out
