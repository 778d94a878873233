"""RetinaFace face detector (MobileNet-0.25 backbone).

Counterpart of `adaface_tpu/models/retinaface.py`, plain PyTorch (XLA code
there, no Pallas kernel): `retinaface_forward` (MobileNetV1-0.25 → 3-level
FPN with nearest upsampling → SSH context modules → class, box and landmark
heads, `:143-185`) runs on the module's device; the anchors, box decoding
and NMS (`:188-231`) are host numpy, copied, as is the client
(`RetinaFaceClient`, `:234-295`). Parameter names mirror the JAX pytree;
`convert_retinaface_state_dict` maps the Pytorch_Retinaface
`mobilenet0.25_Final.pth` layout onto this module.
"""

from __future__ import annotations

import math
from itertools import product
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import normal_
from adaface_tpu_torch.models.arcface import InferenceBatchNorm
from adaface_tpu_torch.ops.resize import resize_nearest

MIN_SIZES = [[16, 32], [64, 128], [256, 512]]
STEPS = [8, 16, 32]
VARIANCES = (0.1, 0.2)
FPN_CH = 64
N_ANCHORS = 2
# (cin, cout, stride) of the depthwise-separable blocks
STAGE1 = [(8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)]
STAGE2 = [(64, 128, 2)] + [(128, 128, 1)] * 5
STAGE3 = [(128, 256, 2), (256, 256, 1)]


def _bn_act(bn: InferenceBatchNorm, x, leaky: float):
    """BN, then leaky ReLU of slope `leaky` (ReLU at 0); none for leaky < 0."""
    y = bn(x)
    return torch.where(y >= 0, y, y * leaky) if leaky >= 0 else y


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups, bias=False)
        self.bn = InferenceBatchNorm(cout)

    def forward(self, x, leaky: float):
        return _bn_act(self.bn, self.conv(x), leaky)


class DepthwiseSeparable(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.dw = ConvBN(cin, cin, 3, stride, groups=cin)
        self.pw = ConvBN(cin, cout, 1)

    def forward(self, x):
        return self.pw(self.dw(x, 0.1), 0.1)


class SSH(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv3x3 = ConvBN(FPN_CH, FPN_CH // 2)
        self.conv5x5_1 = ConvBN(FPN_CH, FPN_CH // 4)
        self.conv5x5_2 = ConvBN(FPN_CH // 4, FPN_CH // 4)
        self.conv7x7_2 = ConvBN(FPN_CH // 4, FPN_CH // 4)
        self.conv7x7_3 = ConvBN(FPN_CH // 4, FPN_CH // 4)

    def forward(self, x):
        c51 = self.conv5x5_1(x, 0.1)
        c71 = self.conv7x7_2(c51, 0.1)
        out = torch.cat([self.conv3x3(x, -1), self.conv5x5_2(c51, -1),
                         self.conv7x7_3(c71, -1)], dim=1)
        return F.relu(out)


class Head(nn.Module):
    """1×1 conv with its bias a leaf of the head (`heads.class.0.b`)."""

    def __init__(self, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(FPN_CH, cout, 1, bias=False)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, per_anchor: int):
        y = self.conv(x) + self.bias[:, None, None]
        return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, per_anchor)


class RetinaFace(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.ModuleDict({
            "stage1": nn.ModuleList([ConvBN(3, 8, 3, 2)]
                                    + [DepthwiseSeparable(*a) for a in STAGE1]),
            "stage2": nn.ModuleList(DepthwiseSeparable(*a) for a in STAGE2),
            "stage3": nn.ModuleList(DepthwiseSeparable(*a) for a in STAGE3)})
        self.fpn = nn.ModuleDict({
            "output1": ConvBN(64, FPN_CH, 1), "output2": ConvBN(128, FPN_CH, 1),
            "output3": ConvBN(256, FPN_CH, 1), "merge1": ConvBN(FPN_CH, FPN_CH),
            "merge2": ConvBN(FPN_CH, FPN_CH)})
        self.ssh = nn.ModuleList(SSH() for _ in range(3))
        self.heads = nn.ModuleDict({
            name: nn.ModuleList(Head(N_ANCHORS * k) for _ in range(3))
            for name, k in (("class", 2), ("bbox", 4), ("landmark", 10))})

    @fp32_convolutions()
    def forward(self, images):
        """images [B, 3, H, W] (BGR minus (104, 117, 123)) → (loc [B, A, 4],
        conf [B, A, 2] softmaxed, landmarks [B, A, 10]); convolutions in full
        fp32 (`core.device.fp32_convolutions`)."""
        s1, s2, s3 = (self.body[k] for k in ("stage1", "stage2", "stage3"))
        h = s1[0](images, 0.1)
        for blk in s1[1:]:
            h = blk(h)
        c3 = h
        for blk in s2:
            h = blk(h)
        c4 = h
        for blk in s3:
            h = blk(h)
        f = self.fpn
        o1, o2, o3 = (f[f"output{i}"](c, 0.1) for i, c in ((1, c3), (2, c4), (3, h)))
        o2 = f["merge2"](o2 + resize_nearest(o3, o2.shape[2:]), 0.1)
        o1 = f["merge1"](o1 + resize_nearest(o2, o1.shape[2:]), 0.1)
        feats = [ssh(o) for ssh, o in zip(self.ssh, (o1, o2, o3))]
        loc, conf, landms = (
            torch.cat([head(x, k) for head, x in zip(self.heads[name], feats)], dim=1)
            for name, k in (("bbox", 4), ("class", 2), ("landmark", 10)))
        return loc, torch.softmax(conf, dim=-1), landms


def init_retinaface_weights_(model: RetinaFace, gen: torch.Generator) -> None:
    """`init_retinaface_params` scales: conv weights N(0, 2/fan_in) (fan_in
    per group), head biases 0, BN 1/0 with statistics 0/1."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, math.sqrt(2.0 / m.weight[0].numel()), gen)
        elif isinstance(m, InferenceBatchNorm):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0),
                         (m.running_var, 1.0)):
                nn.init.constant_(t, v)
        elif isinstance(m, Head):
            nn.init.zeros_(m.bias)


def prior_boxes(image_size: tuple[int, int]) -> np.ndarray:
    """[A, 4] anchors (cx, cy, w, h), normalized (prior-box protocol)."""
    h, w = image_size
    anchors = []
    for step, sizes in zip(STEPS, MIN_SIZES):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        for i, j in product(range(fh), range(fw)):
            for ms in sizes:
                anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h, ms / w, ms / h])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """SSD-style decode → [A, 4] (x0, y0, x1, y1), normalized."""
    v0, v1 = VARIANCES
    cxy = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)


def nms(boxes: np.ndarray, scores: np.ndarray, thres: float = 0.4) -> list[int]:
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (area_i + area_r - inter + 1e-9)
        order = rest[iou <= thres]
    return keep


class RetinaFaceClient:
    """detect_faces / crop_faces protocol of the reference client, the
    network on its module's device."""

    BGR_MEAN = np.asarray([104.0, 117.0, 123.0], np.float32)

    def __init__(self, model: RetinaFace):
        self.model = model
        self.device = next(model.parameters()).device
        self._priors: dict[tuple[int, int], np.ndarray] = {}

    @torch.inference_mode()
    def detect_faces(self, image_rgb: np.ndarray, conf_thres: float = 0.5,
                     T: int = 20) -> list[dict]:
        """HWC uint8 RGB → list of {'bbox': (x0, y0, x1, y1), 'score': s},
        largest first, faces under T pixels a side dropped."""
        h, w = image_rgb.shape[:2]
        bgr = image_rgb[..., ::-1].astype(np.float32) - self.BGR_MEAN
        x = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1)[None])).to(self.device)
        loc, conf, _ = self.model(x)
        loc, scores = loc[0].cpu().numpy(), conf[0, :, 1].cpu().numpy()
        if (h, w) not in self._priors:
            self._priors[(h, w)] = prior_boxes((h, w))
        boxes = decode_boxes(loc, self._priors[(h, w)]) * np.asarray([w, h, w, h])
        keep = scores > conf_thres
        boxes, scores = boxes[keep], scores[keep]
        if len(boxes) == 0:
            return []
        out = []
        for i in nms(boxes, scores):
            x0, y0, x1, y1 = boxes[i]
            if (x1 - x0) < T or (y1 - y0) < T:
                continue
            out.append({"bbox": (float(max(x0, 0)), float(max(y0, 0)),
                                 float(min(x1, w)), float(min(y1, h))),
                        "score": float(scores[i])})
        out.sort(key=lambda f: -(f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1]))
        return out

    def crop_faces(self, images: np.ndarray, T: int = 20):
        """[B, 3, H, W] in [−1, 1] → (fg_bboxes [B, 4], confidences [B],
        detected [B]); an image without a face gets the whole frame."""
        b, _, h, w = images.shape
        imgs = ((images.transpose(0, 2, 3, 1) + 1) * 127.5).clip(0, 255)
        bboxes = np.zeros((b, 4), np.float32)
        confs = np.zeros((b,), np.float32)
        detected = np.zeros((b,), np.float32)
        for i in range(b):
            faces = self.detect_faces(imgs[i].astype(np.uint8), T=T)
            if faces:
                bboxes[i], confs[i], detected[i] = faces[0]["bbox"], faces[0]["score"], 1.0
            else:
                bboxes[i] = (0, 0, w, h)
        return bboxes, confs, detected


def convert_retinaface_state_dict(sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Pytorch_Retinaface mobilenet0.25 state dict → this module's."""
    out: dict[str, torch.Tensor] = {}

    def t(key):
        return torch.as_tensor(np.asarray(sd[key]), dtype=torch.float32)

    def conv_bn(src_conv, src_bn, dst):
        out[f"{dst}.conv.weight"] = t(f"{src_conv}.weight")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.bn.{leaf}"] = t(f"{src_bn}.{leaf}")

    conv_bn("body.stage1.0.0", "body.stage1.0.1", "body.stage1.0")
    for stage, n, first in (("stage1", 5, 1), ("stage2", 6, 0), ("stage3", 2, 0)):
        for i in range(first, first + n):
            pre = f"body.{stage}.{i}"
            conv_bn(f"{pre}.0", f"{pre}.1", f"{pre}.dw")
            conv_bn(f"{pre}.3", f"{pre}.4", f"{pre}.pw")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        conv_bn(f"fpn.{name}.0", f"fpn.{name}.1", f"fpn.{name}")
    for i in range(3):
        for src, dst in (("conv3X3", "conv3x3"), ("conv5X5_1", "conv5x5_1"),
                         ("conv5X5_2", "conv5x5_2"), ("conv7X7_2", "conv7x7_2"),
                         ("conv7x7_3", "conv7x7_3")):
            conv_bn(f"ssh{i + 1}.{src}.0", f"ssh{i + 1}.{src}.1", f"ssh.{i}.{dst}")
    for name, src in (("class", "ClassHead"), ("bbox", "BboxHead"),
                      ("landmark", "LandmarkHead")):
        for i in range(3):
            out[f"heads.{name}.{i}.conv.weight"] = t(f"{src}.{i}.conv1x1.weight")
            out[f"heads.{name}.{i}.bias"] = t(f"{src}.{i}.conv1x1.bias")
    return out
