"""GMA (RAFT + Global Motion Aggregation) optical flow.

Counterpart of `adaface_tpu/models/gma.py`, with its names: residual
BasicEncoders (instance-norm `fnet`, batch-norm `cnet` with running
statistics), the parameter-free all-pairs correlation pyramid (4 levels,
radius 4: 324 lookup planes), content-only intra-frame attention over the
context features, the motion encoder → aggregation → SepConvGRU → flow head
update block, and the learned convex x8 upsampling. The `GMA` module's
parameter names mirror the JAX tree (`update.gru.z1` is
`p["update"]["gru"]["z1"]`), so `core.bridge.load` carries a JAX tree
(`convert_gma_state_dict`'s, or `init_gma_params`') into it.

The training path is the latent flow of the elastic-matching loss
(`est_flow_from_feats` through `make_latent_flow_fn`): the correlation on
the raw features, zero hidden and context state, so only the update block
refines and the attention is uniform. `gma_flow` is the image path (RAFT's
protocol). Tensors are NCHW here where the JAX package is NHWC; every sum
and every tap is the JAX one:

- `_bilinear_sample_zeropad` takes the four taps of `floor(x)`, `floor(y)`
  with a gather on the flattened plane and zeros outside (not
  `F.grid_sample`, which normalises the coordinates);
- `_corr_lookup` keeps the reference's transposed window: the delta named
  dy is added to x (`corr.py:44-50`);
- `flow2attn` scatters the warp's four weights into a zero matrix, tap by
  tap in the warp's order, which is the warped identity JAX builds densely.

Plus the warping utilities of the loss library (`backward_warp_by_flow`,
`smooth_flow`, `flow2attn`) and `flow_to_image` (numpy).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import normal_
from adaface_tpu_torch.ops.resize import resize_bilinear_half_pixel

HDIM = 128  # GRU hidden dim
CDIM = 128  # context dim
CORR_LEVELS = 4
CORR_RADIUS = 4
NUM_HEADS = 1  # `network.py:33-34`
CORR_PLANES = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2  # 324


def _conv2d(cin: int, cout: int, kh: int, kw: int | None = None, bias: bool = True) -> nn.Conv2d:
    kw = kh if kw is None else kw
    return nn.Conv2d(cin, cout, (kh, kw), bias=bias)


def _conv(m: nn.Conv2d, x, stride: int = 1, padding: int | None = None):
    """The JAX `_conv`: 'same' padding kh//2, kw//2 unless `padding` is given."""
    kh, kw = m.kernel_size
    pad = (kh // 2, kw // 2) if padding is None else (padding, padding)
    return F.conv2d(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype),
                    stride, pad)


class FrozenBatchNorm(nn.Module):
    """Batch norm in inference mode: (x − mean)·rsqrt(var + 1e-5)·scale + bias
    (the JAX `_norm` "batch"); scale → weight, mean/var → running buffers."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        v = lambda t: t.to(x.dtype)[None, :, None, None]  # noqa: E731
        return ((x - v(self.running_mean)) * torch.rsqrt(v(self.running_var) + 1e-5)
                * v(self.weight) + v(self.bias))


class InstanceNorm(nn.Module):
    """Instance norm without weights, fp32 statistics over H, W."""

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
        return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def _norm(kind: str, ch: int) -> nn.Module:
    return FrozenBatchNorm(ch) if kind == "batch" else InstanceNorm()


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, kind: str):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv2d(cin, cout, 3)
        self.conv2 = _conv2d(cout, cout, 3)
        self.n1, self.n2 = _norm(kind, cout), _norm(kind, cout)
        if stride != 1:
            self.down = _conv2d(cin, cout, 1)
            self.n3 = _norm(kind, cout)

    def forward(self, x):
        y = F.relu(self.n1(_conv(self.conv1, x, stride=self.stride)))
        y = F.relu(self.n2(_conv(self.conv2, y)))
        if self.stride != 1:
            x = self.n3(_conv(self.down, x, stride=self.stride, padding=0))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """conv 7x7/2 → three residual stages (64, 96, 128) → conv 1x1."""

    def __init__(self, out_dim: int, kind: str):
        super().__init__()
        self.conv1 = _conv2d(3, 64, 7)
        self.n1 = _norm(kind, 64)
        self.layer1 = nn.ModuleList([ResBlock(64, 64, 1, kind), ResBlock(64, 64, 1, kind)])
        self.layer2 = nn.ModuleList([ResBlock(64, 96, 2, kind), ResBlock(96, 96, 1, kind)])
        self.layer3 = nn.ModuleList([ResBlock(96, 128, 2, kind), ResBlock(128, 128, 1, kind)])
        self.conv2 = _conv2d(128, out_dim, 1)

    def forward(self, x):
        h = F.relu(self.n1(_conv(self.conv1, x, stride=2)))
        for layer in (self.layer1, self.layer2, self.layer3):
            h = layer[1](layer[0](h))
        return _conv(self.conv2, h, padding=0)


class GMA(nn.Module):
    """The RAFT-GMA network's weights (`init_gma_params`'s tree)."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HDIM + CDIM, "batch")
        self.att = nn.ModuleDict({"to_qk": _conv2d(CDIM, 2 * NUM_HEADS * 128, 1, bias=False)})
        gru_in = HDIM + CDIM + 256
        self.update = nn.ModuleDict({
            "menc": nn.ModuleDict({
                "convc1": _conv2d(CORR_PLANES, 256, 1), "convc2": _conv2d(256, 192, 3),
                "convf1": _conv2d(2, 128, 7), "convf2": _conv2d(128, 64, 3),
                "conv": _conv2d(256, 126, 3)}),
            "agg": _Aggregate(),
            "gru": nn.ModuleDict({k: _conv2d(gru_in, HDIM, *ks) for k, ks in (
                ("z1", (1, 5)), ("r1", (1, 5)), ("q1", (1, 5)),
                ("z2", (5, 1)), ("r2", (5, 1)), ("q2", (5, 1)))}),
            "flow_head": nn.ModuleDict({"conv1": _conv2d(HDIM, 256, 3),
                                        "conv2": _conv2d(256, 2, 3)}),
            "mask": nn.ModuleDict({"conv1": _conv2d(128, 256, 3),
                                   "conv2": _conv2d(256, 64 * 9, 1)}),
        })


class _Aggregate(nn.Module):
    def __init__(self):
        super().__init__()
        self.to_v = _conv2d(128, NUM_HEADS * 128, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))


def init_gma_weights_(module: GMA, gen: torch.Generator) -> None:
    """`init_gma_params` scales: conv weights N(0, 2/(kh·kw·cin)), biases 0,
    batch norms 1/0 with statistics 0/1, the aggregation's γ 0."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            normal_(m.weight, math.sqrt(2.0 / (kh * kw * m.in_channels)), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, FrozenBatchNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    nn.init.zeros_(module.update["agg"].gamma)


# ---------------------------------------------------------------------------
# correlation pyramid (parameter-free; corr.py CorrBlock)
# ---------------------------------------------------------------------------


def _corr_pyramid(f1, f2, normalized_by_sqrt_dim: bool = True):
    """All-pairs correlation → CORR_LEVELS pooled volumes. f1, f2 [B, C, H, W]
    → ([B·H·W, H/2^l, W/2^l] per level, (B, H, W))."""
    b, c, h, w = f1.shape
    corr = torch.einsum("bcij,bckl->bijkl", f1.float(), f2.float())
    corr = corr / (math.sqrt(c) if normalized_by_sqrt_dim else 1.0)
    cur = corr.reshape(b * h * w, h, w)
    pyramid = [cur]
    for _ in range(CORR_LEVELS - 1):
        n, ch, cw = cur.shape
        cur = cur[:, :ch // 2 * 2, :cw // 2 * 2].reshape(n, ch // 2, 2, cw // 2, 2)
        cur = cur.sum(dim=(2, 4)) / 4.0
        pyramid.append(cur)
    return pyramid, (b, h, w)


def _bilinear_sample_zeropad(img, x, y):
    """img [N, H, W]; sample coordinates x, y [N, K] → [N, K], zeros outside
    (torch `grid_sample(align_corners=True, padding_mode='zeros')`'s values)."""
    n, h, w = img.shape
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    flat = img.reshape(n, h * w)

    def take(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(img.dtype)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.gather(flat, 1, idx) * valid

    wx = x - x0
    wy = y - y0
    return (take(y0, x0) * (1 - wx) * (1 - wy)
            + take(y0, x0 + 1) * wx * (1 - wy)
            + take(y0 + 1, x0) * (1 - wx) * wy
            + take(y0 + 1, x0 + 1) * wx * wy)


def _corr_lookup(pyramid, shape, coords):
    """Each level sampled in a (2r+1)² window (corr.py `__call__`). coords
    [B, 2, H, W] (x, y) in level-0 units → [B, L·(2r+1)², H, W]. The
    reference adds the delta's first (dy-named) component to x and its
    second to y (`corr.py:50`): the window is transposed against its
    channel naming, kept so ported weights line up."""
    b, h, w = shape
    r = CORR_RADIUS
    k = 2 * r + 1
    dev = coords.device
    steps = torch.arange(-r, r + 1, dtype=torch.float32, device=dev)
    d0 = steps.repeat_interleave(k)  # the first meshgrid dim
    d1 = steps.repeat(k)
    c = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        cl = c / (2 ** lvl)
        outs.append(_bilinear_sample_zeropad(corr, cl[..., 0] + d0[None], cl[..., 1] + d1[None]))
    out = torch.cat(outs, dim=-1)  # [B·H·W, L·K²]
    return out.reshape(b, h, w, -1).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# attention + update block (gma.py / update.py)
# ---------------------------------------------------------------------------


def _attention(att: nn.ModuleDict, inp):
    """Content-only intra-frame attention → [B, heads, N, N]."""
    b, _, h, w = inp.shape
    qk = _conv(att["to_qk"], inp, padding=0).flatten(2).transpose(1, 2)  # [B, N, 256]
    q, k = qk.reshape(b, h * w, NUM_HEADS, 2 * 128).split(128, dim=-1)
    q = q.transpose(1, 2) * (128 ** -0.5)
    k = k.transpose(1, 2)
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.softmax(sim, dim=-1).to(inp.dtype)


def _aggregate(agg: _Aggregate, attn, motion):
    """Global motion aggregation (`gma.py:111-160`): motion + γ·attn·V."""
    b, c, h, w = motion.shape
    v = _conv(agg.to_v, motion, padding=0).flatten(2).transpose(1, 2)  # [B, N, 128]
    out = torch.matmul(attn[:, 0], v).transpose(1, 2).reshape(b, NUM_HEADS * 128, h, w)
    return motion + agg.gamma.to(motion.dtype) * out


def _sep_conv_gru(gru: nn.ModuleDict, hidden, x):
    for s in ("1", "2"):
        hx = torch.cat([hidden, x], dim=1)
        z = torch.sigmoid(_conv(gru["z" + s], hx))
        r = torch.sigmoid(_conv(gru["r" + s], hx))
        q = torch.tanh(_conv(gru["q" + s], torch.cat([r * hidden, x], dim=1)))
        hidden = (1 - z) * hidden + z * q
    return hidden


def _update_block(upd: nn.ModuleDict, hidden, inp, corr, flow, attn):
    """GMAUpdateBlock (`update.py:113-146`) → (hidden, up_mask, dflow)."""
    m = upd["menc"]
    cor = F.relu(_conv(m["convc1"], corr, padding=0))
    cor = F.relu(_conv(m["convc2"], cor))
    flo = F.relu(_conv(m["convf1"], flow))
    flo = F.relu(_conv(m["convf2"], flo))
    motion = F.relu(_conv(m["conv"], torch.cat([cor, flo], dim=1)))
    motion = torch.cat([motion, flow], dim=1)  # 128 channels
    motion_global = _aggregate(upd["agg"], attn, motion)
    x = torch.cat([inp, motion, motion_global], dim=1)
    hidden = _sep_conv_gru(upd["gru"], hidden, x)
    fh, mk = upd["flow_head"], upd["mask"]
    dflow = _conv(fh["conv2"], F.relu(_conv(fh["conv1"], hidden)))
    mask = 0.25 * _conv(mk["conv2"], F.relu(_conv(mk["conv1"], hidden)), padding=0)
    return hidden, mask, dflow


def _upsample_flow_convex(flow, mask):
    """Learned convex x8 upsampling (`network.py:65-76`): flow [B, 2, H, W],
    mask [B, 576, H, W] → [B, 2, 8H, 8W]."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), dim=1)
    fp = F.pad(8.0 * flow, (1, 1, 1, 1))
    nb = torch.stack([fp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                     dim=1)  # [B, 9, 2, H, W]
    up = torch.einsum("bkuvhw,bkchw->bchuwv", mask, nb)
    return up.reshape(b, 2, 8 * h, 8 * w)


def _refine(gma: GMA, pyramid, shape, hidden, inp, num_iters: int):
    """`num_iters` update steps from zero flow, the flow detached before each
    (`coords1.detach()`) → (flow [B, 2, H, W], the last step's mask)."""
    b, h, w = shape
    attn = _attention(gma.att, inp)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=inp.device),
                            torch.arange(w, dtype=torch.float32, device=inp.device),
                            indexing="ij")
    coords0 = torch.stack([gx, gy])[None].expand(b, 2, h, w)
    flow = torch.zeros_like(coords0)
    mask = None
    for _ in range(num_iters):
        flow = flow.detach()
        corr = _corr_lookup(pyramid, shape, coords0 + flow)
        hidden, mask, dflow = _update_block(gma.update, hidden, inp, corr, flow, attn)
        flow = flow + dflow
    return flow, mask


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def gma_flow(gma: GMA, img1, img2, num_iters: int = 12):
    """RAFT protocol (`network.py:78-170`): [B, 3, H, W] images in [0, 255] →
    flow [B, 2, H, W] at full resolution."""
    x1 = 2.0 * (img1 / 255.0) - 1.0
    x2 = 2.0 * (img2 / 255.0) - 1.0
    f1, f2 = gma.fnet(x1), gma.fnet(x2)
    ctx = gma.cnet(x1)
    hidden, inp = ctx.split([HDIM, CDIM], dim=1)
    pyramid, shape = _corr_pyramid(f1, f2)
    flow, mask = _refine(gma, pyramid, shape, torch.tanh(hidden), F.relu(inp), num_iters)
    return _upsample_flow_convex(flow, mask)


def est_flow_from_feats(gma: GMA, fmap1, fmap2, h: int, w: int, num_iters: int = 12,
                        corr_normalized_by_sqrt_dim: bool = False):
    """Latent-feature flow (`network.py#est_flow_from_feats:174-264`): fmap1,
    fmap2 [B, C, N] → the fmap1→fmap2 flow [B, 2, h, w]: the correlation on
    the raw features, zero hidden and context state, the convex upsampling
    resized back to (h, w) (half-pixel bilinear, no antialias) and divided
    by 8."""
    b, c, _ = fmap1.shape
    x1 = fmap1.reshape(b, c, h, w)
    x2 = fmap2.reshape(b, c, h, w)
    pyramid, shape = _corr_pyramid(x1, x2, corr_normalized_by_sqrt_dim)
    hidden = x1.new_zeros((b, HDIM, h, w))
    inp = x1.new_zeros((b, CDIM, h, w))
    flow, mask = _refine(gma, pyramid, shape, hidden, inp, num_iters)
    up = _upsample_flow_convex(flow, mask)
    return resize_bilinear_half_pixel(up, (h, w), spatial_axes=(2, 3)) / 8.0


def make_latent_flow_fn(gma: GMA, num_iters: int = 12, kernel_center_weight: float = 2.0):
    """The elastic-matching loss's flow estimator over UNet q features
    (`reconstruct_feat_with_matching_flow`, `ldm/util.py:2284-2306`):
    `est_flow_from_feats` → 3x3 smoothing → small-motion zeroing. →
    flow_fn(target_q [B, C, N], src_q [B, C, N], h, w, small_motion_thres)
    → the target→src flow [B, 2, h, w], in fp32 with TF32 off for the
    convolutions and products: the flow feeds a pick per token and the
    warp's floor, and TF32 moves them off the fp32 reference."""

    def flow_fn(tgt_q, src_q, h: int, w: int, small_motion_thres: float = 0.0):
        with fp32_convolutions(matmuls=True):
            flow = est_flow_from_feats(gma, tgt_q.float(), src_q.float(), h, w,
                                       num_iters=num_iters)
            return smooth_flow(flow, kernel_center_weight, ignore_thres=small_motion_thres)

    return flow_fn


# ---------------------------------------------------------------------------
# weight conversion (models/gma-sintel.pth → the JAX tree)
# ---------------------------------------------------------------------------


def convert_gma_state_dict(sd: Mapping[str, Any]) -> dict:
    """A torch GMA checkpoint (`gma-sintel.pth`) → the JAX package's tree of
    numpy arrays (`convert_gma_state_dict`, `gma.py:428`): HWIO conv kernels,
    instance norms without weights, batch norms with their running
    statistics; the unused relative-position weights dropped. `core.bridge.
    load(GMA(), tree)` loads it."""
    sd = {k.removeprefix("module."): (v.detach().cpu().numpy() if hasattr(v, "detach")
                                      else np.asarray(v)) for k, v in sd.items()}

    def conv(name, bias=True):
        p = {"w": sd[f"{name}.weight"].transpose(2, 3, 1, 0)}
        if bias:
            p["b"] = sd[f"{name}.bias"]
        return p

    def bnorm(name):
        return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"],
                "mean": sd[f"{name}.running_mean"], "var": sd[f"{name}.running_var"]}

    def encoder(prefix, kind):
        def norm(name):
            return bnorm(name) if kind == "batch" else {}

        def block(name, stride):
            p = {"conv1": conv(f"{name}.conv1"), "conv2": conv(f"{name}.conv2"),
                 "n1": norm(f"{name}.norm1"), "n2": norm(f"{name}.norm2")}
            if stride != 1:
                p["down"] = conv(f"{name}.downsample.0")
                p["n3"] = norm(f"{name}.downsample.1")
            return p

        return {"conv1": conv(f"{prefix}.conv1"), "n1": norm(f"{prefix}.norm1"),
                "layer1": [block(f"{prefix}.layer1.0", 1), block(f"{prefix}.layer1.1", 1)],
                "layer2": [block(f"{prefix}.layer2.0", 2), block(f"{prefix}.layer2.1", 1)],
                "layer3": [block(f"{prefix}.layer3.0", 2), block(f"{prefix}.layer3.1", 1)],
                "conv2": conv(f"{prefix}.conv2")}

    u = "update_block"
    return {
        "fnet": encoder("fnet", "instance"),
        "cnet": encoder("cnet", "batch"),
        "att": {"to_qk": conv("att.to_qk", bias=False)},
        "update": {
            "menc": {k: conv(f"{u}.encoder.{k}") for k in
                     ("convc1", "convc2", "convf1", "convf2", "conv")},
            "agg": {"to_v": conv(f"{u}.aggregator.to_v", bias=False),
                    "gamma": sd[f"{u}.aggregator.gamma"].reshape(1)},
            "gru": {k: conv(f"{u}.gru.conv{k[0]}{k[1]}") for k in
                    ("z1", "r1", "q1", "z2", "r2", "q2")},
            "flow_head": {"conv1": conv(f"{u}.flow_head.conv1"),
                          "conv2": conv(f"{u}.flow_head.conv2")},
            "mask": {"conv1": conv(f"{u}.mask.0"), "conv2": conv(f"{u}.mask.2")},
        },
    }


# ---------------------------------------------------------------------------
# warping utilities (`ldm/util.py` flow helpers)
# ---------------------------------------------------------------------------


def _warp_taps(flow, h: int, w: int):
    """The four taps of the bilinear backward warp: [(flat index [B, H·W],
    weight [B, H·W]) ...] in the warp's order (00, 01, 10, 11)."""
    b = flow.shape[0]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flow.device),
                            torch.arange(w, dtype=torch.float32, device=flow.device),
                            indexing="ij")
    x = torch.clamp(gx[None] + flow[:, 0], 0, w - 1)
    y = torch.clamp(gy[None] + flow[:, 1], 0, h - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx, wy = x - x0, y - y0
    taps = [(y0, x0, (1 - wx) * (1 - wy)), (y0, x1, wx * (1 - wy)),
            (y1, x0, (1 - wx) * wy), (y1, x1, wx * wy)]
    return [((yi * w + xi).reshape(b, h * w), wt.reshape(b, h * w)) for yi, xi, wt in taps]


def backward_warp_by_flow(image, flow):
    """Bilinear backward warp: out(x) = image(x + flow(x)), coordinates
    clamped to the map. image [B, C, H, W]; flow [B, 2, H, W] (dx, dy)."""
    b, c, h, w = image.shape
    flat = image.reshape(b, c, h * w)
    out = None
    for idx, wt in _warp_taps(flow, h, w):
        term = (torch.gather(flat, 2, idx[:, None].expand(b, c, h * w))
                * wt[:, None].to(image.dtype))
        out = term if out is None else out + term
    return out.reshape(b, c, h, w)


def flow2attn(s2c_flow, h: int, w: int):
    """Flow → sparse attention [B, N, N] (`flow2attn`, `ldm/util.py:2257-2267`):
    the identity backward-warped by the single→comp flow, from comp tokens
    (dim 1) to single tokens (dim 2). The warp's weights are scattered tap by
    tap into zeros, in its order: the sums JAX takes over the dense identity."""
    b, n = s2c_flow.shape[0], h * w
    out = s2c_flow.new_zeros((b, n, n))
    for idx, wt in _warp_taps(s2c_flow, h, w):
        out.scatter_add_(1, idx[:, None], wt[:, None].to(out.dtype))
    return out


def smooth_flow(flow, kernel_center_weight: float = 2.0, ignore_thres: float = 0.0):
    """3x3 weighted smoothing + small-motion zeroing (`smooth_tensor_34d` +
    threshold, `ldm/util.py:2300-2306`)."""
    k = torch.ones((3, 3), dtype=torch.float32, device=flow.device)
    k[1, 1] = kernel_center_weight
    k = (k / k.sum()).reshape(1, 1, 3, 3).to(flow.dtype)
    b, c, h, w = flow.shape
    out = F.conv2d(flow.reshape(b * c, 1, h, w), k, padding=1).reshape(b, c, h, w)
    if ignore_thres > 0:
        out = torch.where(out.abs() < ignore_thres, torch.zeros_like(out), out)
    return out


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Middlebury colour-wheel visualisation (`gma/utils/flow_viz.py`): flow
    [H, W, 2] → uint8 [H, W, 3]. Host numpy, off the compute path."""
    sectors = [(15, (255, 0, 0), (255, 255, 0)), (6, (255, 255, 0), (0, 255, 0)),
               (4, (0, 255, 0), (0, 255, 255)), (11, (0, 255, 255), (0, 0, 255)),
               (13, (0, 0, 255), (255, 0, 255)), (6, (255, 0, 255), (255, 0, 0))]
    wheel = []
    for n, c0, c1 in sectors:
        for i in range(n):
            t = i / n
            wheel.append([c0[j] * (1 - t) + c1[j] * t for j in range(3)])
    wheel = np.asarray(wheel, np.float32)  # [55, 3]
    ncols = len(wheel)
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad_max = max(rad.max(), 1e-5)
    u, v, rad = u / rad_max, v / rad_max, rad / rad_max
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (wheel[k0] * (1 - f) + wheel[k1] * f) / 255.0
    col = 1 - rad[..., None] * (1 - col)  # toward white for small motion
    return (col * 255).astype(np.uint8)
