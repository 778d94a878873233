"""Int8 post-training quantization of the UNet for serving.

Counterpart of `adaface_tpu/ops/quant.py`. Weights: per output channel,
symmetric, quantized once (`quantize_unet`); `conv_in`, `conv_out` and the
time embedding stay as they are. Activations: one dynamic symmetric scale
for the whole tensor, the whole CFG batch (and a batcher's whole batch) at
once, as JAX computes it. A quantized layer is int8 × int8 with exact integer
sums, then `y · (x_scale · w_scale)` in fp32 (the scales multiplied first),
then `+ b` in fp32, then a cast to x's dtype. Inference only.

The plain versions (`quantize_act`, `int8_conv2d_plain`, `int8_dense_plain`)
take any device. They sum the int8 products in fp64: exact below 2⁵³, where
a 3×3 convolution over 1280 channels reaches ~1.9e8, past fp32's 2²⁴.

On a CUDA tensor the wrappers launch the kernels of `csrc/int8_conv.cu`
(bf16, channels-last maps): `quant_act` (one cooperative launch: each block's
max |x| into a slot of the layer's scale buffer, a grid barrier, the slots
folded on the device into the scale, and the int8 copy), then
`int8_conv_igemm` (the convolution, or a dense layer as a 1×1 convolution over
its rows, on wgmma s8 fed by TMA, with the dequantize and the bias in its
epilogue), its geometry from `igemm_plan`. Two launches a layer, no memset,
nothing read back on the host. On a CPU tensor they take the plain versions.
Every quantized width of the SD1.5 UNet is a multiple of 32 (320, 640, 960,
1280, 1920, 2560 input channels); the kernel refuses any other.
`int8_conv2d_tiled` and `quantize_act_slots` repeat the kernels' schedule in
plain PyTorch (the tiles and taps as the tensor maps gather them, the
reduction split over a cluster's ranks; the per-block maxima), so that the CPU
tests hold the indexing to the plain versions where the kernels cannot run.
PyTorch has no eager int8 convolution on CUDA; `chip_smoke.py` times im2col +
`torch._int_mm` beside the kernel as a yardstick only.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.ops import _build

QUANT_ACT = "quant_act"
INT8_CONV = "int8_conv_igemm"
DEFAULT_SKIP = ("conv_in", "conv_out", "time_mlp")  # kept in their dtype (`quant.py:43`)
CHANNEL_STEP = 32  # the input width's multiple the kernels take
STEP = 128  # bytes of the reduction a stage of `int8_conv_igemm`
TILE_ROWS = 128  # output pixels (rows) of a block: two warpgroups of 64
TILE_WIDTHS = (128, 160)  # output channels of a block: the kernel's wgmma instances
MAX_STAGES = 8
QUANT_THREADS = 256  # threads of a `quant_act` block
QUANT_SLOTS = 1024  # the blocks' maxima a `quant_act` launch may write (`kMaxSlots`)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of w [O, ...] (a conv's OIHW or a
    dense [O, I]) → (w_q int8 of w's shape, scale fp32 [O]):
    scale = max(amax, 1e-8) / 127, w_q = clip(round(w / scale), -127, 127)
    (`quantize_weight`, `quant.py:46`, whose HWIO / IO keep O last)."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    scale = amax.clamp(min=1e-8) / 127.0
    shape = (-1,) + (1,) * (wf.dim() - 1)
    w_q = torch.round(wf / scale.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 of the whole tensor (`_quantize_act`,
    `quant.py:58`) → (x_q int8 of x's shape and layout, scale fp32 [])."""
    xf = x.float()
    scale = xf.abs().amax().clamp(min=1e-8) / 127.0
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def _dequantize(y64, x_scale, w_scale, bias, dtype, shape):
    """The epilogue of `int8_conv2d` / `int8_dense` (`quant.py:80-82`): the
    exact sums to fp32, times (x_scale · w_scale), plus the bias, in fp32."""
    y = y64.float() * (x_scale * w_scale).reshape(shape)
    return (y + bias.float().reshape(shape)).to(dtype)


def int8_conv2d_plain(x, w_q, w_scale, bias, stride: int = 1, padding: int = 1):
    """x [N, I, H, W]; w_q [O, kh, kw, I] int8 → [N, O, Ho, Wo] in x's dtype
    and memory format."""
    x_q, x_scale = quantize_act(x)
    y = F.conv2d(x_q.double(), w_q.permute(0, 3, 1, 2).double(), stride=stride,
                 padding=padding)
    return _dequantize(y, x_scale, w_scale, bias, x.dtype, (1, -1, 1, 1)).contiguous(
        memory_format=_memory_format(x))


def int8_dense_plain(x, w_q, w_scale, bias):
    """x [..., I]; w_q [O, I] int8 → [..., O] in x's dtype."""
    x_q, x_scale = quantize_act(x)
    y = x_q.double() @ w_q.double().T
    return _dequantize(y, x_scale, w_scale, bias, x.dtype, (-1,))


def _memory_format(x):
    return (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _cuda_checks(x, what: str):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the int8 kernels take bf16 activations, got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: {x.device} is not the current device")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the activation must start on 16 bytes")


def _stream(device_index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(device_index)


def quantize_act_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel `quant_act` on a contiguous (in memory) bf16 CUDA tensor → (x_q
    int8 in x's layout, the scale's words int32 [1 + QUANT_SLOTS]: the bits of
    max |x| first, then the blocks' maxima; on the device). One launch, no
    memset; nothing read back."""
    _cuda_checks(x, "quantize_act")
    words = torch.empty(1 + QUANT_SLOTS, dtype=torch.int32, device=x.device)
    x_q = torch.empty_like(x, dtype=torch.int8)
    _build.check(_build.load_library().int8_quantize(
        x.data_ptr(), x.numel(), words.data_ptr(), x_q.data_ptr(), _stream(x.device.index)),
        QUANT_ACT)
    _build.count(QUANT_ACT)
    return x_q, words


def quant_blocks(n: int, sms: int) -> int:
    """Blocks of a `quant_act` launch for n values (`quant_blocks` of
    `int8_conv.cu`): two an SM, every one resident for the cooperative launch,
    fewer for a small tensor; one slot each."""
    return max(1, min(-(-(n // 8) // QUANT_THREADS), min(2 * sms, QUANT_SLOTS)))


def quantize_act_slots(x: torch.Tensor, blocks: int) -> tuple[torch.Tensor, torch.Tensor,
                                                                torch.Tensor]:
    """The plain version of `quant_act`'s route: its per-block maxima (thread
    t of `blocks` x 256 takes the 8-value packs t, t + 256 blocks, ..., then
    the tail values likewise), folded after the grid barrier, then the int8
    copy → (x_q, scale fp32 [], the slots fp32 [blocks])."""
    flat = x.reshape(-1).float().abs()
    n, threads = flat.numel(), blocks * QUANT_THREADS
    idx = torch.arange(n)
    body = (n // 8) * 8
    thread = torch.where(idx < body, (idx // 8) % threads, (idx - body) % threads)
    slots = torch.zeros(blocks).scatter_reduce(0, thread // QUANT_THREADS, flat, "amax")
    scale = slots.max().clamp(min=1e-8) / 127.0
    return torch.round(x.float() / scale).clamp(-127, 127).to(torch.int8), scale, slots


def conv_out_hw(h: int, w: int, k: int, stride: int, padding: int) -> tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def check_widths(i: int, o: int, what: str) -> None:
    if i % CHANNEL_STEP or o % 8:
        raise ValueError(f"{what}: the int8 kernel takes input widths that are multiples of "
                         f"{CHANNEL_STEP} and output widths of 8, got {i} -> {o}")


@dataclasses.dataclass(frozen=True)
class IgemmPlan:
    """The geometry of one `int8_conv_igemm` launch: `tile_n` output channels
    a block (128 pixels by `tile_n`), `step` bytes of the reduction a stage
    (the kernel's STEP; `igemm_tiled_sums` also takes 64), `stages` in the
    TMA ring, the reduction split over the `split` blocks of a cluster, and
    whether the product runs transposed (output channels as wgmma's rows; no
    kernel instance takes it: always False)."""
    tile_n: int
    step: int
    stages: int
    split: int
    transpose: bool = False


def igemm_steps(i: int, k: int, step: int = STEP) -> int:
    """Reduction steps of a k x k filter over i channels: a tap's channels in
    `step`-byte steps, the last one zero-filled past i."""
    return k * k * -(-i // step)


def igemm_tiles(rows: int, o: int, tile_n: int) -> int:
    return -(-rows // TILE_ROWS) * -(-o // tile_n)


def igemm_smem(plan: IgemmPlan) -> int:
    """Shared memory of a block of `int8_conv_igemm` (`Tile::smem`): the
    ring, or what the epilogue lays over it where that is larger (the int32
    partial tile of a split, else the staged bf16 output tile), the ring's
    barriers and 1 KB of alignment."""
    ring = plan.stages * (TILE_ROWS + plan.tile_n) * plan.step
    over = 256 * plan.tile_n // 2 * 4 if plan.split > 1 else TILE_ROWS * (2 * plan.tile_n + 16)
    return max(ring, over) + 2 * MAX_STAGES * 8 + 1024


def igemm_stages(tile_n: int) -> int:
    """Stages of the TMA ring that leave two blocks an SM their shared memory."""
    return min(MAX_STAGES, RING_BYTES // 2 // ((TILE_ROWS + tile_n) * STEP))


@functools.lru_cache(maxsize=None)
def igemm_plan(rows: int, i: int, o: int, k: int, stride: int, sm_count: int) -> IgemmPlan:
    """`int8_conv_igemm`'s geometry for `rows` output pixels (or a dense
    layer's rows), i -> o channels, a k x k filter at `stride`, on a card of
    `sm_count` SMs; the rule the sweep set (`chip_compare.py --int8-plans`,
    every int8 shape of the SD1.5 UNet at batches 2 and 16; summed over a
    UNet call, within 2% of the quickest geometry shape by shape):
    - the tile width by the work, counted in tiles of 160 channels: 128 below
      FEW_TILES an SM, and below SPLIT_FILL an SM for a 1x1 or a dense layer
      (more blocks where a block's reduction is short), else 160; a width
      that does not divide o gives way to the other where that divides it
      (else the last tile is ragged: zero-filled weights, columns past o not
      stored);
    - where the tiles are fewer than SPLIT_FILL of the card's block slots
      (two blocks an SM), the reduction is split over a cluster by the
      member of SPLITS nearest (in ratio) to the shortfall, MAX_PLAN_SPLIT at
      most, each block keeping MIN_SPLIT_STEPS reduction steps at the least
      (2 below FEW_TILES an SM: there every SM the split reaches counts).
      The 8² map's 3x3 over 1280 channels at CFG batch 2: 10 tiles of 128 →
      8 blocks a tile; the 32² map's 3x3 over 640 at batch 2: 64 tiles of
      160, 45 steps → 3 blocks a tile."""
    im2col = not (k == 1 and stride == 1)
    work = igemm_tiles(rows, o, 160) / sm_count
    tile_n = 128 if work < FEW_TILES or (work < SPLIT_FILL and not im2col) else 160
    other = 160 if tile_n == 128 else 128
    if o % tile_n and not o % other:
        tile_n = other
    tiles = igemm_tiles(rows, o, tile_n)
    target = SPLIT_FILL * 2 * sm_count
    split = 1
    if tiles < target:
        want = min(SPLITS, key=lambda sp: abs(math.log(sp * tiles / target)))
        least = 2 if tiles < FEW_TILES * sm_count else MIN_SPLIT_STEPS
        cap = min(MAX_PLAN_SPLIT, igemm_steps(i, k, STEP) // least)
        split = max(sp for sp in SPLITS if sp <= max(1, min(want, cap)))
    return IgemmPlan(tile_n, STEP, igemm_stages(tile_n), split)


RING_BYTES = 220 * 1024  # the shared memory an SM gives its blocks' rings
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)  # the cluster sizes the sweep timed
SPLIT_FILL = 96 / 132  # of the block slots, the split's aim: the sweep's best, 192 on 132 SMs
FEW_TILES = 1 / 8  # tiles of 160 an SM below which the tile narrows to 128
MAX_PLAN_SPLIT = 8
MIN_SPLIT_STEPS = 8  # reduction steps a block of a split keeps at the least


def _im2col_walk(m0: int, n: int, h: int, w: int, ho: int, wo: int, k: int, stride: int,
                 pad: int, count: int) -> list[tuple[int, int, int]]:
    """The base coordinates (image, row, column) of `count` pixels of an
    im2col box that starts at output pixel m0, as TMA walks them: along W at
    the traversal stride inside the bounding box of the filter windows'
    corners (-pad .. extent - 1 + pad - (k - 1)), then to the next row, then
    to the next image (past the last image: out of the tensor, zeros)."""
    lower, upper = -pad, pad - (k - 1)
    per = ho * wo
    cn, rem = divmod(m0, per)
    ch, cw = (rem // wo) * stride - pad, (rem % wo) * stride - pad
    coords = []
    for _ in range(count):
        coords.append((cn, ch, cw))
        cw += stride
        if cw > w - 1 + upper:
            cw, ch = lower, ch + stride
            if ch > h - 1 + upper:
                ch, cn = lower, cn + 1
    return coords


def igemm_tiled_sums(x_q: torch.Tensor, w_q: torch.Tensor, k: int, stride: int, padding: int,
                     plan: IgemmPlan) -> torch.Tensor:
    """The exact sums of `int8_conv_igemm`'s schedule in plain PyTorch: x_q
    int8 [n, h, w, i] (channels last), w_q int8 [o, k, k, i] → int64 [n, ho,
    wo, o]. Each block's 128 x step pixel tile is gathered as its tensor map
    gathers it (im2col boxes through `_im2col_walk`, the padding taps, the
    channels past i and the pixels past the end zero; or plain [rows, i]
    tiles at a 1x1 stride-1 filter), its tile_n x step weight tile from
    [o, taps, i] (zero past o and i); each of the `split` ranks sums its
    share of the steps, and the ranks' tiles are folded in rank order."""
    n, h, w, i = x_q.shape
    o = w_q.shape[0]
    ho, wo = conv_out_hw(h, w, k, stride, padding)
    rows, taps, cblocks = n * ho * wo, k * k, -(-i // plan.step)
    steps = taps * cblocks
    im2col = not (k == 1 and stride == 1 and padding == 0)
    xp = torch.zeros((n + 1, h, w, cblocks * plan.step), dtype=torch.int64)  # image n: past the end
    xp[:n, :, :, :i] = x_q.long()
    wp = torch.zeros((-(-o // plan.tile_n) * plan.tile_n, taps, cblocks * plan.step),
                     dtype=torch.int64)
    wp[:o, :, :i] = w_q.reshape(o, taps, i).long()
    rows_p = torch.zeros((-(-rows // TILE_ROWS) * TILE_ROWS, cblocks * plan.step),
                         dtype=torch.int64)
    rows_p[:rows] = xp[:n].reshape(rows, -1) if not im2col else 0
    out = torch.zeros((rows, o), dtype=torch.int64)
    for m0 in range(0, rows, TILE_ROWS):
        coords = (_im2col_walk(m0, n, h, w, ho, wo, k, stride, padding, TILE_ROWS)
                  if im2col else None)
        for o0 in range(0, o, plan.tile_n):
            ranks = []
            for r in range(plan.split):
                acc = torch.zeros((TILE_ROWS, plan.tile_n), dtype=torch.int64)
                for ks in range(r * steps // plan.split, (r + 1) * steps // plan.split):
                    tap, cb = divmod(ks, cblocks)
                    ky, kx = divmod(tap, k)
                    cs = slice(cb * plan.step, (cb + 1) * plan.step)
                    if im2col:
                        a = torch.zeros((TILE_ROWS, plan.step), dtype=torch.int64)
                        for p, (cn, ch, cw) in enumerate(coords):
                            y, x = ch + ky, cw + kx
                            if cn < n and 0 <= y < h and 0 <= x < w:
                                a[p] = xp[cn, y, x, cs]
                    else:
                        a = rows_p[m0:m0 + TILE_ROWS, cs]
                    acc += a @ wp[o0:o0 + plan.tile_n, tap, cs].T
                ranks.append(acc)
            total = ranks[0]
            for acc in ranks[1:]:
                total = total + acc
            m1, o1 = min(m0 + TILE_ROWS, rows), min(o0 + plan.tile_n, o)
            out[m0:m1, o0:o1] = total[:m1 - m0, :o1 - o0]
    return out.reshape(n, ho, wo, o)


def int8_conv2d_tiled(x, w_q, w_scale, bias, stride: int = 1, padding: int = 1,
                      plan: IgemmPlan | None = None, blocks: int = 4):
    """`int8_conv2d_plain` through the kernels' schedule (`quantize_act_slots`
    with `blocks` quantization blocks, `igemm_tiled_sums` with `plan`, or
    `igemm_plan`'s on a card of 132 SMs): x [N, I, H, W] → [N, O, Ho, Wo]
    in x's dtype and memory format. CPU only; its sums equal the plain
    version's where the kernels' indexing is right."""
    o, k, _, i = w_q.shape
    x_q, x_scale, _ = quantize_act_slots(x, blocks)
    n, _, h, w = x.shape
    ho, wo = conv_out_hw(h, w, k, stride, padding)
    plan = plan or igemm_plan(n * ho * wo, i, o, k, stride, 132)
    y = igemm_tiled_sums(x_q.permute(0, 2, 3, 1), w_q, k, stride, padding, plan)
    return _dequantize(y.permute(0, 3, 1, 2), x_scale, w_scale, bias, x.dtype,
                       (1, -1, 1, 1)).contiguous(memory_format=_memory_format(x))


def int8_dense_tiled(x, w_q, w_scale, bias, plan: IgemmPlan | None = None, blocks: int = 4):
    """`int8_dense_plain` through the kernels' schedule: x [..., I] as rows of
    a 1x1 convolution, as the wrapper hands them to the kernel."""
    o, i = w_q.shape
    x_q, x_scale, _ = quantize_act_slots(x, blocks)
    rows = x.numel() // i
    plan = plan or igemm_plan(rows, i, o, 1, 1, 132)
    y = igemm_tiled_sums(x_q.reshape(rows, 1, 1, i), w_q.reshape(o, 1, 1, i), 1, 1, 0, plan)
    return _dequantize(y.reshape(*x.shape[:-1], o), x_scale, w_scale, bias, x.dtype, (-1,))


def _igemm(x_q, amax, w_q, w_scale, bias32, n, h, w, k, stride, padding, plan=None):
    """Kernel `int8_conv_igemm` on int8 rows [n, h, w, I] with the scale's
    words `amax` → bf16 [n, O, ho, wo] in channels-last memory, with `plan`
    (`igemm_plan`'s unless given). The launch is prepared once per (weights,
    shape, plan) on the C side (the weights' tensor map, the geometry) and
    then takes four pointers. A split plan adds its partial tiles inside a
    cluster's shared memory: no workspace, so launches on two streams or in
    two graph replays share nothing."""
    o, i = w_q.shape[0], w_q.shape[-1]
    key = (w_q.data_ptr(), w_scale.data_ptr(), bias32.data_ptr(), n, h, w, i, o, k, stride,
           padding, plan)
    prepared = _PREPARED.get(key)
    lib = _build.load_library()
    if prepared is None:
        ho, wo = conv_out_hw(h, w, k, stride, padding)
        pl = plan or igemm_plan(n * ho * wo, i, o, k, stride, _build.sm_count(x_q.device.index))
        if pl.step != STEP or pl.transpose:
            raise ValueError(f"int8_conv_igemm: no instance takes {pl}")
        handle = lib.int8_igemm_prepare(w_q.data_ptr(), w_scale.data_ptr(), bias32.data_ptr(), n,
                                        h, w, i, o, k, stride, padding, ho, wo, pl.tile_n,
                                        pl.stages, pl.split)
        if handle < 0:
            _build.check(-handle, INT8_CONV)
        if len(_PREPARED) >= 4096:
            _PREPARED.clear()
        # [n, O, ho, wo] in channels-last memory: the kernel's [n, ho, wo, O]
        prepared = _PREPARED[key] = (handle, (n, o, ho, wo), (ho * wo * o, 1, wo * o, o))
    handle, shape, strides = prepared
    y = torch.empty_strided(shape, strides, dtype=torch.bfloat16, device=x_q.device)
    _build.check(lib.int8_conv_igemm(handle, x_q.data_ptr(), amax.data_ptr(), y.data_ptr(),
                                     _stream(x_q.device.index)), INT8_CONV)
    _build.count(INT8_CONV)
    return y


# prepared launches of `int8_conv_igemm`: (weights' pointers, shape, plan) ->
# (handle, output shape, output strides)
_PREPARED: dict[tuple, tuple] = {}
# weights already checked: id(w_q) -> (weak references to w_q, w_scale, bias; device index)
_CHECKED: dict[int, tuple] = {}


def _check_weights(w_q, w_scale, bias32, x):
    """Once per set of weight tensors (a module's buffers) and device: their
    dtype, device and layout cannot change while they live."""
    seen = _CHECKED.get(id(w_q))
    index = x.get_device()
    if (seen is not None and seen[0]() is w_q and seen[1]() is w_scale and seen[2]() is bias32
            and seen[3] == index):
        return
    for name, t, dtype in (("w_q", w_q, torch.int8), ("w_scale", w_scale, torch.float32),
                           ("bias", bias32, torch.float32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int8 kernel: {name} must be a contiguous {dtype} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if w_q.data_ptr() % 16:
        raise ValueError("int8 kernel: w_q must start on 16 bytes")
    if len(_CHECKED) >= 4096:
        _CHECKED.clear()
    _CHECKED[id(w_q)] = (weakref.ref(w_q), weakref.ref(w_scale), weakref.ref(bias32), index)


def int8_conv2d(x, w_q, w_scale, bias, stride: int = 1, padding: int = 1):
    """Quantized convolution (`int8_conv2d`, `quant.py:67`): x [N, I, H, W],
    w_q [O, kh, kw, I] int8 (kh = kw = 3 or 1), w_scale fp32 [O], bias [O].
    On CUDA: x bf16 in channels-last memory, bias fp32; → bf16 channels-last
    [N, O, Ho, Wo] through the two kernels. On the CPU the plain version."""
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, w_q, w_scale, bias, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no kernel for device {x.device}")
    o, kh, kw, i = w_q.shape
    n, c, h, w = x.shape
    if c != i or kh != kw or (kh, padding) not in ((3, 1), (1, 0)) or stride not in (1, 2):
        raise ValueError(f"int8_conv2d kernel: a {kh}x{kw} convolution of {c} channels at "
                         f"stride {stride}, padding {padding} is not one it takes")
    check_widths(i, o, "int8_conv2d")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv2d kernel: x must be in channels-last memory")
    _check_weights(w_q, w_scale, bias, x)
    x_q, amax = quantize_act_cuda(x)
    return _igemm(x_q, amax, w_q, w_scale, bias, n, h, w, kh, stride, padding)


def int8_dense(x, w_q, w_scale, bias):
    """Quantized dense layer (`int8_dense`, `quant.py:85`): x [..., I], w_q
    [O, I] int8. On CUDA a 1×1 convolution of the kernel over x's rows (x
    bf16, bias fp32); on the CPU the plain version."""
    if x.device.type == "cpu":
        return int8_dense_plain(x, w_q, w_scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dense: no kernel for device {x.device}")
    o, i = w_q.shape
    if x.shape[-1] != i:
        raise ValueError(f"int8_dense: x has {x.shape[-1]} features for weights [{o}, {i}]")
    check_widths(i, o, "int8_dense")
    x = x.contiguous()
    _check_weights(w_q, w_scale, bias, x)
    rows = x.numel() // i
    x_q, amax = quantize_act_cuda(x)
    y = _igemm(x_q, amax, w_q, w_scale, bias, rows, 1, 1, 1, 1, 0)
    return y.view(*x.shape[:-1], o)


class Int8Conv2d(nn.Module):
    """A quantized `nn.Conv2d` with bias: `w_q` [O, kh, kw, I] int8,
    `w_scale` fp32 [O] and `bias` fp32 [O] buffers, all taken from the conv
    once, as `quantize_unet_params` quantizes once."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        w_q, scale = quantize_weight(conv.weight.detach())
        self.register_buffer("w_q", w_q.permute(0, 2, 3, 1).contiguous())
        self.register_buffer("w_scale", scale)
        self.register_buffer("bias", conv.bias.detach().float().clone())
        self.stride, self.padding = conv.stride, conv.padding

    def dequantized(self) -> torch.Tensor:
        """w_q · w_scale, fp32 OIHW: the base a DoRA adapter composes on."""
        return self.w_q.permute(0, 3, 1, 2).float() * self.w_scale[:, None, None, None]

    def forward(self, x):
        return int8_conv2d(x, self.w_q, self.w_scale, self.bias, self.stride[0],
                           self.padding[0])


class Int8Linear(nn.Module):
    """A quantized `nn.Linear` with bias: `w_q` [O, I] int8, `w_scale` fp32
    [O] and `bias` fp32 [O] buffers, taken from the layer once."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        w_q, scale = quantize_weight(linear.weight.detach())
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", scale)
        self.register_buffer("bias", linear.bias.detach().float().clone())

    def dequantized(self) -> torch.Tensor:
        """w_q · w_scale, fp32 [O, I]."""
        return self.w_q.float() * self.w_scale[:, None]

    def forward(self, x):
        return int8_dense(x, self.w_q, self.w_scale, self.bias)


def _quantized(module: nn.Module, path: tuple, skip, quantize_dense: bool) -> nn.Module:
    if any(s in path for s in skip):
        return module
    if type(module) is nn.Conv2d and module.bias is not None:
        return Int8Conv2d(module)
    if type(module) is nn.Linear and module.bias is not None:
        return Int8Linear(module) if quantize_dense else module
    children = {name: _quantized(child, path + (name,), skip, quantize_dense)
                for name, child in module.named_children()}
    if all(children[name] is child for name, child in module.named_children()):
        return module
    new = copy.copy(module)  # the parameters, buffers and other children are shared
    new._modules = {**module._modules, **children}
    return new


def quantize_unet(unet: nn.Module, skip: tuple = DEFAULT_SKIP,
                  quantize_dense: bool = False) -> nn.Module:
    """The UNet with every convolution that has a bias quantized (the 3×3s,
    the stride-2 downsamples, the 1×1 shortcuts, `proj_in` / `proj_out`),
    and with `quantize_dense` every `nn.Linear` with a bias too
    (`time_emb_proj`, the attention's `o`, the GEGLU's projections), as
    `quantize_unet_params` (`quant.py:108`) takes the leaves with a `"b"`.
    The bias-free projections (q, and the fused qkv / kv) and the subtrees
    named in `skip` stay as they are. The caller's UNet is not changed: the
    result is a new module tree whose unquantized submodules are the
    caller's own."""
    return _quantized(unet, (), tuple(skip), quantize_dense)
