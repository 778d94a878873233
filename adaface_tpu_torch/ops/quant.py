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
(bf16, channels-last maps): `quant_amax` (the whole tensor's max |x| into a
device scalar, never read on the host), `quant_act` (the int8 copy) and
`int8_conv_igemm` (the convolution, or a dense layer as a 1×1 convolution
over its rows, with the dequantize and the bias in its epilogue); on a CPU
tensor they take the plain versions. Every quantized width of the SD1.5
UNet is a multiple of 32 (320, 640, 960, 1280, 1920, 2560 input channels);
the kernel refuses any other. PyTorch has no eager int8 convolution on
CUDA; `chip_smoke.py` times im2col + `torch._int_mm` beside the kernel as a
yardstick only.
"""

from __future__ import annotations

import copy
import functools

import torch
import torch.nn.functional as F
from torch import nn

from adaface_tpu_torch.ops import _build

QUANT_AMAX = "quant_amax"
QUANT_ACT = "quant_act"
INT8_CONV = "int8_conv_igemm"
DEFAULT_SKIP = ("conv_in", "conv_out", "time_mlp")  # kept in their dtype (`quant.py:43`)
CHANNEL_STEP = 32  # bytes of the kernel's reduction step: the input width's multiple
TILE = 128  # output pixels (rows) and channels of one block of `int8_conv_igemm`
SPLIT_WAVES = 2  # blocks an SM the split reduction aims at
MIN_SPLIT_STEPS = 24  # reduction steps a split keeps at the least


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


def quantize_act_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernels `quant_amax` + `quant_act` on a contiguous (in memory) bf16 CUDA
    tensor → (x_q int8 in x's layout, amax [1] int32: the bits of max |x|, on
    the device). Two launches and a memset; nothing read back."""
    _cuda_checks(x, "quantize_act")
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load_library()
    amax = torch.empty(1, dtype=torch.int32, device=x.device)
    _build.check(lib.quant_amax(x.data_ptr(), x.numel(), amax.data_ptr(), stream), QUANT_AMAX)
    _build.count(QUANT_AMAX)
    x_q = torch.empty_like(x, dtype=torch.int8)
    _build.check(lib.quant_act(x.data_ptr(), amax.data_ptr(), x_q.data_ptr(), x.numel(),
                               stream), QUANT_ACT)
    _build.count(QUANT_ACT)
    return x_q, amax


def conv_out_hw(h: int, w: int, k: int, stride: int, padding: int) -> tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


def check_widths(i: int, o: int, what: str) -> None:
    if i % CHANNEL_STEP or o % 8:
        raise ValueError(f"{what}: the int8 kernel takes input widths that are multiples of "
                         f"{CHANNEL_STEP} and output widths of 8, got {i} -> {o}")


@functools.lru_cache(maxsize=None)
def igemm_splits(rows: int, o: int, steps: int, sms: int) -> int:
    """Blocks a tile of `int8_conv_igemm` splits its `steps` reduction steps
    over: 1 where the rows x o tiles fill the card, else enough for
    SPLIT_WAVES blocks an SM, each keeping MIN_SPLIT_STEPS steps at least
    (the 8² map's 3x3 over 1280 channels at CFG batch 2: 10 tiles of 360
    steps → 15 splits; a 1x1 over 1280 channels, 40 steps, is not split)."""
    tiles = -(-rows // TILE) * -(-o // TILE)
    if tiles >= sms:
        return 1
    return max(1, min(SPLIT_WAVES * sms // tiles, steps // MIN_SPLIT_STEPS))


def _igemm(x_q, amax, w_q, w_scale, bias32, n, h, w, k, stride, padding, splits=None):
    """Kernel `int8_conv_igemm` on int8 rows [n, h, w, I] → bf16 [n, ho, wo, O];
    `splits` of the reduction (`igemm_splits`' unless given). A split launch
    gets a workspace of its own: the partial tiles, then one counter a tile
    (zeroed on the stream by the launch), so launches on two streams or in
    two graph replays share nothing."""
    o, i = w_q.shape[0], w_q.shape[-1]
    ho, wo = conv_out_hw(h, w, k, stride, padding)
    rows = n * ho * wo
    if splits is None:
        splits = igemm_splits(rows, o, k * k * i // CHANNEL_STEP, _build.sm_count(x_q.device.index))
    y = torch.empty((n, ho, wo, o), dtype=torch.bfloat16, device=x_q.device)
    ws = None
    if splits > 1:
        tiles = -(-rows // TILE) * -(-o // TILE)
        ws = torch.empty(splits * rows * o + tiles, dtype=torch.int32, device=x_q.device)
    rc = _build.load_library().int8_conv_igemm(
        x_q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), bias32.data_ptr(), amax.data_ptr(),
        y.data_ptr(), n, h, w, i, o, k, k, stride, padding, ho, wo, splits,
        None if ws is None else ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, INT8_CONV)
    _build.count(INT8_CONV)
    return y


def _check_weights(w_q, w_scale, bias32, device):
    for name, t, dtype in (("w_q", w_q, torch.int8), ("w_scale", w_scale, torch.float32),
                           ("bias", bias32, torch.float32)):
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"int8 kernel: {name} must be a contiguous {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")


def int8_conv2d(x, w_q, w_scale, bias, stride: int = 1, padding: int = 1):
    """Quantized convolution (`int8_conv2d`, `quant.py:67`): x [N, I, H, W],
    w_q [O, kh, kw, I] int8 (kh = kw = 3 or 1), w_scale fp32 [O], bias [O].
    On CUDA: x bf16 in channels-last memory, bias fp32; → bf16 channels-last
    [N, O, Ho, Wo] through the three kernels. On the CPU the plain version."""
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
    if not x.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("int8_conv2d kernel: x must be in channels-last memory")
    _cuda_checks(x, "int8_conv2d")
    _check_weights(w_q, w_scale, bias, x.device)
    x_q, amax = quantize_act_cuda(x)
    y = _igemm(x_q, amax, w_q, w_scale, bias, n, h, w, kh, stride, padding)
    return y.permute(0, 3, 1, 2)


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
    _cuda_checks(x, "int8_dense")
    _check_weights(w_q, w_scale, bias, x.device)
    rows = x.numel() // i
    x_q, amax = quantize_act_cuda(x)
    y = _igemm(x_q, amax, w_q.reshape(o, 1, 1, i), w_scale, bias, rows, 1, 1, 1, 1, 0)
    return y.reshape(*x.shape[:-1], o)


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
