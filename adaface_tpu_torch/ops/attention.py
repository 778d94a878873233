"""Attention: plain PyTorch SDPA, the hand-written flash kernel, and routing.

Counterpart of `adaface_tpu/ops/attention.py` (forward only). Tensors are
[B, H, S, D] as there.

- `scaled_dot_product_attention` is the plain version: explicit matmuls and
  an fp32 softmax, the same math as the JAX reference (probabilities are cast
  to v's dtype before P·V, as there).
- `flash_attention` wraps `csrc/flash_attn_fwd.cu`, one CUDA kernel for the
  function both Pallas kernels computed (a tensor-core variant for bf16 at
  head dim <= 160, a CUDA-core one for fp32 and larger head dims, picked
  inside by dtype and head dim). On a CPU tensor it takes the plain
  version; on a CUDA tensor it launches the kernel or raises.
- `multi_head_attention` keeps the JAX package's routing: the flash path at
  q-length >= 256 (the JAX rule also requires no bias and no returned
  probabilities; no caller of the port passes either). Which of kernel or
  plain version then runs follows from the tensor's device alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from adaface_tpu_torch.ops import _build

NEG_INF = -1e30

# launch-counter keys, one per TPU kernel the CUDA kernel stands in for:
# `_dispatch_forward` sent non-causal D < 128 to `_flash_t_kernel`, the rest
# to `_flash_kernel` (adaface_tpu/ops/attention.py:355-361)
FLASH_T = "flash_attn_fwd[d<128]"
FLASH_STD = "flash_attn_fwd[d>=128|causal]"


def scaled_dot_product_attention(q, k, v, kv_mask=None, causal: bool = False,
                                 scale=None):
    """SDPA on [B, H, S, D]; fp32 scores and softmax.

    kv_mask [B, Sk]: 1 keeps a key, 0 gives it the logit NEG_INF.
    """
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(cols <= rows + (sk - sq), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _flash_cuda(q, k, v, kv_mask, causal: bool, scale: float):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(
                f"flash_attention: {name} must be [B,H,S,D] with a contiguous "
                f"head dim, got shape {tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not supported")
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do not agree")
    if not 1 <= d <= 512:
        raise ValueError(f"flash_attention: head dim {d} outside 1..512")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention: {q.device} is not the current device")
    mask = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, sk) or kv_mask.device != q.device:
            raise ValueError(f"flash_attention: kv_mask must be [B, Sk] = {(b, sk)} "
                             f"on {q.device}, got {tuple(kv_mask.shape)} on {kv_mask.device}")
        mask = kv_mask.to(torch.float32).contiguous()

    # [B, Sq, H, D] storage: the caller's merge of heads back into
    # [B, Sq, H*D] is then a view
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    lib = _build.load_library()
    rc = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(), strides,
        b, h, sq, sk, d, int(causal), float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attn_fwd")
    _build.LAUNCHES[FLASH_STD if causal or d >= 128 else FLASH_T] += 1
    return out


def flash_attention(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """Flash attention forward on [B, H, S, D]; output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return scaled_dot_product_attention(q, k, v, kv_mask=kv_mask,
                                            causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _flash_cuda(q, k, v, kv_mask, causal, scale)


def multi_head_attention(q, k, v, kv_mask=None, causal: bool = False, scale=None):
    """Route between the flash path and the plain version, as the JAX
    package does (`adaface_tpu/ops/attention.py:484-522`)."""
    if q.shape[-2] >= 256:
        return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal, scale=scale)
    return scaled_dot_product_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                                        scale=scale)
