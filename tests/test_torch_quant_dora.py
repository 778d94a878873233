"""DoRA adapters on an int8 base in the PyTorch port against the JAX
package, on the CPU (`adaface_tpu/models/unet.py:214-217`, `:233-236`).

The adapted layers compose on the dequantized weight and run it
unquantized; a gated batch's plain rows run int8. Held as the int8 UNet is
(`tests/test_torch_quant_unet.py`): free-running at `UNET_INT8_RTOL`
(measured 3.8e-2: int8 values that round the other way move the later
layers on random weights) and with JAX's int8 activations handed over at
the module bar of 1e-4.
"""

import dataclasses

import jax
import numpy as np
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import quant
from tests.test_torch_comp import lora_trees
from tests.test_torch_models import D, assert_close_rel
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_quant import _t, jax_quantized, tiny  # noqa: F401 (fixture)
from tests.test_torch_quant_unet import (UNET_INT8_RTOL, flipped, handed,
                                         recorded_quantization)


def test_dora_on_an_int8_base_matches_jax(tiny):
    """The adapted layers compose on the dequantized weight and run it
    unquantized; the gate's plain rows run int8 (`unet.py:214-217`,
    `:233-236`)."""
    cfg_j, cfg_t, params = tiny
    rank = 4
    cfg_j = dataclasses.replace(cfg_j, lora_rank=rank)
    cfg_t = dataclasses.replace(cfg_t, lora_rank=rank)
    attn, ffn = lora_trees(cfg_j, 53)
    t_attn = bridge.load_lora(tunet.AttnLoRA(cfg_t), attn).requires_grad_(False)
    t_ffn = bridge.load_lora(tunet.FFNLoRA(cfg_t), ffn).requires_grad_(False)
    q = quant.quantize_unet(bridge.load(tunet.UNet2DConditionModel(cfg_t), params),
                            quantize_dense=True)
    qp = jax_quantized("float32", True)[1]
    rs = np.random.RandomState(53)
    x, t = rs.randn(2, 4, 16, 16).astype(np.float32), np.array([300, 10], np.int32)
    ctx = rs.randn(2, 77, D).astype(np.float32)
    gate = np.array([1.0, 0.0], np.float32)
    rt = dict(use_attn_lora=True, use_ffn_lora=True, ffn_adapter="comp_distill")
    port, jax_side, (p1, p2) = recorded_quantization()
    kw = dict(rt=tunet.AttnRuntime(**rt), attn_lora=t_attn, ffn_lora=t_ffn,
              attn_lora_gate=_t(gate), ffn_lora_gate=_t(gate))
    with p1, p2:
        ref = jax.jit(lambda p, x, t, c, a, f, g: junet.unet_apply(
            p, x, t, c, cfg_j, rt=junet.AttnRuntime(**rt), attn_lora=a, ffn_lora=f,
            attn_lora_gate=g, ffn_lora_gate=g)[0])(qp, x, t, ctx, attn, ffn, gate)
        jax.effects_barrier()
        with torch.inference_mode():
            out = q(_t(x), _t(t).long(), _t(ctx), **kw)
    flipped(port, jax_side, "int8 UNet with DoRA")
    assert_close_rel(out.numpy(), ref, UNET_INT8_RTOL)
    with handed(jax_side), torch.inference_mode():
        replayed = q(_t(x), _t(t).long(), _t(ctx), **kw)
    assert_close_rel(replayed.numpy(), ref)
    with torch.inference_mode():
        plain = q(_t(x), _t(t).long(), _t(ctx))
    assert not torch.equal(out[0], plain[0])
