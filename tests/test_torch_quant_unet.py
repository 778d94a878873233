"""The int8 UNet of the PyTorch port against the JAX package, on the CPU.

A tiny int8 UNet (with and without `quantize_dense`) against `unet_apply`
on `quantize_unet_params`' tree (DoRA on an int8 base: in
`tests/test_torch_quant_dora.py`). An activation
within fp32 rounding of a half step rounds to the neighbouring int8 value
on one side, and on random weights the difference grows through the layers
after it: of the tiny UNet's 94 quantized activations (440 k values), the
first to differ had 1 value one step apart, the last ~5 k up to 9 steps
apart. So each UNet is held twice: free-running at `UNET_INT8_RTOL`
(measured: 2.5e-2 and 3.8e-2 of the largest |eps| without and with DoRA),
the first differing layer's flips bounded (`FLIPPED_SHARE`); and with JAX's
int8 activations and scales handed to the port layer by layer, at the
module bar of 1e-4 (`MODULE_RTOL`): then only the fp32 parts differ.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu.ops import quant as jquant
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import quant
from tests.test_torch_models import D, assert_close_rel
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_quant import _t, jax_quantized, tiny  # noqa: F401 (fixture)

UNET_INT8_RTOL = 5e-2  # free-running int8 UNet against JAX's (measured 2.5e-2, 3.8e-2)
FLIPPED_SHARE = 1e-3  # of the first differing layer's values: a rounding, not a rule


def recorded_quantization():
    """Patches that record every activation each side quantizes, in order:
    the port's `quantize_act` (x_q) and JAX's `_quantize_act` ((x_q, scale),
    by a callback from inside the jitted graph; x_q NCHW as the port's)."""
    port, jax_side = [], []
    port_fn, jax_fn = quant.quantize_act, jquant._quantize_act

    def port_rec(x):
        q, s = port_fn(x)
        port.append(q.numpy().copy())
        return q, s

    def keep(q, s):
        jax_side.append((np.moveaxis(np.asarray(q), -1, 1) if q.ndim == 4 else np.asarray(q),
                         np.asarray(s)))

    def jax_rec(x):
        q, s = jax_fn(x)
        jax.debug.callback(keep, q, s, ordered=True)
        return q, s

    patches = (mock.patch.object(quant, "quantize_act", port_rec),
               mock.patch.object(jquant, "_quantize_act", jax_rec))
    return port, jax_side, patches


def handed(jax_side: list):
    """A patch of the port's `quantize_act` that returns JAX's int8
    activations and scales, layer by layer, in call order."""
    it = iter(jax_side)

    def replay(x):
        q, s = next(it)
        assert q.shape == tuple(x.shape)
        return torch.from_numpy(q.copy()), torch.tensor(float(s))

    return mock.patch.object(quant, "quantize_act", replay)


def flipped(port: list, jax_side: list, what: str) -> None:
    """Print and bound the activations quantized to another int8 value: at
    the first layer that differs (a rounding at a half step: few), and in
    all (that flip moves every layer after it)."""
    assert len(port) == len(jax_side) and port
    counts = [int((a != b).sum()) for a, (b, _) in zip(port, jax_side)]
    first = next((i for i, c in enumerate(counts) if c), None)
    total = sum(a.size for a in port)
    print(f"{what}: {sum(counts)} of {total} int8 activations rounded differently from JAX's; "
          f"first at layer {first} of {len(port)}"
          + ("" if first is None else f" ({counts[first]} of {port[first].size})"))
    if first is not None:
        assert counts[first] <= FLIPPED_SHARE * port[first].size


@pytest.mark.parametrize("quantize_dense", [False, True])
def test_int8_unet_matches_jax(tiny, quantize_dense):
    cfg_j, cfg_t, params = tiny
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    q = quant.quantize_unet(model, quantize_dense=quantize_dense)
    rs = np.random.RandomState(52)
    x, t = rs.randn(2, 4, 16, 16).astype(np.float32), np.array([700, 90], np.int32)
    ctx = rs.randn(2, 77, D).astype(np.float32)
    qp = jax_quantized("float32", quantize_dense)[1]
    port, jax_side, (p1, p2) = recorded_quantization()
    with p1, p2:
        ref = jax.jit(lambda p, x, t, c: junet.unet_apply(p, x, t, c, cfg_j)[0])(qp, x, t, ctx)
        jax.effects_barrier()
        with torch.inference_mode():
            out = q(_t(x), _t(t).long(), _t(ctx))
    flipped(port, jax_side, f"int8 UNet, quantize_dense={quantize_dense}")
    assert_close_rel(out.numpy(), ref, UNET_INT8_RTOL)
    with handed(jax_side), torch.inference_mode():
        replayed = q(_t(x), _t(t).long(), _t(ctx))
    assert_close_rel(replayed.numpy(), ref)
    with torch.inference_mode():
        fp = model(_t(x), _t(t).long(), _t(ctx))
    assert not torch.equal(out, fp)
