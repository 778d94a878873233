"""Int8 post-training quantization of the PyTorch port against the JAX
package, on the CPU: the operations and the UNet's quantization.

`adaface_tpu_torch/ops/quant.py` against `adaface_tpu/ops/quant.py`:
- the weights' and the activations' quantization, bit for bit;
- `int8_conv2d` (3x3 at stride 1 and 2, 1x1) and `int8_dense` on the same
  int8 operands: the integer sums are exact on both sides, so the outputs
  differ by the epilogue's fp32 rounding at most (`EPILOGUE_RTOL`: XLA may
  fuse the multiply and the add into one rounding where the port rounds
  each);
- a 3x3 over 1280 channels at ±127, whose sums pass fp32's 2²⁴: exact;
- `quantize_unet` against `quantize_unet_params`: the same leaves, with and
  without `quantize_dense`, equal to the bit on bridged fp32 and bf16
  weights, and the caller's UNet unchanged; the JAX tree carried in by the
  bridge;
- the kernel's refusals, and the module's import without a toolchain (its
  launch plan and indexing are in `tests/test_torch_int8_plan.py`).
The whole int8 UNet is in `tests/test_torch_quant_unet.py`, the pipeline
and the wrapper in `tests/test_torch_quant_serving.py`.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu.ops import quant as jquant
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import quant
from tests.test_torch_models import UNET_KW, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

EPILOGUE_RTOL = 1e-6  # of the output's largest magnitude: an fp32 rounding or two


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_conv_params(rs, kh, cin, cout):
    w = rs.randn(kh, kh, cin, cout).astype(np.float32) / np.sqrt(kh * kh * cin)
    w[..., 0] = 0.0  # a zero channel: the scale's 1e-8 floor
    w_q, scale = jquant.quantize_weight(jnp.asarray(w))
    return {"w_q": w_q, "w_scale": scale, "b": jnp.asarray(0.1 * rs.randn(cout), jnp.float32)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_weight_and_act_are_jaxs_bits(dtype):
    rs = np.random.RandomState(0)
    for shape in ((3, 3, 40, 24), (64, 48)):  # HWIO, IO
        w = jnp.asarray(rs.randn(*shape), dtype)
        w_q, scale = jquant.quantize_weight(w)
        w_t = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
        # the port keeps O first: OIHW / [O, I]
        w_t = w_t.permute(3, 2, 0, 1) if w_t.dim() == 4 else w_t.T
        tq, tscale = quant.quantize_weight(w_t)
        np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale))
        tq = tq.permute(2, 3, 1, 0) if tq.dim() == 4 else tq.T
        np.testing.assert_array_equal(tq.numpy(), np.asarray(w_q))
    x = jnp.asarray(rs.randn(2, 8, 8, 32) * 3.0, dtype)
    x_q, x_scale = jquant._quantize_act(x)
    tx_q, tx_scale = quant.quantize_act(torch.from_numpy(np.asarray(x.astype(jnp.float32))))
    assert tx_q.dtype == torch.int8 and int(tx_q.abs().max()) == 127
    np.testing.assert_array_equal(tx_q.numpy(), np.asarray(x_q))
    assert tx_scale.item() == float(x_scale)


@pytest.mark.parametrize("kh,stride", [(3, 1), (3, 2), (1, 1)])
def test_int8_conv2d_matches_jax(kh, stride):
    rs = np.random.RandomState(kh * 10 + stride)
    p = jax_conv_params(rs, kh, 64, 48)
    x = rs.randn(2, 9, 10, 64).astype(np.float32)  # NHWC, odd sizes for stride 2
    pad = kh // 2
    ref = np.asarray(jquant.int8_conv2d(p, jnp.asarray(x), stride, pad))
    w_q = _t(p["w_q"]).permute(3, 0, 1, 2).contiguous()  # HWIO → [O, kh, kw, I]
    out = quant.int8_conv2d(_t(x).permute(0, 3, 1, 2), w_q, _t(p["w_scale"]), _t(p["b"]),
                            stride, pad)
    assert out.shape == (2, 48, *ref.shape[1:3])
    assert_close_rel(out.permute(0, 2, 3, 1).numpy(), ref, EPILOGUE_RTOL)


def test_int8_dense_matches_jax():
    rs = np.random.RandomState(3)
    w = rs.randn(96, 40).astype(np.float32) / np.sqrt(96)
    w_q, scale = jquant.quantize_weight(jnp.asarray(w))
    p = {"w_q": w_q, "w_scale": scale, "b": jnp.asarray(rs.randn(40), jnp.float32)}
    x = rs.randn(2, 17, 96).astype(np.float32)
    ref = np.asarray(jquant.int8_dense(p, jnp.asarray(x)))
    out = quant.int8_dense(_t(x), _t(w_q).T.contiguous(), _t(scale), _t(p["b"]))
    assert_close_rel(out.numpy(), ref, EPILOGUE_RTOL)


def test_int8_conv2d_sums_are_exact_past_2_to_24():
    """A 3x3 over 1280 channels of ±127 × ±127: sums up to 11,520 · 16,129 ≈
    1.9e8. The plain version's output equals the exact int64 sums put
    through the same epilogue, where fp32 sums would not be exact."""
    rs = np.random.RandomState(5)
    c, o = 1280, 8
    x = np.where(rs.rand(1, c, 6, 6) < 0.9, 1.0, -1.0).astype(np.float32)  # x_q = ±127
    w = np.where(rs.rand(o, c, 3, 3) < 0.9, 1.0, -1.0).astype(np.float32)
    w_q, w_scale = quant.quantize_weight(torch.from_numpy(w))
    assert int(w_q.abs().min()) == 127
    bias = torch.zeros(o)
    out = quant.int8_conv2d(torch.from_numpy(x), w_q.permute(0, 2, 3, 1).contiguous(),
                            w_scale, bias, 1, 1)
    xq = np.round(x * 127).astype(np.int64)
    wq = w_q.numpy().astype(np.int64)
    xp = np.pad(xq, ((0, 0), (0, 0), (1, 1), (1, 1)))
    exact = np.zeros((1, o, 6, 6), np.int64)
    for ky in range(3):
        for kx in range(3):
            exact += np.einsum("nchw,oc->nohw", xp[:, :, ky:ky + 6, kx:kx + 6], wq[:, :, ky, kx])
    assert np.abs(exact).max() > 2**24
    x_scale = torch.tensor(1.0) / 127.0
    ref = torch.from_numpy(exact).float() * (x_scale * w_scale).reshape(1, -1, 1, 1)
    assert torch.equal(out, ref + bias.reshape(1, -1, 1, 1))
    # what fp32 sums of the same integers give: not the exact sums
    f32 = torch.nn.functional.conv2d(torch.from_numpy(xq.astype(np.float32)),
                                     torch.from_numpy(wq.astype(np.float32)), padding=1)
    assert not torch.equal(f32.double(), torch.from_numpy(exact).double())


def flat(tree) -> dict:
    return {name: np.asarray(v) for name, v in bridge._walk(tree, "")}


@functools.lru_cache(maxsize=None)
def jax_quantized(dtype: str, quantize_dense: bool):
    """(the tiny UNet's JAX tree in `dtype`, its `quantize_unet_params`), run
    op by op as the JAX pipeline runs it (under `jit` XLA may fold the
    division by 127 into a product and move a scale by an ulp); cached, as
    it takes seconds."""
    params = numpy_params(lambda k: junet.init_unet_params(k, junet.UNetConfig(**UNET_KW)), 51)
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    return params, jquant.quantize_unet_params(params, quantize_dense=quantize_dense)


@pytest.fixture(scope="module")
def tiny():
    cfg_j, cfg_t = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
    return cfg_j, cfg_t, jax_quantized("float32", False)[0]


@pytest.mark.parametrize("quantize_dense", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_unet_is_quantize_unet_params(tiny, quantize_dense, dtype):
    """The same leaves quantized, to the bit; the caller's UNet unchanged and
    its unquantized submodules shared."""
    cfg_j, cfg_t, _ = tiny
    params, jtree = jax_quantized(dtype, quantize_dense)
    jq = flat(jtree)
    model = tunet.UNet2DConditionModel(cfg_t).to(getattr(torch, dtype))
    bridge.load(model, jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                              params))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q = quant.quantize_unet(model, quantize_dense=quantize_dense)
    tq = bridge.tree_state_dict(q)
    j_quantized = {k for k in jq if k.endswith(".w_q")}
    assert j_quantized == {k for k in tq if k.endswith(".w_q")}
    assert any(".time_emb_proj." in k for k in j_quantized) == quantize_dense
    for key in j_quantized:
        head = key[:-len(".w_q")]
        np.testing.assert_array_equal(tq[key], jq[key])
        np.testing.assert_array_equal(tq[f"{head}.w_scale"], jq[f"{head}.w_scale"])
        np.testing.assert_array_equal(tq[f"{head}.b"], np.asarray(jq[f"{head}.b"], np.float32))
    # an int8 layer holds one fp32 bias, taken once like w_q: the kernel and
    # the plain version read the same buffer
    layer = q.down_blocks[0].resnets[0].conv1
    assert set(layer.state_dict()) == {"w_q", "w_scale", "bias"}
    assert layer.bias.dtype == torch.float32
    assert layer.bias.data_ptr() != model.down_blocks[0].resnets[0].conv1.bias.data_ptr()
    # the caller's UNet keeps its modules and weights
    assert type(model.down_blocks[0].resnets[0].conv1) is torch.nn.Conv2d
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert q is not model
    assert q.down_blocks[0].resnets[0].norm1 is model.down_blocks[0].resnets[0].norm1
    assert q.conv_in is model.conv_in and q.time_mlp is model.time_mlp
    # the JAX tree carried in by the bridge equals the port's own quantization
    qtree = jax.tree_util.tree_map(  # bf16 leaves to fp32 numpy: torch takes no ml_dtypes
        lambda a: np.asarray(a if a.dtype == jnp.int8 else a.astype(jnp.float32)),
        jtree)
    loaded = bridge.load_quantized(tunet.UNet2DConditionModel(cfg_t).to(getattr(torch, dtype)),
                                   qtree)
    back = bridge.tree_state_dict(loaded)
    for key in j_quantized:
        np.testing.assert_array_equal(back[key], jq[key])


def test_kernel_module_imports_without_nvcc():
    """The module imports, and the CPU path runs, where there is no CUDA
    toolkit: nothing is built on import."""
    code = ("import shutil, sys\n"
            "from unittest import mock\n"
            "with mock.patch.object(shutil, 'which', lambda name: None):\n"
            "    import torch\n"
            "    from adaface_tpu_torch.ops import quant, _build\n"
            "    assert _build.load_library.cache_info().currsize == 0\n"
            "    x = torch.randn(1, 32, 4, 4)\n"
            "    w_q, s = quant.quantize_weight(torch.randn(8, 32, 3, 3))\n"
            "    y = quant.int8_conv2d(x, w_q.permute(0, 2, 3, 1).contiguous(), s,\n"
            "                          torch.zeros(8))\n"
            "    assert y.shape == (1, 8, 4, 4)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_kernel_widths_are_refused_loudly():
    for i, o in ((40, 64), (64, 12)):
        with pytest.raises(ValueError, match="multiples of 32"):
            quant.check_widths(i, o, "int8_conv2d")
    quant.check_widths(320, 320, "int8_conv2d")
