"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and its port
in fp32 (the root conftest sets JAX matmuls to "highest"). Where the JAX
function reaches a Pallas kernel it runs in interpret mode, as the JAX
package's own tests run it. On the CPU the port's kernel wrappers take
their plain versions. Tolerance for ops: 1e-5 abs, fp32 rounding of sums
taken in another order.
"""

import functools
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from adaface_tpu.ops import attention as jattn
from adaface_tpu.ops import fused_gn as jgn
from adaface_tpu.ops import fused_ln as jln
from adaface_tpu.ops import samplers as jsamp
from adaface_tpu.ops import schedules as jsched
from adaface_tpu_torch.ops import _build
from adaface_tpu_torch.ops import attention as tattn
from adaface_tpu_torch.ops import fused_gn as tgn
from adaface_tpu_torch.ops import fused_ln as tln
from adaface_tpu_torch.ops import fused_norm as tfn
from adaface_tpu_torch.ops import samplers as tsamp
from adaface_tpu_torch.ops import schedules as tsched

OP_ATOL = 1e-5


def _qkv(seed, b, h, sq, sk, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, sq, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32),
            rs.randn(b, h, sk, d).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("sq,sk,d,masked,causal", [
    (16, 24, 8, False, False),
    (8, 8, 4, False, True),
    # batch 1 masks keys 0..3: with causal, its rows 0..3 see only masked
    # keys and average V (logit -1e30 on every key), in both versions
    (12, 12, 16, True, True),
    (20, 77, 40, True, False),
])
def test_sdpa_matches_jax(sq, sk, d, masked, causal):
    q, k, v = _qkv(0, 2, 2, sq, sk, d)
    mask = None
    if masked:
        mask = np.ones((2, sk), np.float32)
        mask[1, :4] = 0.0
        mask[0, sk - 3:] = 0.0
    ref = jattn.scaled_dot_product_attention(
        q, k, v, kv_mask=None if mask is None else jnp.asarray(mask), causal=causal)
    out = tattn.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


@pytest.mark.parametrize("layout,sq,sk,d,masked,causal", [
    # `_flash_t_kernel`: D < 128, Sk = 77 pads the keys, which sets its mask pass
    ("transposed", 130, 77, 40, False, False),
    # `_flash_kernel`: D >= 128 with a key mask and the causal flag; batch 0
    # masks keys 0..7, so its rows 0..7 are fully masked
    ("standard", 128, 128, 160, True, True),
])
def test_flash_matches_pallas_interpret(layout, sq, sk, d, masked, causal):
    q, k, v = _qkv(1, 2, 2, sq, sk, d)
    mask = None
    if masked:
        mask = np.ones((2, sk), np.float32)
        mask[0, :8] = 0.0
        mask[1, 100:] = 0.0
    ref = jattn.flash_attention(
        q, k, v, kv_mask=None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=128, block_k=128, interpret=True)
    out = tattn.flash_attention(
        _t(q), _t(k), _t(v), kv_mask=None if mask is None else _t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)


@pytest.mark.parametrize("hw,c,silu", [
    ((4, 4), 256, True),
    ((4, 4), 256, False),
    ((7, 7), 128, True),  # 49 rows: not a multiple of the row block
    ((7, 7), 128, False),
])
def test_group_norm_matches_pallas_interpret(hw, c, silu):
    rs = np.random.RandomState(2)
    x = (rs.randn(2, *hw, c) * 2.0 + 0.5).astype(np.float32)  # NHWC, as JAX
    scale = (rs.randn(c) + 1.0).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    with mock.patch.object(jgn.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = jgn.fused_group_norm_silu(x, scale, bias, 32, 1e-5, apply_silu=silu,
                                        use_pallas=True)
    out = tgn.group_norm_silu(_t(x.transpose(0, 3, 1, 2)).contiguous(), _t(scale),
                              _t(bias), 32, 1e-5, apply_silu=silu)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               atol=OP_ATOL)


def _ln_inputs(seed, rows, c):
    rs = np.random.RandomState(seed)
    return ((rs.randn(rows, c) * 2.0 + 0.5).astype(np.float32),
            (rs.randn(c) + 1.0).astype(np.float32),
            (rs.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("shape", [
    (2, 16, 64),  # 32 rows
    (3, 7, 40),  # 21 rows: not a multiple of the row block
])
def test_layer_norm_matches_pallas_interpret(shape):
    x, scale, bias = _ln_inputs(4, int(np.prod(shape[:-1])), shape[-1])
    x = x.reshape(shape)
    with mock.patch.object(jln.pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = jln.fused_layer_norm(x, scale, bias, 1e-5, use_pallas=True)
    out = tln.fused_layer_norm(_t(x), _t(scale), _t(bias), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    module = tln.LayerNorm(shape[-1])
    with torch.no_grad():
        module.weight.copy_(_t(scale))
        module.bias.copy_(_t(bias))
    np.testing.assert_array_equal(module(_t(x)).detach().numpy(), out.numpy())


def test_layer_norm_raises_on_a_strided_view():
    """The UNet's transformer input is a permuted map: the LayerNorm takes it
    only made contiguous, on the CPU as on the card, and copies nothing itself."""
    x = torch.randn(2, 8, 4, 4).permute(0, 2, 3, 1).reshape(2, 16, 8)
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tln.fused_layer_norm(x, torch.ones(8), torch.zeros(8))


def test_layer_norm_grad_matches_jax():
    """The Function's backward recomputes through the plain version, as
    `_ln_bwd` does through `_ln_ref`: x, weight and bias gradients."""
    x, scale, bias = _ln_inputs(5, 12, 32)
    ref = jax.grad(lambda x, s, b: (jln.fused_layer_norm(x, s, b, use_pallas=False) ** 3).sum(),
                   argnums=(0, 1, 2))(x, scale, bias)
    xt, st, bt = (_t(a).requires_grad_(True) for a in (x, scale, bias))
    (tln.fused_layer_norm(xt, st, bt) ** 3).sum().backward()
    for out, r in zip((xt.grad, st.grad, bt.grad), ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_schedule_tables_match_jax():
    for kind in ("linear", "cosine", "sqrt_linear", "sqrt"):
        js, ts = jsched.DiffusionSchedule.create(kind), tsched.DiffusionSchedule.create(kind)
        np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
        np.testing.assert_array_equal(ts.betas, np.asarray(js.betas))
    for spacing in ("leading", "trailing", "uniform"):
        np.testing.assert_array_equal(tsched.ddim_timesteps(1000, 25, spacing=spacing),
                                      jsched.ddim_timesteps(1000, 25, spacing=spacing))
    cfg_j = jsamp.DDIMConfig(num_inference_steps=7, guidance_scale=6.0,
                             guidance_scale_min=1.0)
    cfg_t = tsamp.DDIMConfig(num_inference_steps=7, guidance_scale=6.0,
                             guidance_scale_min=1.0)
    for a, b in zip(jsamp._alpha_tables(jsched.DiffusionSchedule.create(), cfg_j),
                    tsamp._alpha_tables(tsched.DiffusionSchedule.create(), cfg_t)):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_allclose(tsamp.guidance_scales(cfg_t),
                               np.asarray(jsamp.guidance_scales(cfg_j)), atol=1e-6)


def test_ddim_sample_matches_jax():
    """A toy linear eps-model through both CFG DDIM loops (4 steps)."""
    rs = np.random.RandomState(3)
    x_T = rs.randn(2, 4, 8, 8).astype(np.float32)
    cond = rs.randn(2, 5, 4).astype(np.float32)
    uncond = rs.randn(2, 5, 4).astype(np.float32)
    w = rs.randn(4, 4).astype(np.float32) * 0.1

    def model_j(x, t, ctx):
        c = ctx.mean(axis=1)[:, :, None, None]
        return jnp.einsum("bchw,cd->bdhw", x, w) + c + t[:, None, None, None] * 1e-3

    def model_t(x, t, ctx):
        c = ctx.mean(dim=1)[:, :, None, None]
        return torch.einsum("bchw,cd->bdhw", x, _t(w)) + c + t[:, None, None, None] * 1e-3

    kw = dict(num_inference_steps=4, guidance_scale=5.0, guidance_scale_min=2.0)
    ref = jsamp.ddim_sample(model_j, jsched.DiffusionSchedule.create(), jnp.asarray(x_T),
                            jnp.asarray(cond), jnp.asarray(uncond), jsamp.DDIMConfig(**kw))
    out = tsamp.ddim_sample(model_t, tsched.DiffusionSchedule.create(), _t(x_T), _t(cond),
                            _t(uncond), tsamp.DDIMConfig(**kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_kernel_modules_run_plain_on_cpu_without_toolchain():
    """The kernel modules import and run with no nvcc, no triton and no card:
    CPU tensors take the plain versions, nothing is built, nothing counted."""
    _build.reset_launch_counts()
    q = torch.randn(1, 2, 256, 40)
    tattn.multi_head_attention(q, q, q)  # the flash route at q-length 256
    x = torch.randn(2, 64, 4, 4)
    tgn.group_norm_silu(x, torch.ones(64), torch.zeros(64), 8, 1e-5)
    tln.fused_layer_norm(torch.randn(8, 64), torch.ones(64), torch.zeros(64))
    xb = torch.randn(2, 4, 4, 64, requires_grad=True)
    tfn.fused_bn_act(xb, torch.ones(64), torch.zeros(64), slope=0.0).sum().backward()
    assert sum(_build.LAUNCHES.values()) == 0
    assert _build.load_library.cache_info().currsize == 0
    code = ("import sys; import adaface_tpu_torch.ops.attention, "
            "adaface_tpu_torch.ops.fused_gn, adaface_tpu_torch.ops.fused_ln, "
            "adaface_tpu_torch.ops.fused_norm, adaface_tpu_torch.ops._build; "
            "assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
