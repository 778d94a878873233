"""The recon machinery of `adaface_tpu_torch/train/recon_multistep.py`
against `adaface_tpu/train/recon_multistep.py`, on the CPU in fp32.

`smooth_tensor` at each kernel; `smooth_grad`'s identity forward and its
gradient against `jax.grad` of JAX's custom VJP; `recon_multistep_denoise`
(one priming step, two recon steps, the adversarial gradient) and
`redenoise_subj_single` on the tiny UNet and VAE of `test_torch_models.py`,
JAX's normals (one a step, from the keys JAX splits) handed to the port's
`Draws`. Tolerances: 1e-5 of the largest magnitude for the smoothing and
its gradient; 1e-4 for the latents of a UNet step (module parity
compounded, as `test_torch_models.py`'s UNet); the quality weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.ops.schedules import DiffusionSchedule as JSchedule
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.train import recon_multistep as jrm
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.train import recon_multistep as trm
from adaface_tpu_torch.utils.tensor import Draws
from tests.test_torch_models import (D, UNET_KW, VAE_KW, _t, assert_close_rel, numpy_params)
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

SMOOTH_RTOL = 1e-5
LATENT_RTOL = 1e-4


@pytest.mark.parametrize("centre", [1, 2, 3, 4])
def test_smooth_tensor_matches_jax(centre):
    x = np.random.RandomState(centre).randn(2, 3, 9, 7).astype(np.float32)
    assert_close_rel(trm.smooth_tensor(_t(x), centre).numpy(),
                     jrm.smooth_tensor(jnp.asarray(x), centre), SMOOTH_RTOL)
    half = trm.smooth_tensor(_t(x).to(torch.bfloat16), centre)
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("centre", [1, 3])
def test_smooth_grad_matches_jax_grad(centre):
    """Identity forward; ∂/∂x of Σ w ⊙ smooth_grad(x) is the smoothed w, as
    `jax.grad` gives it through JAX's custom VJP."""
    rs = np.random.RandomState(10 + centre)
    x, w = rs.randn(2, 4, 8, 8).astype(np.float32), rs.randn(2, 4, 8, 8).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jrm.smooth_grad(x, centre) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = trm.smooth_grad(xt, centre)
    assert torch.equal(y, xt)
    (g,) = torch.autograd.grad((y * _t(w)).sum(), xt)
    assert_close_rel(g.numpy(), ref, SMOOTH_RTOL)


@pytest.fixture(scope="module")
def tiny():
    """(JAX UNet params, VAE params, context, the port's UNet, VAE decoder,
    context tensor)."""
    cfg_j = junet.UNetConfig(**UNET_KW)
    unet_p = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 50)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**VAE_KW)), 51)
    ctx = np.random.RandomState(52).randn(2, 8, D).astype(np.float32)
    unet = bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), unet_p)
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), bridge.vae_decoder_tree(vae_p))
    return unet_p, vae_p, ctx, unet, vae


def jax_model(unet_p, ctx):
    cfg = junet.UNetConfig(**UNET_KW)
    return lambda x_t, t, grad: junet.unet_apply(unet_p, x_t, t, ctx, cfg)[0]


def test_recon_multistep_denoise_matches_jax(tiny):
    unet_p, _, ctx, unet, _ = tiny
    rs = np.random.RandomState(53)
    x_start = rs.randn(2, 4, 16, 16).astype(np.float32)
    adv = rs.randn(2, 4, 16, 16).astype(np.float32)
    t0 = np.array([900, 640], np.int32)
    key = jax.random.PRNGKey(54)
    kw = dict(num_priming_steps=1, num_recon_steps=2, adv_grad_scale=0.5)
    ref = jax.jit(lambda p, x, t, k, a: jrm.recon_multistep_denoise(
        jax_model(p, ctx), JSchedule.create(), x, t, k, adv_grad=a, **kw))(
            unet_p, x_start, t0, key, adv)
    noises, k = [], key
    for _ in range(3):  # JAX's order: one split a step
        k, k1 = jax.random.split(k)
        noises.append(np.array(jax.random.normal(k1, x_start.shape, jnp.float32)))
    calls = []

    def model_fn(x_t, t, grad):
        calls.append(grad)
        return unet(x_t, t, _t(ctx))

    out = trm.recon_multistep_denoise(model_fn, DiffusionSchedule.create(), _t(x_start),
                                      _t(t0).long(), Draws(handed=noises), adv_grad=_t(adv), **kw)
    assert calls == [False, True, True]
    preds, noise, x_ts, ts = out
    assert preds.shape == (2, 2, 4, 16, 16)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(noise.numpy(), np.asarray(ref[1]))
    for got, want in zip((preds, x_ts), (ref[0], ref[2])):
        assert_close_rel(got.detach().numpy(), want, LATENT_RTOL)


def test_redenoise_subj_single_matches_jax(tiny):
    unet_p, vae_p, ctx, unet, vae = tiny
    rs = np.random.RandomState(55)
    ss, sc = (rs.randn(2, 4, 16, 16).astype(np.float32) for _ in range(2))
    boxes = np.array([[2.0, 3.0, 12.5, 14.0], [0.0, 0.0, 16.0, 16.0]], np.float32)
    key = jax.random.PRNGKey(56)
    vae_cfg = jvae.VAEConfig(**VAE_KW)

    def jax_fn(p, v, ss, sc, boxes, k, thres):
        return jrm.redenoise_subj_single(jax_model(p, ctx), JSchedule.create(), v, ss, sc, boxes,
                                         k, vae_cfg=vae_cfg, lap_var_thres=thres)

    k1, _ = jax.random.split(key)
    noise = np.array(jax.random.normal(k1, ss.shape, jnp.float32))
    jitted = jax.jit(jax_fn)
    lap = np.asarray(jax.jit(lambda v, z: jrm.var_of_laplacian(jvae.vae_decode(v, z, vae_cfg)))(
        vae_p, jitted(unet_p, vae_p, ss, sc, boxes, key, 0.0)[0]))
    # thresholds between and around the two images' Laplacian variances
    for thres in (float(lap.min()) * 0.5, float(lap.mean()), float(lap.max()) * 2.0):
        x0_j, w_j = jitted(unet_p, vae_p, ss, sc, boxes, key, thres)
        x0, w = trm.redenoise_subj_single(
            lambda x_t, t, grad: unet(x_t, t, _t(ctx)), DiffusionSchedule.create(), vae, _t(ss),
            _t(sc), _t(boxes), Draws(handed=[noise]), lap_var_thres=thres)
        assert_close_rel(x0.detach().numpy(), x0_j, LATENT_RTOL)
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    assert lap.min() != lap.max()
