"""The port's samplers and schedule methods against the JAX package's, on
the CPU in fp32.

Each sampler runs on the same numpy inputs on both sides, first with a toy
model (an elementwise function of x, t and the context, written once in
numpy terms for both) and then with the tiny UNet of
`tests/test_torch_models.py`, bridged from one numpy-seeded tree. Where the
JAX loop draws noise from a key (DDIM at eta > 0, LCM), the test repeats its
key splits and hands the draws to the port. Tolerance: 1e-4 of the
reference's largest magnitude (a few steps of fp32 arithmetic taken in
another order; the UNet through other convolution algorithms); the schedule
methods and single steps 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu.ops import samplers as jsamplers
from adaface_tpu.ops import schedules as jschedules
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import samplers as tsamplers
from adaface_tpu_torch.ops import schedules as tschedules
from tests.test_torch_models import D, UNET_KW, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

STEP_RTOL = 1e-6
SCHEDULE_J = jschedules.DiffusionSchedule.create()
SCHEDULE_T = tschedules.DiffusionSchedule.create()
SAMPLERS = ["ddim", "ddim_dual_eta", "dpm++", "pndm", "lcm", "euler", "rectified_flow"]


def _t(a):
    return torch.from_numpy(np.array(a))


def toy_model(xp):
    """eps(x, t, ctx) from elementwise ops that `xp` (jnp or torch) has."""
    def model_fn(x, t, ctx):
        tt = (t / 1000.0).reshape(-1, 1, 1, 1)
        return 0.4 * x * xp.cos(tt) + 0.1 * xp.sin(3.0 * x) + 0.2 * ctx.reshape(-1, 1, 1, 1)
    return model_fn


def jax_draws(key, n: int, shape):
    """The draws a JAX loop makes: key, sub = split(key) before each."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out) if out else np.zeros((0, *shape), np.float32)


def run_both(name, model_j, model_t, x, cond, uncond):
    """One sampler on both sides → (port's result, JAX's), as numpy."""
    jx, jc, ju = jnp.asarray(x), jnp.asarray(cond), jnp.asarray(uncond)
    tx, tc, tu = _t(x), _t(cond), _t(uncond)
    key = jax.random.PRNGKey(5)
    with torch.inference_mode():
        if name == "ddim":
            kw = dict(num_inference_steps=4, guidance_scale=3.0)
            ref = jsamplers.ddim_sample(model_j, SCHEDULE_J, jx, jc, ju,
                                        jsamplers.DDIMConfig(**kw))
            out = tsamplers.ddim_sample(model_t, SCHEDULE_T, tx, tc, tu,
                                        tsamplers.DDIMConfig(**kw))
        elif name == "ddim_dual_eta":
            kw = dict(num_inference_steps=4, guidance_scale=4.0, guidance_scale_min=1.5,
                      eta=0.7, spacing="trailing", set_alpha_to_one=True)
            ref = jsamplers.ddim_sample(model_j, SCHEDULE_J, jx, jc, ju,
                                        jsamplers.DDIMConfig(**kw), rng=key)
            out = tsamplers.ddim_sample(model_t, SCHEDULE_T, tx, tc, tu,
                                        tsamplers.DDIMConfig(**kw),
                                        noise=_t(jax_draws(key, 4, x.shape)))
        elif name == "dpm++":
            kw = dict(num_inference_steps=4, guidance_scale=3.0)
            ref = jsamplers.dpm_solver_pp_sample(model_j, SCHEDULE_J, jx, jc, ju, **kw)
            out = tsamplers.dpm_solver_pp_sample(model_t, SCHEDULE_T, tx, tc, tu, **kw)
        elif name == "pndm":
            kw = dict(num_inference_steps=6, guidance_scale=3.0)  # reaches the 4th order
            ref = jsamplers.pndm_sample(model_j, SCHEDULE_J, jx, jc, ju, **kw)
            out = tsamplers.pndm_sample(model_t, SCHEDULE_T, tx, tc, tu, **kw)
        elif name == "lcm":
            ref = jsamplers.lcm_sample(model_j, SCHEDULE_J, jx, jc, num_inference_steps=4,
                                       rng=key)
            out = tsamplers.lcm_sample(model_t, SCHEDULE_T, tx, tc, num_inference_steps=4,
                                       noise=_t(jax_draws(key, 3, x.shape)))
        elif name == "euler":
            kw = dict(num_inference_steps=4, guidance_scale=3.0, guidance_scale_min=2.0)
            ref = jsamplers.euler_sample(model_j, SCHEDULE_J, jx, jc, ju,
                                         jsamplers.DDIMConfig(**kw))
            out = tsamplers.euler_sample(model_t, SCHEDULE_T, tx, tc, tu,
                                         tsamplers.DDIMConfig(**kw))
        else:
            kw = dict(num_inference_steps=4, guidance_scale=3.0)
            ref = jsamplers.rectified_flow_sample(model_j, jx, jc, ju, **kw)
            out = tsamplers.rectified_flow_sample(model_t, tx, tc, tu, **kw)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_matches_jax_on_toy_model(name):
    rs = np.random.RandomState(30)
    x = rs.randn(2, 4, 8, 8).astype(np.float32)
    cond, uncond = rs.randn(2).astype(np.float32), rs.randn(2).astype(np.float32)
    out, ref = run_both(name, toy_model(jnp), toy_model(torch), x, cond, uncond)
    assert np.isfinite(out).all()
    assert_close_rel(out, ref)


@pytest.fixture(scope="module")
def unets():
    cfg_j = junet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 31)
    params["conv_out"]["w"] = params["conv_out"]["w"] * 0.1  # keeps the trajectories tame
    model_t = bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), params)
    # jitted: op by op a UNet call takes a minute on the CPU
    model_j = jax.jit(lambda x, t, ctx: junet.unet_apply(params, x, t, ctx, cfg_j)[0])
    return model_j, model_t


@pytest.mark.parametrize("name", ["ddim", "ddim_dual_eta", "dpm++", "pndm", "lcm"])
def test_sampler_matches_jax_on_tiny_unet(unets, name):
    model_j, model_t = unets
    rs = np.random.RandomState(32)
    x = rs.randn(1, 4, 16, 16).astype(np.float32)
    cond, uncond = (rs.randn(1, 77, D).astype(np.float32) for _ in range(2))
    out, ref = run_both(name, model_j, lambda x, t, c: model_t(x, t.long(), c), x, cond,
                        uncond)
    assert_close_rel(out, ref)


def test_samplers_draw_from_a_generator():
    """Without handed-in noise, DDIM at eta > 0 and LCM draw from the
    generator: the same seed gives the same latents, another seed others."""
    x = _t(np.random.RandomState(33).randn(1, 4, 8, 8).astype(np.float32))
    ctx = torch.zeros(1)
    gen = lambda s: torch.Generator().manual_seed(s)
    cfg = tsamplers.DDIMConfig(num_inference_steps=3, eta=1.0)
    for sample in (lambda g: tsamplers.ddim_sample(toy_model(torch), SCHEDULE_T, x, ctx,
                                                   cfg=cfg, generator=g),
                   lambda g: tsamplers.lcm_sample(toy_model(torch), SCHEDULE_T, x, ctx,
                                                  num_inference_steps=3, generator=g)):
        assert torch.equal(sample(gen(1)), sample(gen(1)))
        assert not torch.equal(sample(gen(1)), sample(gen(2)))
    with pytest.raises(ValueError, match="noise must be"):
        tsamplers.lcm_sample(toy_model(torch), SCHEDULE_T, x, ctx, num_inference_steps=3,
                             noise=torch.zeros(3, 1, 4, 8, 8))


@pytest.mark.parametrize("eta", [0.0, 0.6])
@pytest.mark.parametrize("per_sample", [False, True])
def test_ddim_step_matches_jax(eta, per_sample):
    """One step with host-scalar alphas (the pipeline's form) and with a
    value per sample on the device (the batcher's), at eta 0 and above."""
    rs = np.random.RandomState(34)
    x, eps, noise = (rs.randn(3, 4, 8, 8).astype(np.float32) for _ in range(3))
    ac = np.asarray(SCHEDULE_T.alphas_cumprod)
    if per_sample:
        a_t, a_p = ac[[801, 401, 41]].reshape(3, 1, 1, 1), ac[[761, 361, 1]].reshape(3, 1, 1, 1)
        args_t = (_t(a_t), _t(a_p))
    else:
        a_t, a_p = ac[401], ac[361]
        args_t = (a_t, a_p)
    ref = jsamplers.ddim_step(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(a_t),
                              jnp.asarray(a_p), eta, jnp.asarray(noise))
    out = tsamplers.ddim_step(_t(x), _t(eps), *args_t, eta, _t(noise))
    for o, r in zip(out, ref):
        assert_close_rel(o.numpy(), r, STEP_RTOL)
    # the noise only enters at eta > 0
    silent = tsamplers.ddim_step(_t(x), _t(eps), *args_t, eta, None)[0]
    assert torch.equal(silent, out[0]) == (eta == 0.0)


def test_multistep_denoise_matches_jax():
    rs = np.random.RandomState(35)
    x0 = rs.randn(2, 4, 8, 8).astype(np.float32)
    noises = rs.randn(3, 2, 4, 8, 8).astype(np.float32)
    ts = np.array([[900, 700], [500, 400], [100, 50]], np.int32)
    toy_j, toy_t = toy_model(jnp), toy_model(torch)
    ref = jsamplers.multistep_denoise(lambda x, t, c: toy_j(x, t, jnp.zeros(2)), SCHEDULE_J,
                                      jnp.asarray(x0), jnp.asarray(noises), jnp.asarray(ts))
    out = tsamplers.multistep_denoise(lambda x, t, c: toy_t(x, t, torch.zeros(2)), SCHEDULE_T,
                                      _t(x0), _t(noises), _t(ts).long())
    for o, r in zip(out, ref):
        assert o.shape == (3, 2, 4, 8, 8)
        assert_close_rel(o.numpy(), r, 1e-5)  # three steps of 1e-6 each, amplified by 1/sqrt(a)


@pytest.mark.parametrize("method", ["q_sample", "predict_start_from_noise",
                                    "predict_noise_from_start", "q_posterior", "velocity"])
def test_schedule_method_matches_jax(method):
    rs = np.random.RandomState(36)
    a, b = (rs.randn(4, 4, 8, 8).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 500, 999], np.int32)
    args = (a, b, t) if method == "q_posterior" else (a, t, b)
    ref = getattr(SCHEDULE_J, method)(*(jnp.asarray(v) for v in args))
    out = getattr(SCHEDULE_T, method)(*(_t(v).long() if v is t else _t(v) for v in args))
    if method != "q_posterior":
        ref, out = (ref,), (out,)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        assert_close_rel(o.numpy(), r, STEP_RTOL)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_schedule_tables_and_extract_match_jax(kind):
    sj = jschedules.DiffusionSchedule.create(kind, timesteps=200, v_posterior=0.1)
    st = tschedules.DiffusionSchedule.create(kind, timesteps=200, v_posterior=0.1)
    assert st.num_timesteps == 200
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(st, name), np.asarray(getattr(sj, name)), name)
    t = np.array([3, 199, 0], np.int64)
    got = tschedules.extract(st.table("betas", "cpu"), _t(t), (3, 4, 8, 8))
    assert got.shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jschedules.extract(sj.betas, jnp.asarray(t), (3, 4, 8, 8))))
    assert st.table("betas", "cpu") is st.table("betas", "cpu")  # copied to a device once
