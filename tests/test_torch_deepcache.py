"""DeepCache (encoder caching) of the PyTorch port against the JAX package,
on the CPU in fp32: the cases of `tests/test_deepcache.py`, each held to
`unet_apply(deepcache=...)` and to JAX's `ddim_sample` / pipeline.

Within the port, "collect" equals a plain call and a shallow call on a
fresh cache equals the full one, bit for bit (the same layers run on the
same inputs). Against JAX: eps and the cache at 1e-5 of their largest
magnitude (fp32 sums in another order through a few layers: the UNet's own
parity is ~2e-6), latents after a DeepCache DDIM loop at 1e-5 of their
scale, and images at 1e-4 (pixels in [0, 1], the serving tests' bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.pipeline import DiffusionPipeline as JPipeline
from adaface_tpu.models import unet as junet
from adaface_tpu.ops import samplers as jsamplers
from adaface_tpu.ops.schedules import DiffusionSchedule as JSchedule
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.inference.pipeline import DiffusionPipeline
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import samplers as tsamplers
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from tests.test_torch_comp import lora_trees
from tests.test_torch_models import D, UNET_KW, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_serving import HW, IMAGE_ATOL
from tests.test_torch_slice import NEGATIVE, make_wrapper_pair

DC_RTOL = 1e-5
PROMPT = "a photo of a person"


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 31)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    rs = np.random.RandomState(31)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    t = np.array([500, 100], np.int32)
    ctx = rs.randn(2, 77, D).astype(np.float32)
    return cfg_j, params, model, (x, t, ctx)


def test_collect_matches_plain_and_jax(setup):
    cfg_j, params, model, (x, t, ctx) = setup
    with torch.inference_mode():
        plain = model(_t(x), _t(t).long(), _t(ctx))
        eps, cache = model(_t(x), _t(t).long(), _t(ctx), deepcache="collect")
    assert torch.equal(eps, plain)
    # the feature entering the last up block: [B, C0, h, w], channels-last
    assert cache.shape == (2, UNET_KW["block_channels"][1], 16, 16)
    assert cache.is_contiguous(memory_format=torch.channels_last)
    eps_j, _, cache_j = jax.jit(lambda p, x, t, c: junet.unet_apply(
        p, x, t, c, cfg_j, deepcache="collect"))(params, x, t, ctx)
    assert_close_rel(eps.numpy(), eps_j, DC_RTOL)
    assert_close_rel(cache.permute(0, 2, 3, 1).numpy(), cache_j, DC_RTOL)  # JAX keeps NHWC


def test_shallow_with_fresh_cache_is_exact(setup):
    """A shallow call on the cache collected at the same (x, t) recomputes
    exactly the layers outside the cached trunk: the full eps, bit for bit."""
    _, _, model, (x, t, ctx) = setup
    with torch.inference_mode():
        eps, cache = model(_t(x), _t(t).long(), _t(ctx), deepcache="collect")
        shallow = model(_t(x), _t(t).long(), _t(ctx), deepcache=("shallow", cache))
    assert torch.equal(shallow, eps)


def test_shallow_on_a_stale_cache_approximates_and_matches_jax(setup):
    cfg_j, params, model, (x, t, ctx) = setup
    t2 = t - 20  # an adjacent timestep: the encoder's features barely move
    with torch.inference_mode():
        _, cache = model(_t(x), _t(t).long(), _t(ctx), deepcache="collect")
        ref = model(_t(x), _t(t2).long(), _t(ctx))
        shallow = model(_t(x), _t(t2).long(), _t(ctx), deepcache=("shallow", cache))
    assert np.corrcoef(ref.numpy().ravel(), shallow.numpy().ravel())[0, 1] > 0.95

    def jax_stale(p, x, t, t2, c):
        _, _, cache_j = junet.unet_apply(p, x, t, c, cfg_j, deepcache="collect")
        return junet.unet_apply(p, x, t2, c, cfg_j, deepcache=("shallow", cache_j))[0]

    assert_close_rel(shallow.numpy(), jax.jit(jax_stale)(params, x, t, t2, ctx), DC_RTOL)


def test_shallow_pass_pops_the_three_shallow_skips(setup):
    """The shallow pass runs conv_in, down block 0 (no downsample), the last
    up block and the head: exactly those modules, each once."""
    _, _, model, (x, t, ctx) = setup
    with torch.inference_mode():
        _, cache = model(_t(x), _t(t).long(), _t(ctx), deepcache="collect")
    ran = []
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: ran.append(name))
             for name, m in model.named_modules() if isinstance(m, tunet.ResnetBlock)
             or name in ("conv_in", "conv_out", "down_blocks.0.downsample")]
    try:
        with torch.inference_mode():
            model(_t(x), _t(t).long(), _t(ctx), deepcache=("shallow", cache))
    finally:
        for h in hooks:
            h.remove()
    assert ran == ["conv_in", "down_blocks.0.resnets.0", "down_blocks.0.resnets.1",
                   "up_blocks.3.resnets.0", "up_blocks.3.resnets.1", "up_blocks.3.resnets.2",
                   "conv_out"]


@pytest.mark.parametrize("interval", [2, 3])
def test_ddim_sample_with_deepcache_matches_jax(setup, interval):
    cfg_j, params, model, (x, _, ctx) = setup
    steps = 5
    cfg = tsamplers.DDIMConfig(num_inference_steps=steps, guidance_scale=4.0)
    cond, uncond = ctx[:1], ctx[1:]
    lat = x[:1]

    def full_j(xx, tt, cc):
        eps, _, cache = junet.unet_apply(params, xx, tt, cc, cfg_j, deepcache="collect")
        return eps, cache

    def shallow_j(xx, tt, cc, cache):
        return junet.unet_apply(params, xx, tt, cc, cfg_j, deepcache=("shallow", cache))[0]

    init = jnp.zeros((2, 16, 16, UNET_KW["block_channels"][1]), jnp.float32)
    schedule = JSchedule.create()
    ref = jax.jit(lambda lat, c, u: jsamplers.ddim_sample(
        lambda xx, tt, cc: junet.unet_apply(params, xx, tt, cc, cfg_j)[0], schedule,
        lat, c, u, jsamplers.DDIMConfig(num_inference_steps=steps, guidance_scale=4.0),
        deepcache=(interval, full_j, shallow_j, init)))(lat, cond, uncond)

    calls = []

    def full(xx, tt, cc):
        calls.append("full")
        return model(xx, tt, cc, deepcache="collect")

    def shallow(xx, tt, cc, cache):
        calls.append("shallow")
        return model(xx, tt, cc, deepcache=("shallow", cache))

    with torch.inference_mode():
        out = tsamplers.ddim_sample(model, DiffusionSchedule.create(), _t(lat), _t(cond),
                                    _t(uncond), cfg, deepcache=(interval, full, shallow, None))
    assert calls == ["full" if i % interval == 0 else "shallow" for i in range(steps)]
    assert_close_rel(out.numpy(), ref, DC_RTOL)


@pytest.fixture(scope="module")
def wrappers():
    return make_wrapper_pair(steps=3)


def latents(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(1, 4, HW // 4, HW // 4).astype(np.float32)


def run_both(jp, tp, lat, **kw):
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=4, guidance_scale=4.0,
              height=HW, width=HW, **kw)
    img_j = np.asarray(jp([PROMPT], latents=jnp.asarray(lat), **kw))
    img_t = tp([PROMPT], latents=torch.from_numpy(lat), **kw).numpy()
    return img_t, img_j


def test_pipeline_with_deepcache_matches_jax(wrappers):
    jw, tw = wrappers
    img_t, img_j = run_both(jw.pipeline, tw.pipeline, latents(41), deepcache_interval=2)
    assert img_t.shape == (1, 3, HW, HW) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)
    # interval 0 (off) after it: the full loop (held to JAX in
    # tests/test_torch_slice.py), another image
    full_t = tw.pipeline([PROMPT], latents=torch.from_numpy(latents(41)), negative_prompt=NEGATIVE,
                         num_inference_steps=4, guidance_scale=4.0, height=HW, width=HW).numpy()
    assert np.isfinite(full_t).all() and not np.array_equal(full_t, img_t)


def test_pipeline_with_deepcache_and_adapters_matches_jax(wrappers):
    """The adapters go to both the full and the shallow call."""
    jw, tw = wrappers
    rank = 4
    attn, ffn = lora_trees(junet.UNetConfig(**UNET_KW, lora_rank=rank), 43)
    cfg_t = tunet.UNetConfig(**UNET_KW, lora_rank=rank)
    t_attn = bridge.load_lora(tunet.AttnLoRA(cfg_t), attn).requires_grad_(False)
    t_ffn = bridge.load_lora(tunet.FFNLoRA(cfg_t), ffn).requires_grad_(False)
    jp = JPipeline(dataclasses.replace(jw.pipeline.m, attn_lora=attn, ffn_lora=ffn),
                   dtype=jnp.float32)
    jp._decode = jw.pipeline._decode  # the same VAE: its compiled decode, not a second compile
    tp = DiffusionPipeline(dataclasses.replace(tw.pipeline.m, attn_lora=t_attn,
                                               ffn_lora=t_ffn), dtype=torch.float32)
    img_t, img_j = run_both(jp, tp, latents(43), deepcache_interval=2)
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)
    plain_t, _ = run_both(jw.pipeline, tw.pipeline, latents(43), deepcache_interval=2)
    assert not np.array_equal(plain_t, img_t)


def test_deepcache_with_an_ensemble_raises(wrappers):
    _, tw = wrappers
    m = tw.pipeline.m
    tp = DiffusionPipeline(dataclasses.replace(m, unet=[m.unet, m.unet]), dtype=torch.float32)
    with pytest.raises(ValueError, match="ensemble"):
        tp([PROMPT], latents=torch.from_numpy(latents(1)), num_inference_steps=2,
           height=HW, width=HW, deepcache_interval=2)
    # the other schedulers ignore the interval, as the JAX pipeline does
    img = tp([PROMPT], latents=torch.from_numpy(latents(1)), num_inference_steps=2,
             height=HW, width=HW, deepcache_interval=2, scheduler="dpm++")
    assert np.isfinite(img.numpy()).all()
