"""The port's text→video path against the JAX package, on the CPU.

A JAX and a port wrapper on one set of tiny fp32 weights
(`tests/test_torch_slice.py:make_wrapper_pair`) with one motion tree drawn
from numpy (every `proj_out` non-zero, so the frames interact), each
`VideoPipeline` fed JAX's latents: 3 frames of 64x64 (16x16 latents) in 2
CFG DDIM steps, decoded 2 frames at a time. Tolerances as the image slice's:
latents 1e-4 of the largest magnitude, frames 1e-3 absolute. The GIF is read
back by PIL; the refusals name what they refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.video_pipeline import VideoPipeline as JVideoPipeline
from adaface_tpu.models import motion as jmotion
from adaface_tpu.models import unet as junet
from adaface_tpu_torch.inference.video_pipeline import VideoPipeline
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.models import motion as tmotion
from tests.test_torch_models import UNET_KW, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_slice import IMAGE_ATOL, NEGATIVE, make_wrapper_pair

FRAMES, STEPS, HW, LATENT_HW, GUIDANCE = 3, 2, 64, 16, 4.0
MOTION_KW = dict(num_heads=2, norm_groups=8)


@pytest.fixture(scope="module")
def video_pair():
    tree = numpy_params(lambda k: jmotion.init_motion_params(
        k, junet.UNetConfig(**UNET_KW), jmotion.MotionConfig(**MOTION_KW)), 40)
    # a quieter temporal residual keeps the frames off the [0, 1] clip
    for m in jax.tree_util.tree_leaves(tree, is_leaf=lambda n: isinstance(n, dict)
                                       and "proj_out" in n and "blocks" in n):
        m["proj_out"]["w"] = m["proj_out"]["w"] * 0.3
    return make_wrapper_pair(
        "text2video", steps=STEPS,
        jax_kw=dict(motion=tree, motion_cfg=jmotion.MotionConfig(**MOTION_KW)),
        port_kw=dict(motion=tree, motion_cfg=tmotion.MotionConfig(**MOTION_KW)))


def jax_latents(key, v: int = 1):
    """The latents JAX's `VideoPipeline` draws from `key`."""
    k_lat, _ = jax.random.split(key)
    return np.array(jax.random.normal(k_lat, (v * FRAMES, 4, LATENT_HW, LATENT_HW),
                                      jnp.float32))


def test_video_pipeline_matches_jax(video_pair):
    jw, tw = video_pair
    assert isinstance(tw.pipeline, VideoPipeline) and isinstance(jw.pipeline, JVideoPipeline)
    rs = np.random.RandomState(41)
    fid = rs.randn(1, 512).astype(np.float32)
    jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    prompts = [jw.update_prompt("a person waving"), jw.update_prompt("a person running")]
    lat = rs.randn(2 * FRAMES, 4, LATENT_HW, LATENT_HW).astype(np.float32)
    kw = dict(negative_prompt=NEGATIVE, num_frames=FRAMES, num_inference_steps=STEPS,
              guidance_scale=GUIDANCE, height=HW, width=HW)
    z_j = jw.pipeline(prompts, latents=jnp.asarray(lat), return_latents=True, **kw)
    z_t = tw.pipeline(prompts, latents=torch.from_numpy(lat), return_latents=True, **kw)
    assert z_t.shape == (2, FRAMES, 4, LATENT_HW, LATENT_HW)
    assert_close_rel(z_t.numpy(), z_j)
    v_j = np.asarray(jw.pipeline(prompts, latents=jnp.asarray(lat), decode_chunk=2, **kw))
    v_t = tw.pipeline(prompts, latents=torch.from_numpy(lat), decode_chunk=2, **kw).numpy()
    assert v_t.shape == (2, FRAMES, 3, HW, HW) and np.isfinite(v_t).all()
    assert 0.05 < ((v_j > 0.0) & (v_j < 1.0)).mean()  # not all clipped
    np.testing.assert_allclose(v_t, v_j, atol=IMAGE_ATOL)
    assert np.abs(v_t[0, 1] - v_t[0, 0]).mean() > 1e-4  # frames differ
    # a chunk of 2 frames decodes as the whole clip at once does
    whole = tw.pipeline(prompts, latents=torch.from_numpy(lat), decode_chunk=8, **kw).numpy()
    np.testing.assert_array_equal(whole, v_t)


def test_wrapper_text2video_matches_jax(video_pair):
    """`forward(..., num_frames=3)` of two clips through both wrappers (the
    shapes of the test above: JAX compiles no new loop): JAX's latents from
    its key handed to the port's `forward(latents=)`."""
    jw, tw = video_pair
    rs = np.random.RandomState(42)
    fid = rs.randn(1, 512).astype(np.float32)
    jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    key = jax.random.PRNGKey(7)
    kw = dict(negative_prompt=NEGATIVE, num_frames=FRAMES, guidance_scale=GUIDANCE,
              height=HW, width=HW)
    v_j = np.asarray(jw("a portrait", num_images=2, rng=key, **kw))
    v_t = tw("a portrait", num_images=2, latents=torch.from_numpy(jax_latents(key, 2)),
             **kw).numpy()
    assert v_t.shape == (2, FRAMES, 3, HW, HW)
    np.testing.assert_allclose(v_t, v_j, atol=IMAGE_ATOL)


def test_to_gif_reads_back(tmp_path):
    """PIL reads the port's GIF: as many frames, each pixel within half a
    step of the palette's levels (255/5 for red and blue, 255/6 for green),
    the delay int(1000 / fps) ms to the GIF's 10 ms, looping."""
    from PIL import Image, ImageSequence

    rs = np.random.RandomState(43)
    video = rs.rand(5, 3, 24, 40).astype(np.float32)
    path = VideoPipeline.to_gif(None, torch.from_numpy(video), str(tmp_path / "clip.gif"), fps=8)
    im = Image.open(path)
    frames = [np.asarray(f.convert("RGB"), np.float32) for f in ImageSequence.Iterator(im)]
    assert len(frames) == 5 and im.info["loop"] == 0 and im.info["duration"] == 120
    want = (video * 255).astype(np.uint8).transpose(0, 2, 3, 1).astype(np.float32)
    err = np.abs(np.stack(frames) - want).max(axis=(0, 1, 2))
    assert (err <= np.array([255 / 10, 255 / 12, 255 / 10]) + 0.5).all(), err


def test_text2video_refuses_what_it_does_not_serve(video_pair, tmp_path):
    """What JAX's VideoPipeline does not take is refused by name, never
    ignored."""
    _, tw = video_pair
    m, enc = tw.pipeline.m, tw.id2ada_prompt_encoder
    with pytest.raises(NotImplementedError, match="quantize_unet"):
        AdaFaceWrapper("text2video", m, enc, quantize_unet=True)
    with pytest.raises(NotImplementedError, match="scheduler='dpm\\+\\+'"):
        tw("a portrait", num_frames=FRAMES, height=HW, width=HW, scheduler="dpm++")
    with pytest.raises(NotImplementedError, match="batcher"):
        tw.make_batcher(num_slots=2)
    with pytest.raises(NotImplementedError, match="load_unet_lora_weights"):
        tw.load_unet_lora_weights(str(tmp_path))
    import dataclasses

    with pytest.raises(NotImplementedError, match="ensemble"):
        VideoPipeline(dataclasses.replace(m, unet=[m.unet, m.unet]), tw.pipeline.motion)
    from adaface_tpu_torch.models.unet import AttnLoRA

    with pytest.raises(NotImplementedError, match="adapters"):
        VideoPipeline(dataclasses.replace(m, attn_lora=AttnLoRA(m.unet.cfg)), tw.pipeline.motion)
    with pytest.raises(NotImplementedError, match="flux"):
        AdaFaceWrapper("flux", m, enc)


def test_video_pipeline_keeps_the_modules_config(video_pair):
    """Handed modules run with the config they were built with; a
    `motion_cfg` that differs from it is refused, not half applied."""
    _, tw = video_pair
    m, motion = tw.pipeline.m, tw.pipeline.motion
    assert VideoPipeline(m, motion, dtype=torch.float32).motion.cfg == motion.cfg
    assert VideoPipeline(m, motion, motion_cfg=tmotion.MotionConfig(**MOTION_KW),
                         dtype=torch.float32).motion.cfg.num_heads == 2
    with pytest.raises(ValueError, match="differs"):
        VideoPipeline(m, motion, motion_cfg=tmotion.MM_SD15_V2, dtype=torch.float32)
