"""The personalized text→image slice of the PyTorch port against the JAX
package, end to end, on the CPU.

One face-ID embedding and one latents tensor, both from numpy, go through
`AdaFaceWrapper.prepare_adaface_embeddings` → `update_prompt` → the CFG DDIM
pipeline (3 steps, 128x128 image from 32x32 latents, guidance 4) on both
sides, in fp32 at the tiny widths of `tests/test_torch_models.py`. Each side
has its own tokenizer (`default_tokenizer()` is a process-wide instance that
`add_tokens` changes). The text encoder is bridged after the JAX wrapper has
grown its token table and before either side writes ada embeddings into it,
so the port's placeholder rows hold only what the port computed.

Tolerances: ada embeddings and final latents 1e-4 relative to the largest
magnitude (module parity compounded over 3 steps); images 1e-3 abs, pixels
in [0, 1]. The other schedulers and img2img go through both wrappers the
same way, with the draws JAX makes from its keys handed to the port.
"""

import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada import layers as jL
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.id2ada.face_id_to_ada_prompt import ConsistentIDID2AdaPrompt as JConsistentID
from adaface_tpu.id2ada.face_id_to_ada_prompt import JointFaceID2AdaPrompt as JJoint
from adaface_tpu.inference.pipeline import PipelineModules as JModules
from adaface_tpu.inference.wrapper import AdaFaceWrapper as JWrapper
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import (Arc2FaceID2AdaPrompt,
                                                            ConsistentIDID2AdaPrompt,
                                                            JointFaceID2AdaPrompt)
from adaface_tpu_torch.id2ada.layers import ProjPlus
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.inference.pipeline import PipelineModules
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from tests.test_torch_id2ada import CID_VISION
from tests.test_torch_models import (D, TEXT_KW, TINY_VISION, UNET_KW, VAE_KW,
                                     assert_close_rel, numpy_params)
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

IMAGE_ATOL = 1e-3
NEGATIVE = "lowres, low quality"
SLICE_MODULES = [
    "adaface_tpu_torch", "adaface_tpu_torch.core.bridge", "adaface_tpu_torch.core.params",
    "adaface_tpu_torch.core.device",
    "adaface_tpu_torch.ops._build", "adaface_tpu_torch.ops.attention",
    "adaface_tpu_torch.ops.fused_gn", "adaface_tpu_torch.ops.fused_ln",
    "adaface_tpu_torch.ops.fused_norm", "adaface_tpu_torch.ops.resize",
    "adaface_tpu_torch.ops.samplers", "adaface_tpu_torch.ops.tome", "adaface_tpu_torch.ops.quant",
    "adaface_tpu_torch.ops.schedules", "adaface_tpu_torch.models.clip",
    "adaface_tpu_torch.models.unet", "adaface_tpu_torch.models.vae",
    "adaface_tpu_torch.models.bisenet", "adaface_tpu_torch.train.face_parsing_train",
    "adaface_tpu_torch.text.tokenizer", "adaface_tpu_torch.text.embedding_manager",
    "adaface_tpu_torch.id2ada.face_backends", "adaface_tpu_torch.id2ada.layers",
    "adaface_tpu_torch.id2ada.subj_basis_generator",
    "adaface_tpu_torch.id2ada.face_id_to_ada_prompt",
    "adaface_tpu_torch.models.arcface", "adaface_tpu_torch.models.retinaface",
    "adaface_tpu_torch.utils.image", "adaface_tpu_torch.utils.tensor",
    "adaface_tpu_torch.inference.pipeline", "adaface_tpu_torch.inference.wrapper",
    "adaface_tpu_torch.inference.serving", "adaface_tpu_torch.inference.video_pipeline",
    "adaface_tpu_torch.models.motion", "adaface_tpu_torch.tools.convert_motion",
    "adaface_tpu_torch.utils.sample_logger", "adaface_tpu_torch.train.checkpoint",
    "adaface_tpu_torch.train.recon_multistep", "scripts.ckpt_tool_torch",
    "scripts.flow_tool_torch",
    "adaface_tpu_torch.tools.ckpt_lib", "adaface_tpu_torch.tools.convert_sd",
    "adaface_tpu_torch.tools.convert_ldm_unet", "adaface_tpu_torch.tools.convert_clip",
    "adaface_tpu_torch.tools.convert_consistentid",
    "chip_smoke", "chip_compare", "bench_torch", "train_torch", "scripts.bench_serving_torch",
    "scripts._common_torch",
]


def make_wrapper_pair(pipeline_name: str = "text2img", steps: int = 3,
                      encoder: str = "arc2face", jax_kw: dict | None = None,
                      port_kw: dict | None = None):
    """→ (the JAX wrapper, the port's) on the same tiny fp32 weights, each
    with a tokenizer of its own; `encoder` "arc2face" or "jointIDs"
    (Arc2Face + ConsistentID); `jax_kw` / `port_kw`: more arguments of each
    wrapper (text2video's `motion` and `motion_cfg`)."""
    text_j, unet_j, vae_j = (jclip.CLIPTextConfig(**TEXT_KW), junet.UNetConfig(**UNET_KW),
                             jvae.VAEConfig(**VAE_KW))
    unet_p = numpy_params(lambda k: junet.init_unet_params(k, unet_j), 10)
    # a quieter head than fan-in keeps the 3-step latents, and so the
    # decoded pixels, off the [0, 1] clip
    unet_p["conv_out"]["w"] = unet_p["conv_out"]["w"] * 0.1
    jm = JModules(unet=unet_p,
                  vae=numpy_params(lambda k: jvae.init_vae_params(k, vae_j), 11),
                  text_encoder=numpy_params(lambda k: jclip.init_text_params(k, text_j), 12),
                  tokenizer=JTokenizer.character_fallback(),
                  unet_cfg=unet_j, vae_cfg=vae_j, text_cfg=text_j)
    jenc = JArc2Face(
        jax.random.PRNGKey(4), tokenizer=jm.tokenizer, face_backend=JBackend(),
        clip_vision_cfg=TINY_VISION, sbg_clip_cfg=text_j, text_cfg=text_j, output_dim=D,
        text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_j), 13),
        clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, TINY_VISION), 14))
    if encoder == "jointIDs":
        vis_j = jclip.CLIPVisionConfig(**CID_VISION)
        jcid = JConsistentID(
            jax.random.PRNGKey(5), tokenizer=jm.tokenizer, face_backend=JBackend(),
            clip_vision_cfg=vis_j, sbg_clip_cfg=text_j, output_dim=D,
            clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, vis_j), 15),
            image_proj_params=numpy_params(lambda k: jL.init_proj_plus(k, 512, D, D, 4), 16))
        jenc = JJoint(jax.random.PRNGKey(0), encoders=[jenc, jcid])
    jw = JWrapper(pipeline_name, jm, jenc, num_inference_steps=steps, dtype=jnp.float32,
                  **(jax_kw or {}))

    text_t = tclip.CLIPTextConfig(**TEXT_KW)
    tok = CLIPTokenizer.character_fallback()
    tm = PipelineModules(
        unet=bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), jm.unet),
        vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                        bridge.vae_decoder_tree(jm.vae)),
        vae_encoder=bridge.load(tvae.VAEEncoder(tvae.VAEConfig(**VAE_KW)),
                                bridge.vae_encoder_tree(jm.vae)),
        text_encoder=bridge.load(  # the table the JAX wrapper grew by 16 rows
            tclip.CLIPTextModel(tclip.CLIPTextConfig(
                **TEXT_KW, vocab_size=jm.text_encoder["token_embedding"].shape[0])),
            jm.text_encoder),
        tokenizer=tok)
    jarc = jenc.encoders[0] if encoder == "jointIDs" else jenc
    tenc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jarc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), tok),
                    bridge.sbg_tree(jarc.subj_basis_generator)),
        tok, face_backend=DeterministicBackend())
    if encoder == "jointIDs":
        tcid = ConsistentIDID2AdaPrompt(
            bridge.load(tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**CID_VISION)),
                        jcid.clip_vision_params),
            bridge.load(ProjPlus(512, D, D, 4), jcid.image_proj_params),
            bridge.load(SubjBasisGenerator(SubjBasisConfig(num_id_vecs=4, clip=text_t), tok),
                        bridge.sbg_tree(jcid.subj_basis_generator)),
            face_backend=DeterministicBackend())
        tenc = JointFaceID2AdaPrompt([tenc, tcid])
    tw = AdaFaceWrapper(pipeline_name, tm, tenc, num_inference_steps=steps,
                        dtype=torch.float32, **(port_kw or {}))
    return jw, tw


def jit_unet(jw):
    """Run the JAX pipeline's UNet calls outside its jitted DDIM loop (the
    other schedulers' Python loops) as one XLA program each: op by op a call
    takes a minute on the CPU."""
    return mock.patch.object(jw.pipeline, "_unet_eps", jax.jit(jw.pipeline._unet_eps))


@pytest.fixture(scope="module")
def wrappers():
    return make_wrapper_pair()


def test_slice_matches_jax(wrappers):
    jw, tw = wrappers
    assert tw.placeholder_token_ids == jw.placeholder_token_ids
    rs = np.random.RandomState(20)
    fid = rs.randn(1, 512).astype(np.float32)
    lat = rs.randn(1, 4, 32, 32).astype(np.float32)

    ada_j = jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    ada_t = tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    assert ada_t.shape == (16, D)
    assert_close_rel(ada_t.numpy(), ada_j)

    prompt = jw.update_prompt("portrait at the beach")
    assert tw.update_prompt("portrait at the beach") == prompt
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=3, guidance_scale=4.0,
              height=128, width=128)
    z_j = jw.pipeline([prompt], latents=jnp.asarray(lat), return_latents=True, **kw)
    img_j = np.asarray(jw.pipeline([prompt], latents=jnp.asarray(lat), **kw))
    z_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), return_latents=True, **kw)
    img_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), **kw).numpy()
    assert_close_rel(z_t.numpy(), z_j)
    assert img_t.shape == (1, 3, 128, 128) and np.isfinite(img_t).all()
    assert 0.05 < ((img_j > 0.0) & (img_j < 1.0)).mean()  # not all clipped
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)


def test_wrapper_forward_from_images(wrappers):
    """The user entry point: face images → ada rows → prompt → images."""
    _, tw = wrappers
    imgs = [np.random.RandomState(i).randint(0, 255, (64, 64, 3), np.uint8)
            for i in range(2)]
    ada = tw.prepare_adaface_embeddings(images=imgs)
    row = tw.pipeline.m.text_encoder.token_embedding[tw.placeholder_token_ids[0][0]]
    np.testing.assert_array_equal(row.numpy(), ada[0].numpy())
    out = tw("a portrait", num_images=2, num_inference_steps=2, height=64, width=64,
             generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, 64, 64) and torch.isfinite(out).all()
    assert 0.0 <= out.min() and out.max() <= 1.0
    # text2video is served (random motion modules from seed 0 when none are
    # given); flux stays refused by name
    video = AdaFaceWrapper("text2video", tw.pipeline.m, tw.id2ada_prompt_encoder)
    assert type(video.pipeline).__name__ == "VideoPipeline"
    with pytest.raises(NotImplementedError, match="flux"):
        AdaFaceWrapper("flux", tw.pipeline.m, tw.id2ada_prompt_encoder)


@pytest.mark.parametrize("scheduler,steps", [("dpm++", 4), ("pndm", 5), ("lcm", 3)])
def test_scheduler_argument_matches_jax(wrappers, scheduler, steps):
    """`scheduler=` through both pipelines; LCM's re-noising draws are the
    JAX loop's (its key split per step), handed to the port. Final latents
    to 1e-4 of their largest magnitude, images to 1e-3."""
    jw, tw = wrappers
    rs = np.random.RandomState(21)
    fid = rs.randn(1, 512).astype(np.float32)  # the same subject in both token tables
    jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    prompt = jw.update_prompt("portrait in a garden")
    lat = rs.randn(1, 4, 16, 16).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=steps, guidance_scale=3.0,
              height=64, width=64, scheduler=scheduler)
    with jit_unet(jw):
        z_j = jw.pipeline([prompt], latents=jnp.asarray(lat), rng=rng, return_latents=True,
                          **kw)
        img_j = np.asarray(jw.pipeline([prompt], latents=jnp.asarray(lat), rng=rng, **kw))
    noise = None
    if scheduler == "lcm":
        key, draws = jax.random.split(rng)[1], []  # the pipeline's k_samp
        for _ in range(steps - 1):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, lat.shape, jnp.float32)))
        noise = torch.from_numpy(np.stack(draws))
    z_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), noise=noise,
                      return_latents=True, **kw)
    img_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), noise=noise, **kw).numpy()
    assert_close_rel(z_t.numpy(), z_j)
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)


def test_unknown_scheduler_raises(wrappers):
    _, tw = wrappers
    with pytest.raises(ValueError, match="unknown scheduler"):
        tw("a portrait", num_inference_steps=2, height=64, width=64, scheduler="euler")


def test_img2img_matches_jax():
    """img2img through both wrappers: a uint8 image from numpy, strength 0.8
    of 5 steps (4 run), the posterior's sample and the diffusion noise drawn
    by JAX from the two halves of its key and handed to the port. Initial
    latents to 1e-4 of their largest magnitude, images to 1e-3."""
    jw, tw = make_wrapper_pair("img2img", steps=5)
    rs = np.random.RandomState(22)
    fid = rs.randn(1, 512).astype(np.float32)
    init = rs.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    rng = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(rng)
    draws = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (2 // n, 4, 16, 16),
                                                                jnp.float32)))
                  for k, n in ((k1, 2), (k2, 1)))
    lat_j = jw._img2img_latents(init, 0.8, 5, rng, 2)
    lat_t = tw._img2img_latents(init, 0.8, None, 2, draws)
    assert lat_t.shape == (2, 4, 16, 16)
    assert_close_rel(lat_t.numpy(), lat_j)
    kw = dict(negative_prompt=NEGATIVE, num_images=2, guidance_scale=3.0, init_image=init,
              strength=0.8, height=64, width=64)
    img_j = np.asarray(jw("portrait at dusk", rng=rng, **kw))
    img_t = tw("portrait at dusk", img2img_noise=draws, **kw).numpy()
    assert img_t.shape == (2, 3, 64, 64)
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)
    with pytest.raises(ValueError, match="init_image"):
        tw("portrait at dusk")
    # with a generator the port makes its own two draws
    own = tw("portrait at dusk", generator=torch.Generator().manual_seed(0), **kw)
    assert own.shape == (2, 3, 64, 64) and torch.isfinite(own).all()


def test_mix_ada_embs_and_update_prompt_flag(wrappers):
    jw, tw = wrappers
    rs = np.random.RandomState(23)
    a, b = rs.randn(16, D).astype(np.float32), rs.randn(16, D).astype(np.float32)
    np.testing.assert_allclose(
        tw.mix_ada_embs_with_other_embs(torch.from_numpy(a), torch.from_numpy(b), 0.3).numpy(),
        np.asarray(jw.mix_ada_embs_with_other_embs(jnp.asarray(a), jnp.asarray(b), 0.3)),
        atol=1e-7)
    # update_prompt=False leaves the prompt as the caller wrote it
    kw = dict(num_inference_steps=2, height=64, width=64, negative_prompt=NEGATIVE)
    gen = lambda: torch.Generator().manual_seed(5)
    as_written = tw("a portrait", update_prompt=False, generator=gen(), **kw)
    direct = tw.pipeline(["a portrait"], guidance_scale=tw.guidance_scale, generator=gen(),
                         **kw)
    extended = tw("a portrait", generator=gen(), **kw)
    assert torch.equal(as_written, direct) and not torch.equal(as_written, extended)


def test_joint_slice_matches_jax():
    """The joint encoder (Arc2Face + ConsistentID) through both wrappers:
    20 ada rows into `z_0_*` and `z_1_*`, the prompt's latents to 1e-4 of
    their scale and its images to 1e-4; then one 20-token request through
    the port's batcher against the JAX batcher (JAX's latents handed over)
    and against the port's one-shot image, 1e-4 each."""
    jw, tw = make_wrapper_pair(encoder="jointIDs")
    assert [len(ids) for ids in tw.placeholder_token_ids] == [16, 4]
    assert tw.placeholder_token_ids == jw.placeholder_token_ids
    rs = np.random.RandomState(24)
    imgs = [rs.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(2)]
    ada_j = jw.prepare_adaface_embeddings(images=imgs)
    ada_t = tw.prepare_adaface_embeddings(images=imgs)
    assert ada_t.shape == (20, D)
    assert_close_rel(ada_t.numpy(), ada_j)
    table = tw.pipeline.m.text_encoder.token_embedding
    ids = [i for run in tw.placeholder_token_ids for i in run]
    np.testing.assert_array_equal(table[ids].numpy(), ada_t.numpy())
    prompt = jw.update_prompt("portrait at the beach")
    assert tw.update_prompt("portrait at the beach") == prompt and "z_1_3" in prompt
    lat = rs.randn(1, 4, 16, 16).astype(np.float32)
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=3, guidance_scale=4.0,
              height=64, width=64)
    z_j = jw.pipeline([prompt], latents=jnp.asarray(lat), return_latents=True, **kw)
    z_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), return_latents=True, **kw)
    assert_close_rel(z_t.numpy(), z_j)
    img_j = np.asarray(jw.pipeline([prompt], latents=jnp.asarray(lat), **kw))
    img_t = tw.pipeline([prompt], latents=torch.from_numpy(lat), **kw)
    np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)

    lat_j = np.array(jax.random.normal(jax.random.PRNGKey(8), (4, 16, 16), jnp.float32))
    req = dict(prompt="a portrait in a garden", negative_prompt=NEGATIVE, guidance_scale=4.0)
    out_j = jw.make_batcher(num_slots=2, height=64, width=64).generate_all(
        [jw.make_request(ada_embs=ada_j, seed=8, **req)])
    out_t = tw.make_batcher(num_slots=2, height=64, width=64).generate_all(
        [tw.make_request(ada_embs=ada_t, latents=torch.from_numpy(lat_j), **req)])
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), atol=1e-4)
    one_shot = tw.pipeline([tw.update_prompt(req["prompt"])], latents=torch.from_numpy(lat_j)[None],
                           **{**kw, "num_inference_steps": 3})[0]
    np.testing.assert_allclose(out_t[0].numpy(), one_shot.numpy(), atol=1e-4)


def test_port_imports_no_jax():
    """No module of the port, nor the scripts, imports JAX, the JAX package,
    OpenCV or PIL: the port runs where none of them is installed."""
    code = ("import sys\n"
            f"for m in {SLICE_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'adaface_tpu', 'cv2', 'PIL'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
