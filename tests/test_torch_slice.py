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
in [0, 1].
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.inference.pipeline import PipelineModules as JModules
from adaface_tpu.inference.wrapper import AdaFaceWrapper as JWrapper
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.inference.pipeline import PipelineModules
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from tests.test_torch_models import (D, TEXT_KW, TINY_VISION, UNET_KW, VAE_KW,
                                     assert_close_rel, numpy_params)

IMAGE_ATOL = 1e-3
NEGATIVE = "lowres, low quality"
SLICE_MODULES = [
    "adaface_tpu_torch", "adaface_tpu_torch.core.bridge", "adaface_tpu_torch.core.params",
    "adaface_tpu_torch.ops._build", "adaface_tpu_torch.ops.attention",
    "adaface_tpu_torch.ops.fused_gn", "adaface_tpu_torch.ops.fused_ln",
    "adaface_tpu_torch.ops.fused_norm", "adaface_tpu_torch.ops.resize",
    "adaface_tpu_torch.ops.samplers",
    "adaface_tpu_torch.ops.schedules", "adaface_tpu_torch.models.clip",
    "adaface_tpu_torch.models.unet", "adaface_tpu_torch.models.vae",
    "adaface_tpu_torch.models.bisenet", "adaface_tpu_torch.train.face_parsing_train",
    "adaface_tpu_torch.text.tokenizer", "adaface_tpu_torch.text.embedding_manager",
    "adaface_tpu_torch.id2ada.face_backends",
    "adaface_tpu_torch.id2ada.subj_basis_generator",
    "adaface_tpu_torch.id2ada.face_id_to_ada_prompt",
    "adaface_tpu_torch.inference.pipeline", "adaface_tpu_torch.inference.wrapper",
    "chip_smoke",
]


@pytest.fixture(scope="module")
def wrappers():
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
    jw = JWrapper("text2img", jm, jenc, num_inference_steps=3, dtype=jnp.float32)

    text_t = tclip.CLIPTextConfig(**TEXT_KW)
    tok = CLIPTokenizer.character_fallback()
    tm = PipelineModules(
        unet=bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), jm.unet),
        vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                        bridge.vae_decoder_tree(jm.vae)),
        text_encoder=bridge.load(  # the table the JAX wrapper grew by 16 rows
            tclip.CLIPTextModel(tclip.CLIPTextConfig(
                **TEXT_KW, vocab_size=jm.text_encoder["token_embedding"].shape[0])),
            jm.text_encoder),
        tokenizer=tok)
    tenc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jenc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), tok),
                    bridge.sbg_tree(jenc.subj_basis_generator)),
        tok, face_backend=DeterministicBackend())
    tw = AdaFaceWrapper("text2img", tm, tenc, num_inference_steps=3, dtype=torch.float32)
    return jw, tw


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
    with pytest.raises(NotImplementedError):
        AdaFaceWrapper("img2img", tw.pipeline.m, tw.id2ada_prompt_encoder)


def test_port_imports_no_jax():
    code = ("import sys\n"
            f"for m in {SLICE_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'adaface_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
