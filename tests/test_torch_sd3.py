"""The port's SD3 branch against the JAX package, on the CPU in fp32.

The MMDiT (patchify, the computed and a checkpoint's cropped position table,
the Fourier and pooled conditioning, joint attention with and without the RMS
qk-norm, adaLN-zero blocks with the last one pre-only, the final norm and
unpatchify) against `mmdit_apply`; the MMDiT converter both ways against
JAX's `convert_mmdit` / `export_mmdit_to_diffusers` on a synthetic diffusers
state dict; the SD3 pipeline (T5 segment of 8, 2 rectified-flow steps with
CFG, JAX's latents handed over, a handed T5 segment too) and
`AdaFaceWrapper("text2img3")` / ("sd3") against JAX's wrapper.

Tiny configurations follow `tests/test_sd3.py` (the CLIP-L tower 64 wide, as
the tiny Arc2Face encoder writes 64-wide rows). The JAX initialiser leaves
the modulations and the head at 0 (a zero velocity); the trees here come
from numpy seeds with every leaf drawn. Tolerances: relative L2 <= 1e-5 for
modules and latents, <= 1e-4 for pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.sd3_pipeline import SD3Pipeline as JSD3Pipeline
from adaface_tpu.inference.sd3_pipeline import SD3PipelineModules as JSD3Modules
from adaface_tpu.inference.wrapper import AdaFaceWrapper as JWrapper
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import mmdit as jmmdit
from adaface_tpu.models import vae as jvae
from adaface_tpu.text import tokenizer as jtok
from adaface_tpu.tools import convert_mmdit as jconv
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.inference.sd3_pipeline import SD3Pipeline, SD3PipelineModules
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import mmdit as tmmdit
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text import tokenizer as ttok
from adaface_tpu_torch.tools import convert_mmdit as tconv
from tests.test_torch_models import numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sdxl import MODULE_REL_L2, NEGATIVE, PIXEL_REL_L2, encoder_pair, rel_l2

D1, D2 = 64, 40
TEXT1_KW = dict(hidden_size=D1, num_layers=3, num_heads=2, intermediate_size=128,
                projection_dim=24)
TEXT2_KW = dict(hidden_size=D2, num_layers=3, num_heads=2, intermediate_size=64,
                hidden_act="gelu", projection_dim=24)
MMDIT_KW = dict(depth=3, hidden=64, num_heads=4, context_dim=128, pooled_dim=48,
                pos_embed_max_size=16, time_embed_dim=32, in_channels=16, out_channels=16)
VAE16_KW = dict(base_ch=16, ch_mult=(1, 2, 2), num_res_blocks=1, norm_groups=8, z_channels=16)
T5_LEN = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def mmdit_tree(cfg_j, seed: int, table: bool = False, head_scale: float = 1.0):
    """The JAX MMDiT tree from a numpy seed, every leaf drawn (the JAX
    initialiser's zeros would make the function trivial), with a
    checkpoint-style position table of pos_embed_max_size² rows if asked."""
    tree = numpy_params(lambda k: jmmdit.init_mmdit_params(k, cfg_j), seed)
    tree["proj_out"]["w"] = tree["proj_out"]["w"] * head_scale
    if table:
        m = cfg_j.pos_embed_max_size
        rs = np.random.RandomState(seed + 1)
        tree["pos_embed_table"] = jnp.asarray(rs.randn(m * m, cfg_j.hidden).astype(np.float32))
    return tree


def _inputs(cfg, b=2, hw=8, s=12, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, cfg.in_channels, hw, hw).astype(np.float32),
            np.array([980.0, 312.5][:b], np.float32),
            rs.randn(b, s, cfg.context_dim).astype(np.float32),
            rs.randn(b, cfg.pooled_dim).astype(np.float32))


@pytest.mark.parametrize("table,qk_norm,hw", [(False, False, 8), (True, True, 8),
                                              (True, False, 12)])
def test_mmdit_matches_jax(table, qk_norm, hw):
    """The computed sin/cos table and a checkpoint's table cropped to the
    grid (an 8x8 latent's 4x4 grid, a 12x12 latent's 6x6), qk-norm on and
    off; the last block pre-only."""
    cfg_j = jmmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    cfg_t = tmmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    tree = mmdit_tree(cfg_j, 20, table)
    model = bridge.load(tmmdit.MMDiT(cfg_t, pos_embed_rows=16 * 16 if table else None), tree)
    assert model.blocks[-1].pre_only and not hasattr(model.blocks[-1], "mlp_ctx")
    x, t, ctx, pooled = _inputs(cfg_t, hw=hw)
    ref = jax.jit(lambda p, *a: jmmdit.mmdit_apply(p, *a, cfg_j))(tree, x, t, ctx, pooled)
    with torch.inference_mode():
        out = model(_t(x), _t(t), _t(ctx), _t(pooled))
    assert out.shape == x.shape
    assert rel_l2(out.numpy(), ref) <= MODULE_REL_L2


def test_sincos_table_matches_jax():
    np.testing.assert_array_equal(tmmdit.sincos_pos_embed_2d(64, 16),
                                  jmmdit.sincos_pos_embed_2d(64, 16))


@pytest.mark.parametrize("table,qk_norm", [(False, False), (True, True)])
def test_mmdit_converter_round_trip_matches_jax(table, qk_norm):
    """A synthetic diffusers state dict (JAX's export of a drawn tree)
    through the port's `convert_mmdit`, leaf for leaf equal to JAX's; the
    port's export back to the same state dict; `load_mmdit`'s module
    written back to the tree by `bridge.tree_state_dict`."""
    cfg_j = jmmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    cfg_t = tmmdit.MMDiTConfig(**MMDIT_KW, qk_norm=qk_norm)
    tree = jax.tree_util.tree_map(np.asarray, mmdit_tree(cfg_j, 30, table))
    sd = jconv.export_mmdit_to_diffusers(tree, cfg_j)
    if table:  # diffusers keeps the table as [1, rows, hidden]
        sd["pos_embed.pos_embed"] = sd["pos_embed.pos_embed"][None]
    assert ("transformer_blocks.2.attn.to_add_out.weight" in sd) is False  # pre-only
    out = tconv.convert_mmdit(sd, cfg_t)
    ref = jconv.convert_mmdit(sd, cfg_j)
    flat_o = dict(jax.tree_util.tree_leaves_with_path(out))
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert set(flat_o) == set(flat_r)
    for path, leaf in flat_r.items():
        np.testing.assert_array_equal(np.asarray(flat_o[path]), np.asarray(leaf))
        assert np.asarray(flat_o[path]).dtype == np.asarray(leaf).dtype
    back = tconv.export_mmdit_to_diffusers(out, cfg_t)
    want = jconv.export_mmdit_to_diffusers(ref, cfg_j)
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], np.asarray(want[key]))
    model = tconv.load_mmdit(out, cfg_t, "cpu", torch.float32)
    flat = bridge.tree_state_dict(model)
    leaves = jax.tree_util.tree_leaves_with_path(out)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        np.testing.assert_array_equal(flat[key], np.asarray(leaf))


# ---------------------------------------------------------------------------
# the pipeline and the wrapper
# ---------------------------------------------------------------------------


def jax_modules():
    cfg1, cfg2 = jclip.CLIPTextConfig(**TEXT1_KW), jclip.CLIPTextConfig(**TEXT2_KW)
    mcfg, vcfg = jmmdit.MMDiTConfig(**MMDIT_KW), jvae.VAEConfig(**VAE16_KW)
    return JSD3Modules(
        mmdit=mmdit_tree(mcfg, 40, head_scale=0.1),
        vae=numpy_params(lambda k: jvae.init_vae_params(k, vcfg), 41),
        text_encoder=numpy_params(lambda k: jclip.init_text_params(k, cfg1), 42),
        text_encoder_2=numpy_params(lambda k: jclip.init_text_params(k, cfg2), 43),
        tokenizer=jtok.CLIPTokenizer.character_fallback(), mmdit_cfg=mcfg, vae_cfg=vcfg,
        text_cfg=cfg1, text2_cfg=cfg2, t5_len=T5_LEN)


def port_modules(jm) -> SD3PipelineModules:
    vocab = jm.text_encoder["token_embedding"].shape[0]
    return SD3PipelineModules(
        mmdit=bridge.load(tmmdit.MMDiT(tmmdit.MMDiTConfig(**MMDIT_KW)), jm.mmdit),
        vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE16_KW)),
                        bridge.vae_decoder_tree(jm.vae)),
        text_encoder=bridge.load(tclip.CLIPTextModel(
            tclip.CLIPTextConfig(**TEXT1_KW, vocab_size=vocab)), jm.text_encoder),
        text_encoder_2=bridge.load(tclip.CLIPTextModel(tclip.CLIPTextConfig(**TEXT2_KW)),
                                   jm.text_encoder_2),
        tokenizer=ttok.CLIPTokenizer.character_fallback(), t5_len=T5_LEN)


@pytest.mark.parametrize("t5", [False, True])
def test_sd3_pipeline_matches_jax(t5):
    """2 rectified-flow steps with CFG at 64x64 (16x16 latents), JAX's
    latents handed over: the joint context (CLIP states zero-padded to the
    context width, then the T5 segment: zeros, or handed embeddings), the
    2 x 24 pooled vector, the final latents and the pixels."""
    jm = jax_modules()
    jp, tp = JSD3Pipeline(jm, dtype=jnp.float32), SD3Pipeline(port_modules(jm),
                                                              dtype=torch.float32)
    prompt = "a cat wearing a hat"
    rs = np.random.RandomState(44)
    t5_embs = rs.randn(1, T5_LEN, 128).astype(np.float32) if t5 else None
    neg_t5 = rs.randn(1, T5_LEN, 128).astype(np.float32) if t5 else None
    ctx_j, pooled_j = jp.encode_prompt([prompt], [prompt],
                                       None if t5_embs is None else jnp.asarray(t5_embs))
    with torch.inference_mode():
        ctx_t, pooled_t = tp.encode_prompt([prompt], [prompt],
                                           None if t5_embs is None else _t(t5_embs))
    assert ctx_t.shape == (1, 77 + T5_LEN, 128) and pooled_t.shape == (1, 48)
    assert not ctx_t[:, :77, D1 + D2:].any()
    assert t5 or not ctx_t[:, 77:].any()
    assert rel_l2(ctx_t.numpy(), ctx_j) <= MODULE_REL_L2
    assert rel_l2(pooled_t.numpy(), pooled_j) <= MODULE_REL_L2
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 16, 16, 16), jnp.float32))
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=2, guidance_scale=5.0, height=64,
              width=64)
    jt5 = {} if not t5 else dict(t5_embs=jnp.asarray(t5_embs), neg_t5_embs=jnp.asarray(neg_t5))
    tt5 = {} if not t5 else dict(t5_embs=_t(t5_embs), neg_t5_embs=_t(neg_t5))
    z_j = jp(prompt, latents=jnp.asarray(lat), return_latents=True, **jt5, **kw)
    img_j = np.asarray(jp(prompt, latents=jnp.asarray(lat), **jt5, **kw))
    z_t = tp(prompt, latents=_t(lat), return_latents=True, **tt5, **kw)
    img_t = tp(prompt, latents=_t(lat), **tt5, **kw).numpy()
    assert rel_l2(z_t.numpy(), z_j) <= MODULE_REL_L2
    assert img_t.shape == (1, 3, 64, 64) and np.isfinite(img_t).all()
    assert 0.05 < ((img_j > 0.0) & (img_j < 1.0)).mean()  # not all clipped
    assert rel_l2(img_t, img_j) <= PIXEL_REL_L2


def test_wrapper_text2img3_matches_jax():
    """An ID embedding → ada rows in CLIP-L's table → the placeholder prompt
    in encoder 1 (whose pooling then lands on the last placeholder), the
    plain prompt in encoder 2 → images; JAX's latents (its key) handed to
    the port. "sd3" is the same pipeline."""
    jm = jax_modules()
    tok_t = ttok.CLIPTokenizer.character_fallback()
    jenc, tenc = encoder_pair(jm, tok_t)
    jw = JWrapper("text2img3", jm, jenc, num_inference_steps=2, dtype=jnp.float32)
    tm = port_modules(jm)  # after the JAX wrapper grew CLIP-L's table
    tm.tokenizer = tok_t
    tw = AdaFaceWrapper("text2img3", tm, tenc, num_inference_steps=2, dtype=torch.float32)
    assert tw.placeholder_token_ids == jw.placeholder_token_ids
    fid = np.random.RandomState(21).randn(1, 512).astype(np.float32)
    jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    tw.prepare_adaface_embeddings(face_id_embs=_t(fid))
    rng = jax.random.PRNGKey(10)
    lat = jax.random.normal(rng, (1, 16, 16, 16), jnp.float32)
    kw = dict(negative_prompt=NEGATIVE, guidance_scale=5.0, height=64, width=64)
    img_j = np.asarray(jw("portrait in a garden", rng=rng, **kw))
    img_t = tw("portrait in a garden", latents=_t(np.asarray(lat)), **kw).numpy()
    assert img_t.shape == (1, 3, 64, 64)
    assert rel_l2(img_t, img_j) <= PIXEL_REL_L2
    alias = AdaFaceWrapper("sd3", tm, tenc)
    assert alias.pipeline_name == "text2img3" and isinstance(alias.pipeline, SD3Pipeline)
