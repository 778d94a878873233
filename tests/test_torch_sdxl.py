"""The port's SDXL branch against the JAX package, on the CPU in fp32.

The bigG tokenizer's 0-padding after eos; a bigG-shaped text tower (gelu, a
bias-free projection) with its penultimate hidden state, eos pooling and
projected pooling, also on a placeholder-extended prompt whose argmax lands
on a placeholder; the SDXL UNet (transformer depths (1, 2, 3) per level and
3 in the mid block, heads per level, the up blocks' reversed depths, the
"text_time" addition embedding) against `unet_apply(added_cond=...)`, and a
depth-2 UNet with capture and the attention adapters on the last inner
block; the flash wrapper at head dim 64 (on the card the wgmma kernel's
new instance, whose plan `tests/test_torch_ops.py::test_flash_plan` holds;
here its plain version against JAX's Pallas kernel in interpret mode); the
SDXL pipeline for 2 Euler steps with CFG (JAX's
latents handed over; an empty negative prompt conditions on zeros) and
`AdaFaceWrapper("text2imgxl")` / ("sdxl") against JAX's wrapper.

Tiny configurations are those of `tests/test_sdxl.py`. Tolerances: relative
L2 <= 1e-5 for modules and latents (fp32 sums over a few layers in another
order), <= 1e-4 for pixels; the flash plain version 1e-5 abs as in
`tests/test_torch_ops.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.inference.sdxl_pipeline import SDXLPipeline as JSDXLPipeline
from adaface_tpu.inference.sdxl_pipeline import SDXLPipelineModules as JSDXLModules
from adaface_tpu.inference.wrapper import AdaFaceWrapper as JWrapper
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import attention as jattn
from adaface_tpu.text import tokenizer as jtok
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.inference.sdxl_pipeline import SDXLPipeline, SDXLPipelineModules
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import attention as tattn
from adaface_tpu_torch.text import tokenizer as ttok
from tests.test_torch_comp import lora_trees
from tests.test_torch_models import TINY_VISION, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

MODULE_REL_L2 = 1e-5
PIXEL_REL_L2 = 1e-4
OP_ATOL = 1e-5
D1, D2 = 64, 48
TEXT1_KW = dict(hidden_size=D1, num_layers=3, num_heads=2, intermediate_size=128)
TEXT2_KW = dict(hidden_size=D2, num_layers=3, num_heads=2, intermediate_size=96,
                hidden_act="gelu", projection_dim=40)
XL_UNET_KW = dict(block_channels=(16, 32, 48), down_has_attn=(False, True, True),
                  up_has_attn=(True, True, False), transformer_depth=(1, 2, 3),
                  mid_transformer_depth=3, block_num_heads=(2, 2, 4), cross_attn_dim=D1 + D2,
                  norm_groups=8, time_embed_dim=64, addition_time_embed_dim=8,
                  addition_pooled_dim=40)
VAE_KW = dict(base_ch=16, ch_mult=(1, 2, 2), num_res_blocks=1, norm_groups=8)
NEGATIVE = "lowres, low quality"


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_zero_pad_after_eos_matches_jax():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 49406, (4, 77))
    eos = 49407
    ids[0, 5] = ids[0, 9] = eos  # a second eos is zeroed too
    ids[1, 76] = eos  # eos last: nothing after it
    ids[2, 0] = eos
    # row 3 has no eos: argmax of all-False is 0, so the rows past 0 are zeroed, as in JAX
    out = ttok.zero_pad_after_eos(ids, eos)
    np.testing.assert_array_equal(out, jtok.zero_pad_after_eos(ids, eos))
    assert out[0, 5] == eos and out[0, 9] == 0 and (out[0, 6:] == 0).all()


def tokenizer_pair(placeholders=()):
    """A JAX and a port tokenizer, each with the placeholder tokens added."""
    jt, tt = jtok.CLIPTokenizer.character_fallback(), ttok.CLIPTokenizer.character_fallback()
    if placeholders:
        assert jt.add_tokens(list(placeholders)) == tt.add_tokens(list(placeholders))
    return jt, tt


@pytest.mark.parametrize("placeholders", [False, True])
def test_bigg_tower_matches_jax(placeholders):
    """The bigG-shaped tower's penultimate state, pooled and projected
    pooled outputs on tokenizer-2 ids; with placeholders past eos in the
    vocabulary (SD3's encoder 1), the pooling's argmax lands on the last
    placeholder, not on eos, in both."""
    names = ["z_0_0", "z_0_1"] if placeholders else []
    jt, tt = tokenizer_pair(names)
    cfg_j = jclip.CLIPTextConfig(**TEXT2_KW, vocab_size=jt.vocab_size)
    cfg_t = tclip.CLIPTextConfig(**TEXT2_KW, vocab_size=tt.vocab_size)
    params = numpy_params(lambda k: jclip.init_text_params(k, cfg_j), 1)
    model = bridge.load(tclip.CLIPTextModel(cfg_t), params)
    prompts = ["a photo of a person z_0_0 z_0_1" if placeholders else "a photo of a cat",
               "an astronaut riding a horse"]
    ids = tt(prompts, max_length=77)
    np.testing.assert_array_equal(ids, jt(prompts, max_length=77))
    if not placeholders:
        ids = ttok.zero_pad_after_eos(ids, tt.eos_token_id)
    else:
        first_eos = int(np.argmax(ids[0] == tt.eos_token_id))
        assert int(np.argmax(ids[0])) < first_eos  # the pooling row is a placeholder's
    ref = jax.jit(lambda p, i: jclip.text_encode(p, i, cfg_j, return_hidden_states=True,
                                                 return_pooled=True))(params, jnp.asarray(ids))
    with torch.inference_mode():
        out = model(_t(ids).long(), return_hidden_states=True, return_pooled=True)
    assert len(out["hidden_states"]) == len(ref["hidden_states"]) == cfg_t.num_layers + 1
    for key, o, r in (("penultimate", out["hidden_states"][-2], ref["hidden_states"][-2]),
                      ("last", out["last_hidden_state"], ref["last_hidden_state"]),
                      ("pooled", out["pooled"], ref["pooled"]),
                      ("pooled_proj", out["pooled_proj"], ref["pooled_proj"])):
        assert rel_l2(o.numpy(), r) <= MODULE_REL_L2, key
    assert out["pooled_proj"].shape == (2, 40)


def _unet_inputs(cfg, b=2, hw=16, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 4, hw, hw).astype(np.float32)
    t = np.array([10, 700][:b], np.int32)
    ctx = rs.randn(b, 7, cfg.cross_attn_dim).astype(np.float32)
    added = {"text_embeds": rs.randn(b, cfg.addition_pooled_dim).astype(np.float32),
             "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (b, 1))}
    return x, t, ctx, added


def test_sdxl_unet_matches_jax():
    """Depths (1, 2, 3) and 3 in the mid block, heads (2, 2, 4), the up
    blocks' reversed depths, the addition embedding."""
    cfg_j, cfg_t = junet.UNetConfig(**XL_UNET_KW), tunet.UNetConfig(**XL_UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 2)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    # the tree's depth-1 and depth-N transformers load as `block` and `blocks`
    assert hasattr(model.up_blocks[0].attentions[0], "blocks")
    assert len(model.up_blocks[0].attentions[0].blocks) == 3
    assert len(model.up_blocks[1].attentions[0].blocks) == 2
    assert len(model.mid["attention"].blocks) == 3
    assert model.up_blocks[0].attentions[0].blocks[0].attn1.num_heads == 4
    x, t, ctx, added = _unet_inputs(cfg_t)
    ref, _ = jax.jit(lambda p, x, t, c, a: junet.unet_apply(p, x, t, c, cfg_j, added_cond=a))(
        params, x, t, ctx, added)
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx),
                    added_cond={k: _t(v) for k, v in added.items()})
    assert rel_l2(out.numpy(), ref) <= MODULE_REL_L2
    # the state dict goes back to the JAX tree's names and layouts
    flat = bridge.tree_state_dict(model)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        np.testing.assert_array_equal(flat[key], np.asarray(leaf))


DEPTH2_UNET_KW = dict(block_channels=(16, 32, 32), down_has_attn=(True, True, False),
                      up_has_attn=(False, True, True), transformer_depth=(2, 1, 1),
                      cross_attn_dim=D1, num_heads=2, norm_groups=8, lora_rank=4, lora_alpha=2)


def test_depth2_capture_and_adapters_on_the_last_block():
    """A UNet whose captured level has two transformer blocks: the capture
    and the attention adapters act on the last inner block alone
    (`unet.py:635-637`), eps and every captured tensor against JAX."""
    cfg_j, cfg_t = junet.UNetConfig(**DEPTH2_UNET_KW), tunet.UNetConfig(**DEPTH2_UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 4)
    attn, _ = lora_trees(cfg_j, 5)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    t_attn = bridge.load_lora(tunet.AttnLoRA(cfg_t), attn)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    t = np.array([50, 400], np.int32)
    ctx = rs.randn(2, 9, D1).astype(np.float32)
    rt = dict(capture=True, use_attn_lora=True)
    ref, cap_j = jax.jit(lambda p, x, t, c, a: junet.unet_apply(
        p, x, t, c, cfg_j, rt=junet.AttnRuntime(**rt), attn_lora=a))(params, x, t, ctx, attn)
    cap_t = {}
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx), capture=cap_t, rt=tunet.AttnRuntime(**rt),
                    attn_lora=t_attn)
    assert rel_l2(out.numpy(), ref) <= MODULE_REL_L2
    assert set(cap_t) == set(cap_j) and len(cap_t) == 8
    for key in cap_j:
        assert set(cap_t[key]) == set(cap_j[key]) == {22, 23, 24}
        for label, r in cap_j[key].items():
            assert rel_l2(cap_t[key][label].numpy(), r) <= MODULE_REL_L2, (key, label)


@pytest.mark.parametrize("sq,sk,masked", [(130, 77, False), (200, 200, True)])
def test_flash_d64_matches_pallas_interpret(sq, sk, masked):
    """The flash wrapper at head dim 64 (on the CPU its plain version, and
    the wgmma kernel's tiling in plain PyTorch: 64-key tiles) against JAX's
    Pallas kernel in interpret mode: a cross-attention's 77 keys, and a
    masked self-attention with ragged tiles."""
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(2, 2, s, 64).astype(np.float32) for s in (sq, sk, sk))
    mask = None
    if masked:
        mask = np.ones((2, sk), np.float32)
        mask[0, :8] = 0.0
        mask[1, sk - 20:] = 0.0
    ref = jattn.flash_attention(q, k, v, kv_mask=None if mask is None else jnp.asarray(mask),
                                block_q=128, block_k=128, interpret=True)
    tmask = None if mask is None else _t(mask)
    out = tattn.flash_attention(_t(q), _t(k), _t(v), kv_mask=tmask)
    tiled = tattn.flash_attention_tiled(_t(q), _t(k), _t(v), kv_mask=tmask, key_tile=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OP_ATOL)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(ref), atol=OP_ATOL)


# ---------------------------------------------------------------------------
# the pipeline and the wrapper
# ---------------------------------------------------------------------------


def jax_modules(text1_vocab: int | None = None):
    """The JAX SDXL modules at the tiny widths, from numpy seeds (the JAX
    initialisers op by op take tens of seconds); the UNet's head scaled
    down so that the decoded pixels stay off the [0, 1] clip."""
    cfg1 = jclip.CLIPTextConfig(**TEXT1_KW)
    cfg2 = jclip.CLIPTextConfig(**TEXT2_KW)
    unet_cfg, vae_cfg = junet.UNetConfig(**XL_UNET_KW), jvae.VAEConfig(**VAE_KW)
    unet = numpy_params(lambda k: junet.init_unet_params(k, unet_cfg), 10)
    unet["conv_out"]["w"] = unet["conv_out"]["w"] * 0.1
    return JSDXLModules(
        unet=unet, vae=numpy_params(lambda k: jvae.init_vae_params(k, vae_cfg), 11),
        text_encoder=numpy_params(lambda k: jclip.init_text_params(k, cfg1), 12),
        text_encoder_2=numpy_params(lambda k: jclip.init_text_params(k, cfg2), 13),
        tokenizer=jtok.CLIPTokenizer.character_fallback(), unet_cfg=unet_cfg, vae_cfg=vae_cfg,
        text_cfg=cfg1, text2_cfg=cfg2)


def port_modules(jm) -> SDXLPipelineModules:
    """The port's modules on the JAX modules' weights (the CLIP-L table at
    the rows it has, placeholders included)."""
    vocab = jm.text_encoder["token_embedding"].shape[0]
    return SDXLPipelineModules(
        unet=bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**XL_UNET_KW)), jm.unet),
        vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                        bridge.vae_decoder_tree(jm.vae)),
        text_encoder=bridge.load(tclip.CLIPTextModel(
            tclip.CLIPTextConfig(**TEXT1_KW, vocab_size=vocab)), jm.text_encoder),
        text_encoder_2=bridge.load(tclip.CLIPTextModel(tclip.CLIPTextConfig(**TEXT2_KW)),
                                   jm.text_encoder_2),
        tokenizer=ttok.CLIPTokenizer.character_fallback())


@pytest.fixture(scope="module")
def pipelines():
    jm = jax_modules()
    return JSDXLPipeline(jm, dtype=jnp.float32), SDXLPipeline(port_modules(jm),
                                                              dtype=torch.float32)


@pytest.mark.parametrize("negative", ["", NEGATIVE])
def test_sdxl_pipeline_matches_jax(pipelines, negative):
    """2 Euler steps with CFG at 64x64 (16x16 latents: the tiny VAE scales
    by 4), JAX's latents handed over: the
    encoded prompt (an empty negative is zeros), the final latents and the
    pixels; then one DDIM request."""
    jp, tp = pipelines
    prompt = "an astronaut riding a horse"
    cond_j, pooled_j, uncond_j, neg_j = jp.encode_prompt([prompt], [prompt], [negative])
    with torch.inference_mode():
        cond_t, pooled_t, uncond_t, neg_t = tp.encode_prompt([prompt], [prompt], [negative])
    for o, r in ((cond_t, cond_j), (pooled_t, pooled_j)):
        assert rel_l2(o.numpy(), r) <= MODULE_REL_L2
    assert cond_t.shape == (1, 77, D1 + D2) and pooled_t.shape == (1, 40)
    if negative == "":
        assert not uncond_t.any() and not neg_t.any()
    else:
        assert rel_l2(uncond_t.numpy(), uncond_j) <= MODULE_REL_L2
        assert rel_l2(neg_t.numpy(), neg_j) <= MODULE_REL_L2
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 4, 16, 16), jnp.float32))
    kw = dict(negative_prompt=negative, num_inference_steps=2, guidance_scale=5.0, height=64,
              width=64)
    z_j = jp(prompt, latents=jnp.asarray(lat), return_latents=True, **kw)
    img_j = np.asarray(jp(prompt, latents=jnp.asarray(lat), **kw))
    z_t = tp(prompt, latents=_t(lat), return_latents=True, **kw)
    img_t = tp(prompt, latents=_t(lat), **kw).numpy()
    assert rel_l2(z_t.numpy(), z_j) <= MODULE_REL_L2
    assert img_t.shape == (1, 3, 64, 64) and np.isfinite(img_t).all()
    assert 0.05 < ((img_j > 0.0) & (img_j < 1.0)).mean()  # not all clipped
    assert rel_l2(img_t, img_j) <= PIXEL_REL_L2
    if negative:
        z_j = jp(prompt, latents=jnp.asarray(lat), return_latents=True, scheduler="ddim", **kw)
        z_t = tp(prompt, latents=_t(lat), return_latents=True, scheduler="ddim", **kw)
        assert rel_l2(z_t.numpy(), z_j) <= MODULE_REL_L2


def encoder_pair(jm, tok_t):
    """Arc2Face ID→ada encoders at the tiny widths (CLIP-L 64 wide, as the
    SDXL modules' encoder 1) on one set of weights."""
    text_j = jclip.CLIPTextConfig(**{**TEXT1_KW, "num_layers": 2})
    text_t = tclip.CLIPTextConfig(**{**TEXT1_KW, "num_layers": 2})
    jenc = JArc2Face(
        jax.random.PRNGKey(4), tokenizer=jm.tokenizer, face_backend=JBackend(),
        clip_vision_cfg=TINY_VISION, sbg_clip_cfg=text_j, text_cfg=text_j, output_dim=D1,
        text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_j), 14),
        clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, TINY_VISION), 15))
    tenc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jenc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), tok_t),
                    bridge.sbg_tree(jenc.subj_basis_generator)),
        tok_t, face_backend=DeterministicBackend())
    return jenc, tenc


def test_wrapper_text2imgxl_matches_jax():
    """The user entry point: an ID embedding → ada rows in CLIP-L's table →
    the placeholder prompt in encoder 1, the plain prompt in encoder 2 →
    images; JAX's latents (from its key) handed to the port. The reference's
    name "sdxl" is the same pipeline; "flux" is refused."""
    jm = jax_modules()
    tok_t = ttok.CLIPTokenizer.character_fallback()
    jenc, tenc = encoder_pair(jm, tok_t)
    jw = JWrapper("text2imgxl", jm, jenc, num_inference_steps=2, dtype=jnp.float32)
    tm = port_modules(jm)  # after the JAX wrapper grew CLIP-L's table
    tm.tokenizer = tok_t
    tw = AdaFaceWrapper("text2imgxl", tm, tenc, num_inference_steps=2, dtype=torch.float32)
    assert tw.placeholder_token_ids == jw.placeholder_token_ids
    fid = np.random.RandomState(20).randn(1, 512).astype(np.float32)
    ada_j = jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid))
    ada_t = tw.prepare_adaface_embeddings(face_id_embs=_t(fid))
    assert rel_l2(ada_t.numpy(), ada_j) <= MODULE_REL_L2
    rng = jax.random.PRNGKey(9)
    lat = jax.random.normal(jax.random.split(rng)[0], (1, 4, 16, 16), jnp.float32)
    kw = dict(negative_prompt=NEGATIVE, guidance_scale=5.0, height=64, width=64)
    img_j = np.asarray(jw("portrait at the beach", rng=rng, **kw))
    img_t = tw("portrait at the beach", latents=_t(np.asarray(lat)), **kw).numpy()
    assert img_t.shape == (1, 3, 64, 64)
    assert rel_l2(img_t, img_j) <= PIXEL_REL_L2
    alias = AdaFaceWrapper("sdxl", tm, tenc)
    assert alias.pipeline_name == "text2imgxl" and isinstance(alias.pipeline, SDXLPipeline)
    with pytest.raises(NotImplementedError, match="flux"):
        AdaFaceWrapper("flux", tm, tenc)
