"""The port's JAX-free converters (`adaface_tpu_torch/tools/`, BiSeNet's in
`models/bisenet.py`) against the JAX package's, on the CPU.

Each converter of both packages reads the same synthetic state dict, made
from a tiny tree at the JAX initialisers' layout by the inverse writers of
`tests/torch_sd_layout.py` (or the JAX package's own `export_unet_to_
diffusers`): the trees must hold the same keys and equal leaves, dtypes
included (`np.array_equal`, no tolerance). `load_sd_towers` reads a single
file in the LDM layout (fp16 tensors, LitEma shadows, schedule buffers) as
`.safetensors` and as a torch `.ckpt`. A UNet of the port loaded from a
converted tree is held to `unet_apply` on the JAX tree at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.models import bisenet as jbisenet
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.id2ada import layers as jL
from adaface_tpu.tools import ckpt_lib as jckpt
from adaface_tpu.tools import convert_clip as jcc
from adaface_tpu.tools import convert_consistentid as jcid
from adaface_tpu.tools import convert_ldm_unet as jldm
from adaface_tpu.tools import convert_sd as jsd
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada.layers import ProjPlus
from adaface_tpu_torch.models import bisenet as tbisenet
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.tools import ckpt_lib as tckpt
from adaface_tpu_torch.tools import convert_clip as tcc
from adaface_tpu_torch.tools import convert_consistentid as tcid
from adaface_tpu_torch.tools import convert_ldm_unet as tldm
from adaface_tpu_torch.tools import convert_sd as tsd
from tests import torch_sd_layout as layout
from tests.test_torch_models import D, TEXT_KW, UNET_KW, VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

UNET_J, UNET_T = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
VAE_J, VAE_T = jvae.VAEConfig(**VAE_KW), tvae.VAEConfig(**VAE_KW)
TEXT_J = jclip.CLIPTextConfig(**TEXT_KW)
UNET_CALL_RTOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    """Tiny UNet, VAE and CLIP text trees (numpy leaves)."""
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(unet=as_np(numpy_params(lambda k: junet.init_unet_params(k, UNET_J), 400)),
                vae=as_np(numpy_params(lambda k: jvae.init_vae_params(k, VAE_J), 401)),
                text=as_np(numpy_params(lambda k: jclip.init_text_params(k, TEXT_J), 402)))


def assert_same_tree(out, ref):
    """The same keys, and every leaf equal with its dtype."""
    out, ref = jckpt.flatten_tree(out), jckpt.flatten_tree(ref)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and np.array_equal(out[k], ref[k]), k


def test_unet_converters_match_jax(trees):
    """`convert_unet` and `export_unet_to_diffusers` against JAX's on the
    JAX export of a tree; export ∘ convert is the identity."""
    sd = jsd.export_unet_to_diffusers(trees["unet"], UNET_J)
    out = tsd.convert_unet(sd, UNET_T)
    assert_same_tree(out, jsd.convert_unet(sd, UNET_J))
    assert_same_tree(out, trees["unet"])
    back = tsd.export_unet_to_diffusers(out, UNET_T)
    ref = jsd.export_unet_to_diffusers(out, UNET_J)
    assert sorted(back) == sorted(ref) == sorted(sd)
    assert all(np.array_equal(back[k], ref[k]) and np.array_equal(back[k], sd[k]) for k in sd)
    # fp16 leaves stay fp16, as `jnp.asarray` keeps them
    half = {k: v.astype(np.float16) for k, v in sd.items()}
    assert_same_tree(tsd.convert_unet(half, UNET_T), jsd.convert_unet(half, UNET_J))


def test_ldm_unet_converter_matches_jax(trees):
    """The LDM names of the key table, with and without the
    `model.diffusion_model.` prefix."""
    ldm = layout.unet_to_ldm(trees["unet"], UNET_T)
    assert sorted(tldm.ldm_unet_to_diffusers_keys(ldm, UNET_T)) == sorted(
        jldm.ldm_unet_to_diffusers_keys(ldm, UNET_J))
    out = tldm.convert_ldm_unet(ldm, UNET_T)
    assert_same_tree(out, jldm.convert_ldm_unet(ldm, UNET_J))
    assert_same_tree(out, trees["unet"])
    bare = {k[len("model.diffusion_model."):]: v for k, v in ldm.items()}
    assert_same_tree(tldm.convert_ldm_unet(bare, UNET_T), out)


@pytest.mark.parametrize("kind", ["ldm", "diffusers"])
def test_vae_converters_match_jax(trees, kind):
    if kind == "ldm":
        sd = {f"first_stage_model.{k}": v for k, v in layout.vae_to_ldm(trees["vae"]).items()}
        out, ref = tsd.convert_vae_ldm(sd, VAE_T), jsd.convert_vae_ldm(sd, VAE_J)
    else:
        sd = layout.vae_to_diffusers(trees["vae"])
        out, ref = tsd.convert_vae_diffusers(sd, VAE_T), jsd.convert_vae_diffusers(sd, VAE_J)
    assert_same_tree(out, ref)
    assert_same_tree(out, trees["vae"])


def test_apply_ema_weights_matches_jax(trees):
    sd = layout.sd_single_file(trees["unet"], trees["vae"], trees["text"], UNET_T,
                               ema_unet_tree=jax.tree_util.tree_map(lambda a: a * 2.0,
                                                                    trees["unet"]))
    out, ref = tsd.apply_ema_weights(sd), jsd.apply_ema_weights(sd)
    assert sorted(out) == sorted(ref)
    assert all(np.array_equal(out[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="no model_ema"):
        tsd.apply_ema_weights({"model.diffusion_model.out.2.bias": np.zeros(4)})


def text_cfg_fields(cfg) -> dict:
    keep = ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
            "max_position_embeddings", "hidden_act", "image_size", "patch_size", "projection_dim")
    return {k: getattr(cfg, k) for k in keep if hasattr(cfg, k)}


@pytest.mark.parametrize("case", ["plain", "projection", "mkv"])
def test_text_converter_matches_jax(trees, case):
    """CLIP-L-shaped text towers; a top-level `text_projection` is carried;
    MKV-extended k/v (out-dimension twice the width) converts as it is."""
    sd = layout.text_to_hf(trees["text"])
    if case == "projection":
        sd["text_projection.weight"] = np.random.RandomState(0).randn(32, D).astype(np.float32)
    elif case == "mkv":
        for i in range(TEXT_J.num_layers):
            for name in ("k_proj", "v_proj"):
                key = f"text_model.encoder.layers.{i}.self_attn.{name}"
                sd[f"{key}.weight"] = np.concatenate([sd[f"{key}.weight"]] * 2)
                sd[f"{key}.bias"] = np.concatenate([sd[f"{key}.bias"]] * 2)
    out, cfg = tcc.convert_text_model(sd, num_heads=2)
    ref, cfg_j = jcc.convert_text_model(sd, num_heads=2)
    assert_same_tree(out, ref)
    assert text_cfg_fields(cfg) == text_cfg_fields(cfg_j)
    if case == "plain":
        assert_same_tree(out, trees["text"])
        assert cfg == tclip.CLIPTextConfig(**TEXT_KW)


@pytest.mark.parametrize("width", [64, 1280])
def test_vision_converter_matches_jax(width):
    """A CLIP-L-shaped tower without projection, and a CLIP-H-wide one
    (1280: head dim 80 by default) with `visual_projection`."""
    vis = jclip.CLIPVisionConfig(hidden_size=width, num_layers=1, num_heads=2,
                                 intermediate_size=64, image_size=28, patch_size=14,
                                 projection_dim=None if width == 64 else 16)
    tree = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jclip.init_vision_params(k, vis), 403))
    sd = layout.vision_to_hf(tree)
    out, cfg = tcc.convert_vision_model(sd)
    ref, cfg_j = jcc.convert_vision_model(sd)
    assert_same_tree(out, ref)
    assert text_cfg_fields(cfg) == text_cfg_fields(cfg_j)
    assert cfg.num_heads == (16 if width == 1280 else 1)
    if width == 64:
        assert_same_tree(out, tree)


def test_consistentid_converter_matches_jax(tmp_path):
    """A ProjPlusModel state dict bare, inside the checkpoint's "image_proj",
    and under "image_proj_model."; from a `.bin` file into the port's
    ConsistentID encoder (`image_proj_path`)."""
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import ConsistentIDID2AdaPrompt
    from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
    from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
    from tests.test_torch_id2ada import CID_VISION

    tree = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jL.init_proj_plus(k, 512, CID_VISION["hidden_size"], D, 4, depth=2), 404))
    sd = layout.proj_plus_to_torch(tree)
    for wrapped in (sd, {"image_proj": sd}, {f"image_proj_model.{k}": v for k, v in sd.items()}):
        out = tcid.convert_consistentid_proj(wrapped)
        assert_same_tree(out, jcid.convert_consistentid_proj(wrapped))
        assert_same_tree(out, tree)
    with pytest.raises(KeyError, match="perceiver_resampler"):
        tcid.convert_consistentid_proj({"norm.weight": np.zeros(4)})
    path = str(tmp_path / "ConsistentID-v1.bin")
    torch.save({"image_proj": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    assert_same_tree(tcid.load_consistentid_proj(path), jcid.load_consistentid_proj(path))
    text_t = tclip.CLIPTextConfig(**TEXT_KW)
    enc = ConsistentIDID2AdaPrompt.random_init(
        torch.Generator().manual_seed(0), CLIPTokenizer.character_fallback(), "cpu",
        vision_cfg=tclip.CLIPVisionConfig(**CID_VISION),
        sbg_cfg=SubjBasisConfig(num_id_vecs=4, clip=text_t), image_proj_path=path)
    want = bridge.load(ProjPlus(512, CID_VISION["hidden_size"], D, 4, depth=2), tree)
    got, ref = enc.image_proj.state_dict(), want.state_dict()
    assert sorted(got) == sorted(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


def test_bisenet_converter_matches_jax(tmp_path):
    tree = jax.tree_util.tree_map(np.asarray, numpy_params(jbisenet.init_bisenet_params, 405))
    sd = layout.bisenet_to_torch(tree)
    out = tbisenet.convert_bisenet_state_dict(sd)
    assert_same_tree(out, jbisenet.convert_bisenet_state_dict(sd))
    assert_same_tree(out, tree)
    path = str(tmp_path / "79999_iter.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    model = tsd.load_module(tbisenet.BiSeNet, tbisenet.convert_bisenet_state_dict(
        tckpt.load_state_dict(path)), "cpu", torch.float32)
    want = bridge.state_dict(tree)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def write_single_file(path, trees, ema_scale: float = 2.0):
    """An SD1.5 single file at the tiny widths: fp16, with EMA shadows
    (`ema_scale` × the weights) and the schedule buffers."""
    ema = jax.tree_util.tree_map(lambda a: (a * ema_scale).astype(np.float32), trees["unet"])
    sd = layout.sd_single_file(trees["unet"], trees["vae"], trees["text"], UNET_T,
                               ema_unet_tree=ema)
    if path.endswith(".ckpt"):
        torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                    "global_step": 1}, path)
    else:
        tckpt.save_state_dict(sd, path)
    return sd


@pytest.mark.parametrize("ext", [".safetensors", ".ckpt"])
@pytest.mark.parametrize("prefer_ema", [False, True])
def test_load_sd_towers_matches_jax(trees, tmp_path, ext, prefer_ema):
    """Every tower of the file, in fp32 (`cast_fp32`) and as stored; the
    EMA shadows taken where asked for."""
    path = str(tmp_path / f"sd15{ext}")
    write_single_file(path, trees)
    for cast in (True, False):
        out = tsd.load_sd_towers(path, UNET_T, VAE_T, prefer_ema=prefer_ema, cast_fp32=cast)
        ref = jsd.load_sd_towers(path, UNET_J, VAE_J, prefer_ema=prefer_ema, cast_fp32=cast)
        assert sorted(out) == sorted(ref) == ["text_cfg", "text_encoder", "unet", "vae"]
        for key in ("unet", "vae", "text_encoder"):
            assert_same_tree(out[key], jax.tree_util.tree_map(np.asarray, ref[key]))
        assert text_cfg_fields(out["text_cfg"]) == text_cfg_fields(ref["text_cfg"])
    scale = 2.0 if prefer_ema else 1.0
    w = out["unet"]["conv_in"]["w"].astype(np.float32)
    np.testing.assert_array_equal(
        w, (trees["unet"]["conv_in"]["w"] * scale).astype(np.float16).astype(np.float32))
    # a bare diffusers UNet file
    bare = str(tmp_path / "unet.safetensors")
    tckpt.save_state_dict(jsd.export_unet_to_diffusers(trees["unet"], UNET_J), bare)
    only = tsd.load_sd_towers(bare, UNET_T, VAE_T)
    assert sorted(only) == ["unet"]
    assert_same_tree(only["unet"], trees["unet"])


def test_loaded_unet_call_matches_jax(trees, tmp_path):
    """The single file → `load_pipeline_modules` → one UNet call of the port
    against `unet_apply` on the JAX converter's tree, 1e-5; the VAE and the
    text tower landed as the bridge lands the source trees."""
    path = str(tmp_path / "sd15.safetensors")
    write_single_file(path, trees, ema_scale=1.0)
    towers = tsd.load_sd_towers(path, UNET_T, VAE_T)
    m = tsd.load_pipeline_modules(towers, "cpu", torch.float32, unet_cfg=UNET_T, vae_cfg=VAE_T)
    ref = jsd.load_sd_towers(path, UNET_J, VAE_J)
    rs = np.random.RandomState(406)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rs.randn(2, 7, D).astype(np.float32)
    eps_j, _ = jax.jit(lambda p, x, t, c: junet.unet_apply(p, x, t, c, UNET_J))(
        ref["unet"], x, t, ctx)
    with torch.no_grad():
        eps_t = m.unet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    eps_j = np.asarray(eps_j)
    assert np.abs(eps_t.numpy() - eps_j).max() <= UNET_CALL_RTOL * np.abs(eps_j).max()
    for module, tree in ((m.vae, bridge.vae_decoder_tree(ref["vae"])),
                         (m.vae_encoder, bridge.vae_encoder_tree(ref["vae"])),
                         (m.text_encoder, ref["text_encoder"])):
        want = bridge.fuse_projections(bridge.state_dict(tree), module.state_dict())
        got = module.state_dict()
        assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    # the head count is not in the shapes: head dim 64, as JAX's converter takes it
    assert m.text_encoder.cfg == tclip.CLIPTextConfig(**dict(TEXT_KW, num_heads=1))
    with pytest.raises(ValueError, match="no base modules"):
        tsd.load_pipeline_modules({"unet": towers["unet"]}, "cpu", torch.float32,
                                  unet_cfg=UNET_T, vae_cfg=VAE_T)


def test_ckpt_lib_tree_helpers_match_jax(trees):
    flat = jckpt.flatten_tree(trees["vae"])
    assert jax.tree_util.tree_structure(tckpt.unflatten_tree(flat)) == \
        jax.tree_util.tree_structure(jckpt.unflatten_tree(flat))
    sd = {"a.b.c": np.zeros(2), "a.d": np.ones(1), "e": np.zeros(1)}
    for strip in (True, False):
        got, want = tckpt.extract_subtree(sd, "a.", strip), jckpt.extract_subtree(sd, "a.", strip)
        assert sorted(got) == sorted(want)
    with pytest.raises(KeyError):
        tckpt.extract_subtree(sd, "z.")
