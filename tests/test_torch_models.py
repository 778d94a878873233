"""Parity of the PyTorch port's modules with the JAX package, on the CPU.

Each module gets params in the JAX initialiser's tree layout at the tiny
widths of `tests/test_inference.py`, drawn from numpy seeds (see
`numpy_params`), carried over by `adaface_tpu_torch.core.bridge`, and the
same numpy inputs on both sides, in fp32. Tolerance for modules:
1e-4 relative to the output's largest magnitude — fp32 sums over a few
layers, taken in another order (and, for the UNet and VAE, through other
convolution algorithms).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.id2ada.subj_basis_generator import (SubjBasisConfig as JSBGConfig,
                                                     init_subj_basis_generator,
                                                     subj_basis_forward)
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import fused_ln as tln
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer

MODULE_RTOL = 1e-4
D = 64
TEXT_KW = dict(hidden_size=D, num_layers=2, num_heads=2, intermediate_size=128)
UNET_KW = dict(block_channels=(16, 32, 32, 32), cross_attn_dim=D, num_heads=2,
               norm_groups=8)
VAE_KW = dict(base_ch=16, ch_mult=(1, 2, 2), num_res_blocks=1, norm_groups=8)
TINY_VISION = jclip.CLIPVisionConfig(hidden_size=D, num_layers=2, num_heads=2,
                                     intermediate_size=128, image_size=224,
                                     patch_size=32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side, autouse here and in every
    file that imports it: the tensors are tiny, and under several test
    workers on one host a pool of threads per process turns each of the many
    small operations into a wait for descheduled threads (a finetuning fit
    took 756 s so in a 6-worker run, 33 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close_rel(out, ref, rtol=MODULE_RTOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(out - ref).max() / scale
    assert err <= rtol, f"max error {err:.3e} of the largest |ref| {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def numpy_params(init, seed: int):
    """The pytree `init(key)` would build, with leaves drawn from a numpy
    seed: weights N(0, 1/fan_in), embedding tables N(0, 0.02²), and norm
    scales and all biases off their 1/0 start so the bridge's handling of
    each shows. The tree comes from `jax.eval_shape` (about a second), where
    running the JAX initialisers op by op on the CPU takes tens of seconds."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        a = rs.randn(*s.shape).astype(np.float32)
        if name == "w":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * a
        if name in ("b", "bias"):
            return 0.1 * a
        return 0.02 * a

    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(leaf(path, s)), jax.eval_shape(init, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("skip", [None, "layers", "per_dim"])
def test_clip_text_matches_jax(skip):
    cfg_j, cfg_t = jclip.CLIPTextConfig(**TEXT_KW), tclip.CLIPTextConfig(**TEXT_KW)
    params = numpy_params(lambda k: jclip.init_text_params(k, cfg_j), 0)
    model = bridge.load(tclip.CLIPTextModel(cfg_t), params)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg_j.vocab_size, (2, 77)).astype(np.int32)
    embs = (rs.randn(2, 77, D) * 0.02).astype(np.float32)
    w = {None: None, "layers": np.array([[1.0], [2.0], [4.0]], np.float32),
         "per_dim": rs.rand(3, D).astype(np.float32) + 0.5}[skip]
    ref = jax.jit(lambda p, e, w: jclip.text_encode(
        p, ids, cfg_j, input_embs=e, skip_weights=w)["last_hidden_state"])(
            params, embs if skip else None, w)
    with torch.inference_mode():
        out = model(_t(ids).long(), input_embs=_t(embs) if skip else None,
                    skip_weights=None if w is None else _t(w))
    assert_close_rel(out.numpy(), ref)
    # token lookup and position extension keep the JAX semantics
    np.testing.assert_array_equal(tclip.token_embeddings(model, _t(ids).long()).numpy(),
                                  np.asarray(jclip.token_embeddings(params, ids)))
    tclip.extend_position_embedding(model, 97)
    np.testing.assert_array_equal(
        model.position_embedding.detach().numpy(),
        np.asarray(jclip.extend_position_embedding(params, 97)["position_embedding"]))


def test_unet_matches_jax():
    cfg_j, cfg_t = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 1)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)  # 16x16: q-length 256 at level 0
    t = np.array([999, 17], np.int32)
    ctx = rs.randn(2, 77, D).astype(np.float32)
    # jit: one XLA program compiles in seconds where op-by-op takes a minute
    ref = jax.jit(lambda p, x, t, c: junet.unet_apply(p, x, t, c, cfg_j)[0])(
        params, x, t, ctx)
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx))
    assert_close_rel(out.numpy(), ref)


def test_unet_fused_ln_matches_jax():
    """`fused_ln=True` (the port's `ADAFACE_FUSED_LN=1`) against the JAX UNet
    with its fused-LN toggle on; on the CPU JAX takes `_ln_ref`, the port
    the plain version inside its LayerNorm Function."""
    cfg_j = junet.UNetConfig(**UNET_KW)
    cfg_t = tunet.UNetConfig(**UNET_KW, fused_ln=True)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 6)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    norms = [m for m in model.modules() if isinstance(m, tln.LayerNorm)]
    assert len(norms) == 3 * 16 and not any(isinstance(m, torch.nn.LayerNorm)
                                            for m in model.modules())
    rs = np.random.RandomState(6)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    t = np.array([5, 640], np.int32)
    ctx = rs.randn(2, 77, D).astype(np.float32)
    with mock.patch.object(junet, "_FUSED_LN", True):
        ref = jax.jit(lambda p, x, t, c: junet.unet_apply(p, x, t, c, cfg_j)[0])(
            params, x, t, ctx)
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx))
    assert_close_rel(out.numpy(), ref)
    # the default reads ADAFACE_FUSED_LN, "0" unless set
    with mock.patch.dict("os.environ", {"ADAFACE_FUSED_LN": "1"}):
        assert tunet.UNetConfig().fused_ln
    with mock.patch.dict("os.environ", {"ADAFACE_FUSED_LN": "0"}):
        assert not dataclasses.replace(tunet.UNetConfig(), num_heads=4).fused_ln


def test_vae_decode_matches_jax():
    cfg_j, cfg_t = jvae.VAEConfig(**VAE_KW), tvae.VAEConfig(**VAE_KW)
    params = numpy_params(lambda k: jvae.init_vae_params(k, cfg_j), 2)
    model = bridge.load(tvae.VAEDecoder(cfg_t), bridge.vae_decoder_tree(params))
    z = np.random.RandomState(2).randn(1, 4, 16, 16).astype(np.float32)
    ref = jax.jit(lambda p, z: jvae.vae_decode(p, z, cfg_j))(params, z)
    with torch.inference_mode():
        out = model(_t(z))
    assert out.shape == (1, 3, 64, 64)
    assert_close_rel(out.numpy(), ref)


def vae_pair(seed: int):
    """→ (the JAX VAE's config and numpy-seeded params, the port's encoder)."""
    cfg_j = jvae.VAEConfig(**VAE_KW)
    params = numpy_params(lambda k: jvae.init_vae_params(k, cfg_j), seed)
    encoder = bridge.load(tvae.VAEEncoder(tvae.VAEConfig(**VAE_KW)),
                          bridge.vae_encoder_tree(params))
    return cfg_j, params, encoder


@pytest.mark.parametrize("masks", [None, "fg", "fg+aug"])
def test_vae_encode_moments_matches_jax(masks):
    """The encoder (asymmetric downsample padding included) unmasked, and
    with the mid-block attention's fg and fg + aug masks, given at the
    image's resolution and resized to the mid block's."""
    cfg_j, params, encoder = vae_pair(7)
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 32, 32).astype(np.float32)
    mask_j = mask_t = None
    if masks:
        fg = (rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
        aug = (rs.rand(2, 1, 32, 32) > 0.2).astype(np.float32) if masks == "fg+aug" else None
        mask_j = {"fg_mask": jnp.asarray(fg), "aug_mask": None if aug is None else jnp.asarray(aug)}
        mask_t = {"fg_mask": _t(fg), "aug_mask": None if aug is None else _t(aug)}
    ref = jax.jit(lambda p, x, m: jvae.vae_encode_moments(p, x, cfg_j, mask=m))(
        params, x, mask_j)
    with torch.inference_mode():
        out = tvae.vae_encode_moments(encoder, _t(x), mask_t)
        unmasked = encoder(_t(x))
    assert out.shape == (2, 8, 8, 8) and out.is_contiguous()
    assert_close_rel(out.numpy(), ref)
    assert torch.equal(out, unmasked) == (masks is None)  # the masks reach the attention
    # {'fg_mask': None} is the unmasked encoder, as in the JAX package
    with torch.inference_mode():
        assert torch.equal(encoder(_t(x), {"fg_mask": None}), unmasked)


@pytest.mark.parametrize("case", ["mode", "sample", "kl", "encode", "encode scale shift"])
def test_vae_gaussian_and_encode_match_jax(case):
    """`gaussian_sample` (mode, and a sample with the draw JAX makes from its
    key handed in), `gaussian_kl`, and `vae_encode` with its scale and shift."""
    cfg_j, params, encoder = vae_pair(8)
    rs = np.random.RandomState(8)
    moments = (rs.randn(2, 8, 4, 4) * 3.0).astype(np.float32)
    moments[0, 4:, 0, 0] = [40.0, -50.0, 25.0, -31.0]  # past the clip of logvar at -30, 20
    key = jax.random.PRNGKey(8)
    if case == "mode":
        out, ref = tvae.gaussian_sample(_t(moments)), jvae.gaussian_sample(jnp.asarray(moments))
    elif case == "sample":
        noise = np.asarray(jax.random.normal(key, (2, 4, 4, 4), jnp.float32))
        out = tvae.gaussian_sample(_t(moments), noise=_t(noise))
        ref = jvae.gaussian_sample(jnp.asarray(moments), key)
        own = tvae.gaussian_sample(_t(moments), generator=torch.Generator().manual_seed(1))
        assert own.shape == out.shape and not torch.equal(own, out)
    elif case == "kl":
        out, ref = tvae.gaussian_kl(_t(moments)), jvae.gaussian_kl(jnp.asarray(moments))
        assert out.shape == (2,)
    else:
        x = rs.randn(1, 3, 32, 32).astype(np.float32)
        kw = dict(scale=1.5305, shift=0.0609) if "shift" in case else {}
        noise = np.asarray(jax.random.normal(key, (1, 4, 8, 8), jnp.float32))
        ref = jax.jit(lambda p, x: jvae.vae_encode(p, x, cfg_j, rng=key, **kw))(params, x)
        with torch.inference_mode():
            out = tvae.vae_encode(encoder, _t(x), noise=_t(noise), **kw)
            mode = tvae.vae_encode(encoder, _t(x), **kw)
        assert_close_rel(mode.numpy(), jax.jit(
            lambda p, x: jvae.vae_encode(p, x, cfg_j, **kw))(params, x))
    assert_close_rel(out.numpy(), ref)


@pytest.mark.parametrize("which", ["unet", "vae", "vae_encoder"])
def test_models_keep_channels_last_into_every_group_norm(which):
    """Inside, the UNet, the VAE decoder and the VAE encoder keep their maps
    in channels-last memory: every GroupNorm gets what its kernels take
    (`fused_gn._check`), the convolution weights are converted once, and a
    plain contiguous tensor goes in and comes out."""
    from adaface_tpu_torch.ops import fused_gn as tgn

    if which == "unet":
        model = tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)).eval()
        args = (torch.randn(2, 4, 16, 16), torch.tensor([3, 700]), torch.randn(2, 77, D))
        n_norms = 61
    elif which == "vae":
        model = tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)).eval()
        args = (torch.randn(1, 4, 16, 16),)
        n_norms = 18
    else:  # the padded copy before a stride-2 convolution keeps the layout
        model = tvae.VAEEncoder(tvae.VAEConfig(**VAE_KW)).eval()
        args = (torch.randn(1, 3, 32, 32),)
        n_norms = 12
    seen = []

    def check(mod, args):
        tgn._check(args[0], mod.groups)
        seen.append(args[0].shape)

    for m in model.modules():
        if isinstance(m, tgn.GroupNorm):
            m.register_forward_pre_hook(check)
    with torch.inference_mode():
        out = model(*args)
    assert len(seen) == n_norms
    assert out.is_contiguous()
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.permute(0, 2, 3, 1).is_contiguous() for m in convs)


def test_unet_forward_concatenates_no_weights():
    """q, k and v are one weight (k and v in cross-attention): a forward
    call's concatenations are the timestep embedding's and the skip
    connections', never a parameter's. The bridge stacks the JAX tree's
    separate leaves; the embedding's frequencies are an fp32 buffer outside
    the state dict that survives a cast of the module."""
    cfg_j, cfg_t = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 9)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    keys = set(model.state_dict())
    assert not any(k.endswith((".k.weight", ".v.weight")) for k in keys)
    assert sum(k.endswith("attn1.qkv.weight") for k in keys) == 16
    assert sum(k.endswith("attn2.kv.weight") for k in keys) == 16
    attn = model.mid["attention"].block.attn1
    leaf = params["mid"]["attention"]["block"]["attn1"]
    np.testing.assert_array_equal(
        attn.qkv.weight.detach().numpy(),
        np.concatenate([np.asarray(leaf[n]["w"]).T for n in "qkv"], axis=0))

    param_ptrs = {p.data_ptr() for p in model.parameters()}
    cats = []
    real_cat = torch.cat

    def spy(tensors, *a, **kw):
        cats.append([t.data_ptr() in param_ptrs or isinstance(t, torch.nn.Parameter)
                     for t in tensors])
        return real_cat(tensors, *a, **kw)

    args = (torch.randn(2, 4, 16, 16), torch.tensor([3, 700]), torch.randn(2, 77, D))
    with mock.patch.object(torch, "cat", spy), torch.inference_mode():
        model(*args)
    assert len(cats) == 1 + 12 and not any(any(c) for c in cats)

    assert "time_freqs" not in keys and model.time_freqs.dtype == torch.float32
    np.testing.assert_array_equal(model.time_freqs.numpy(), tunet.timestep_freqs(16).numpy())
    from adaface_tpu_torch.core.params import build
    half = build(lambda: tunet.UNet2DConditionModel(cfg_t), "cpu", torch.bfloat16,
                 tunet.init_unet_weights_, torch.Generator().manual_seed(0))
    assert half.conv_in.weight.dtype == torch.bfloat16 and half.time_freqs.dtype == torch.float32
    np.testing.assert_array_equal(half.time_freqs.numpy(), model.time_freqs.numpy())
    with pytest.raises(ValueError, match="time_freqs"):
        model.to(torch.bfloat16)(args[0], args[1], args[2].to(torch.bfloat16))


def test_fused_projection_draws_its_parts_apart():
    """A fused q/k/v weight is drawn part by part, so a seed gives it the
    values it gave the separate projections."""
    from adaface_tpu_torch.core.params import init_fan_in_

    fused = tunet.FusedLinear(8, 8, parts=3)
    apart = torch.nn.ModuleList(torch.nn.Linear(8, 8, bias=False) for _ in range(3))
    init_fan_in_(fused, torch.Generator().manual_seed(3))
    init_fan_in_(apart, torch.Generator().manual_seed(3))
    assert torch.equal(fused.weight, torch.cat([m.weight for m in apart], dim=0))


@pytest.mark.parametrize("cfg_scale", [1.0, 0.8])
def test_subj_basis_generator_matches_jax(cfg_scale):
    cfg_j = JSBGConfig(output_dim=D, clip=jclip.CLIPTextConfig(**TEXT_KW))
    cfg_t = SubjBasisConfig(clip=tclip.CLIPTextConfig(**TEXT_KW))
    sbg = init_subj_basis_generator(
        jax.random.PRNGKey(3), cfg_j, tokenizer=JTokenizer.character_fallback(),
        clip_text_params=numpy_params(lambda k: jclip.init_text_params(k, cfg_j.clip), 3))
    model = bridge.load(SubjBasisGenerator(cfg_t, CLIPTokenizer.character_fallback()),
                        bridge.sbg_tree(sbg))
    np.testing.assert_array_equal(model.template_ids, np.asarray(sbg["buffers"]["template_ids"]))
    assert model.id_start == int(sbg["buffers"]["id_start"])
    np.testing.assert_allclose(model.pad_embeddings().detach().numpy(),
                               np.asarray(sbg["buffers"]["pad_embeddings"]), atol=1e-7)
    embs = np.random.RandomState(3).randn(2, 16, D).astype(np.float32)
    ref = jax.jit(lambda e: subj_basis_forward(sbg, e, cfg_j,
                                               out_id_embs_cfg_scale=cfg_scale))(embs)
    with torch.inference_mode():
        out = model(_t(embs), out_id_embs_cfg_scale=cfg_scale)
    assert_close_rel(out.numpy(), ref)


@pytest.fixture(scope="module")
def arc2face_pair():
    text_cfg_j = jclip.CLIPTextConfig(**TEXT_KW)
    jenc = JArc2Face(
        jax.random.PRNGKey(4), tokenizer=JTokenizer.character_fallback(),
        face_backend=JBackend(), clip_vision_cfg=TINY_VISION, sbg_clip_cfg=text_cfg_j,
        text_cfg=text_cfg_j, output_dim=D,
        text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_cfg_j), 4),
        clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, TINY_VISION), 5))
    tok = CLIPTokenizer.character_fallback()
    text_cfg = tclip.CLIPTextConfig(**TEXT_KW)
    te = bridge.load(tclip.CLIPTextModel(text_cfg), jenc.text_encoder_params)
    sbg = bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_cfg), tok),
                      bridge.sbg_tree(jenc.subj_basis_generator))
    return jenc, Arc2FaceID2AdaPrompt(te, sbg, tok, face_backend=DeterministicBackend())


@pytest.mark.parametrize("source,cfg_scale", [("face_id_embs", 1.0), ("images", 0.7)])
def test_arc2face_ada_embeddings_match_jax(arc2face_pair, source, cfg_scale):
    jenc, tenc = arc2face_pair
    jenc.out_id_embs_cfg_scale = tenc.out_id_embs_cfg_scale = cfg_scale
    rs = np.random.RandomState(4)
    if source == "images":
        imgs = [rs.randint(0, 255, (64, 64, 3), np.uint8) for _ in range(2)]
        kw_j = kw_t = dict(images=imgs)
    else:
        fid = rs.randn(1, 512).astype(np.float32)
        kw_j, kw_t = dict(face_id_embs=jnp.asarray(fid)), dict(face_id_embs=_t(fid))
    ref, ref_prompt, lens_j = jenc.generate_adaface_embeddings(**kw_j)
    ada, prompt, lens_t = tenc.generate_adaface_embeddings(**kw_t)
    assert ada.shape == (16, D) and lens_t == lens_j
    assert_close_rel(prompt.numpy(), ref_prompt)
    assert_close_rel(ada.numpy(), ref)


def test_deterministic_backend_matches_jax():
    img = np.random.RandomState(5).randint(0, 255, (32, 32, 3), np.uint8)
    np.testing.assert_array_equal(DeterministicBackend().detect_and_embed(img),
                                  JBackend().detect_and_embed(img))
    assert DeterministicBackend(always_detect=False).detect_and_embed(img * 0) is None
