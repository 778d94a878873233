"""The ID encoders of the PyTorch port against the JAX package, on the CPU.

The CLIP vision tower, the projection layers of `id2ada/layers.py`, every
branch of the SubjBasisGenerator, ConsistentID and the joint encoder get
params in the JAX tree layout from numpy seeds
(`tests/test_torch_models.py:numpy_params`) or from the JAX initialisers at
tiny widths, carried over by the bridge, and the same numpy inputs, in
fp32. Draws that JAX makes from its keys (the random-ID path, the
perturbations, the joint encoder's dropout) are made by the test from the
same keys, in the order the JAX code splits them, and handed to the port.

Tolerance: 1e-4 relative to the output's largest magnitude (fp32 sums over
a few layers, in another order). CLIP features are compared on 224² images:
at other sizes the bicubic resize of OpenCV and of the port differ by one
level at about 1e-5 of the values, which moves a single image's features
by up to 3e-4 of their scale at these widths, and its ada embeddings, which
are compared there, by 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada import layers as jL
from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.id2ada.face_id_to_ada_prompt import ConsistentIDID2AdaPrompt as JConsistentID
from adaface_tpu.id2ada.face_id_to_ada_prompt import JointFaceID2AdaPrompt as JJoint
from adaface_tpu.id2ada.subj_basis_generator import (SubjBasisConfig as JSBGConfig,
                                                     init_subj_basis_generator,
                                                     inverse_img_prompt_embs,
                                                     subj_basis_forward)
from adaface_tpu.models import clip as jclip
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.utils.tensor import perturb_tensor as jperturb
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada import layers as tL
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import (Arc2FaceID2AdaPrompt,
                                                            ConsistentIDID2AdaPrompt,
                                                            JointFaceID2AdaPrompt,
                                                            create_id2ada_prompt_encoder)
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.utils.tensor import Draws, perturb_tensor
from tests.test_torch_models import D, TEXT_KW, TINY_VISION, assert_close_rel, numpy_params

VISION_KW = dict(hidden_size=D, num_layers=2, num_heads=2, intermediate_size=128,
                 image_size=224, patch_size=32)
# ConsistentID's tower at tiny width: gelu and a projection, as CLIP-H has
CID_VISION = dict(VISION_KW, projection_dim=32, hidden_act="gelu")
PERTURB_STD = 0.3


def _t(a):
    return torch.from_numpy(np.array(a))


def images(seed: int, n: int, hw=(64, 64)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (*hw, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("mask,proj,act", [
    (None, True, "quick_gelu"), ("soft_pair", False, "quick_gelu"), ("hard", True, "gelu"),
    ("soft_pair", True, "gelu"), (None, False, "gelu"), ("hard", False, "quick_gelu")])
def test_vision_tower_matches_jax(mask, proj, act):
    kw = dict(VISION_KW, projection_dim=32 if proj else None, hidden_act=act)
    cfg_j, cfg_t = jclip.CLIPVisionConfig(**kw), tclip.CLIPVisionConfig(**kw)
    params = numpy_params(lambda k: jclip.init_vision_params(k, cfg_j), 50)
    model = bridge.load(tclip.CLIPVisionModel(cfg_t), params)
    rs = np.random.RandomState(50)
    px = rs.randn(2, 3, 224, 224).astype(np.float32)
    m = None if mask is None else (rs.rand(2, 28, 28) > 0.4).astype(np.float32)
    ref = jax.jit(lambda p, x, m: jclip.vision_encode(
        p, x, cfg_j, image_mask=m, mask_mode=mask or "soft_pair",
        return_hidden_states=True))(params, px, m)
    with torch.inference_mode():
        out = model(_t(px), image_mask=None if m is None else _t(m)[:, None],
                    mask_mode=mask or "soft_pair", return_hidden_states=True)
    assert out["last_hidden_state"].shape == (2, cfg_t.num_tokens, D)
    for key in ("last_hidden_state", "pooled") + (("image_embeds",) if proj else ()):
        assert_close_rel(out[key].numpy(), ref[key])
    assert ("image_embeds" in out) == proj
    for h, r in zip(out["hidden_states"], ref["hidden_states"]):
        assert_close_rel(h.numpy(), r)
    if mask is None:
        assert out["token_mask"] is None and ref["token_mask"] is None
    else:
        np.testing.assert_array_equal(out["token_mask"].numpy(), ref["token_mask"])


def _layer_case(name: str):
    """→ (JAX fn(params, *inputs), params, port module, inputs)."""
    rs = np.random.RandomState(51)
    x = rs.randn(2, 7, D).astype(np.float32)
    lat = rs.randn(2, 5, D).astype(np.float32)
    if name == "expand_embs":
        p = numpy_params(lambda k: jL.init_expand_embs(k, 48, D, 3), 51)
        return jL.apply_expand_embs, p, tL.ExpandEmbs(48, D, 3), (rs.randn(2, 48),)
    if name == "cross_attention":
        p = numpy_params(lambda k: jL.init_cross_attention(k, D, num_heads=4), 52)
        return (lambda p, q, c: jL.apply_cross_attention(p, q, c, num_heads=4), p,
                tL.CrossAttention(D, 4), (lat, x))
    if name == "cross_attention_identity_v_out_skip":
        p = numpy_params(lambda k: jL.init_cross_attention(
            k, D, num_heads=4, identity_to_v=True, identity_to_out=False), 53)
        return (lambda p, q, c: jL.apply_cross_attention(p, q, c, num_heads=4,
                                                         out_has_skip=True), p,
                tL.CrossAttention(D, 4, identity_to_v=True, identity_to_out=False,
                                  out_has_skip=True), (lat, x))
    if name == "perceiver_attention":
        p = numpy_params(lambda k: jL.init_perceiver_attention(k, D, 16, 4), 54)
        return (lambda p, x, l: jL.apply_perceiver_attention(p, x, l, 4, 16), p,
                tL.PerceiverAttention(D, 16, 4), (x, lat))
    if name == "soft_aggregate":
        p = numpy_params(lambda k: jL.init_learned_soft_aggregate(k, D), 55)
        return jL.apply_learned_soft_aggregate, p, tL.LearnedSoftAggregate(D), (x,)
    p = numpy_params(lambda k: jL.init_proj_plus(k, 512, 48, D, 4, depth=2), 56)
    shortcut = name == "proj_plus_shortcut"
    return (lambda p, f, c: jL.apply_proj_plus(p, f, c, shortcut=shortcut, scale=0.7), p,
            tL.ProjPlus(512, 48, D, 4, depth=2),
            (rs.randn(2, 512), rs.randn(2, 9, 48)))


@pytest.mark.parametrize("name", ["expand_embs", "cross_attention",
                                  "cross_attention_identity_v_out_skip",
                                  "perceiver_attention", "soft_aggregate", "proj_plus",
                                  "proj_plus_shortcut"])
def test_layers_match_jax(name):
    fn, params, module, inputs = _layer_case(name)
    inputs = [np.asarray(a, np.float32) for a in inputs]
    model = bridge.load(module, params)
    ref = fn(params, *inputs)
    with torch.inference_mode():
        if name.startswith("proj_plus"):
            out = model(*map(_t, inputs), shortcut=name.endswith("shortcut"), scale=0.7)
        else:
            out = model(*map(_t, inputs))
    assert_close_rel(out.numpy(), ref)


def _sbg_pair(cfg_j, cfg_t, seed):
    tok_j, tok_t = JTokenizer.character_fallback(), CLIPTokenizer.character_fallback()
    if cfg_j.placeholder_is_bg:
        sbg = numpy_params(lambda k: init_subj_basis_generator(k, cfg_j, tokenizer=tok_j), seed)
    else:
        sbg = init_subj_basis_generator(
            jax.random.PRNGKey(seed), cfg_j, tokenizer=tok_j,
            clip_text_params=numpy_params(lambda k: jclip.init_text_params(k, cfg_j.clip),
                                          seed))
    return sbg, bridge.load(SubjBasisGenerator(cfg_t, tok_t), bridge.sbg_tree(sbg))


@pytest.mark.parametrize("branch", ["static_suffix", "non_face", "emb_types", "background",
                                    "layerwise"])
def test_sbg_branches_match_jax(branch):
    text_j, text_t = jclip.CLIPTextConfig(**TEXT_KW), tclip.CLIPTextConfig(**TEXT_KW)
    kw = dict(num_id_vecs=4, num_static_img_suffix_embs=2)
    if branch == "background":
        kw = dict(placeholder_is_bg=True, bg_image_embedding_dim=48, num_bg_encoder_heads=4,
                  num_out_embs_bg=8)
    elif branch == "layerwise":
        kw = dict(num_id_vecs=4, use_layerwise_proj=True, layerwise_num_layers=3)
    cfg_j = JSBGConfig(output_dim=D, clip=text_j, **kw)
    cfg_t = SubjBasisConfig(output_dim=D, clip=text_t, **kw)
    sbg, model = _sbg_pair(cfg_j, cfg_t, 57)
    rs = np.random.RandomState(57)
    face = rs.randn(2, 4, D).astype(np.float32)
    with torch.inference_mode():
        if branch == "static_suffix":
            ref = subj_basis_forward(sbg, face, cfg_j, out_id_embs_cfg_scale=0.8,
                                     enable_static_img_suffix_embs=True)
            out = model(_t(face), 0.8, enable_static_img_suffix_embs=True)
            assert out.shape == (2, 6, D)
        elif branch == "non_face":
            raw = rs.randn(2, 384).astype(np.float32)
            ref = subj_basis_forward(sbg, None, cfg_j, raw_id_embs=raw, is_face=False,
                                     out_id_embs_cfg_scale=0.5)
            out = model(None, 0.5, raw_id_embs=_t(raw), is_face=False)
        elif branch == "emb_types":
            types = ("core", "full", "full_pad", "full_half_pad")
            refs = inverse_img_prompt_embs(
                sbg, cfg_j, face, types,
                hidden_state_layer_weights=sbg["params"]["hidden_state_layer_weights"],
                enable_static_img_suffix_embs=True)
            outs = model.inverse_img_prompt_embs(_t(face), types,
                                                 enable_static_img_suffix_embs=True)
            for o, r in zip(outs[1:], refs[1:]):
                assert_close_rel(o.numpy(), r)
            out, ref = outs[0], refs[0]
            with pytest.raises(ValueError, match="unknown emb type"):
                model.inverse_img_prompt_embs(_t(face), ("half",))
        elif branch == "background":
            feats = rs.randn(2, 257, 48).astype(np.float32)
            ref = subj_basis_forward(sbg, None, cfg_j, clip_features=feats)
            out = model(clip_features=_t(feats))
            assert out.shape == (2, 8, D)
        else:
            ref = subj_basis_forward(sbg, face, cfg_j, out_id_embs_cfg_scale=0.8)
            out = model(_t(face), 0.8)
            assert out.shape == (2, 3, 4, D)
    assert_close_rel(out.numpy(), ref)


@pytest.fixture(scope="module")
def encoders():
    """(JAX Arc2Face, ConsistentID), (port Arc2Face, ConsistentID) on the
    same tiny weights; each side with its own tokenizer."""
    text_j, text_t = jclip.CLIPTextConfig(**TEXT_KW), tclip.CLIPTextConfig(**TEXT_KW)
    jtok, ttok = JTokenizer.character_fallback(), CLIPTokenizer.character_fallback()
    vis_j = jclip.CLIPVisionConfig(**CID_VISION)
    jarc = JArc2Face(
        jax.random.PRNGKey(4), tokenizer=jtok, face_backend=JBackend(),
        clip_vision_cfg=TINY_VISION, sbg_clip_cfg=text_j, text_cfg=text_j, output_dim=D,
        text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_j), 58),
        clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, TINY_VISION), 59))
    jcid = JConsistentID(
        jax.random.PRNGKey(5), tokenizer=jtok, face_backend=JBackend(), clip_vision_cfg=vis_j,
        sbg_clip_cfg=text_j, output_dim=D,
        clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, vis_j), 60),
        image_proj_params=numpy_params(lambda k: jL.init_proj_plus(k, 512, D, D, 4), 61))
    tarc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jarc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), ttok),
                    bridge.sbg_tree(jarc.subj_basis_generator)),
        ttok, face_backend=DeterministicBackend())
    tcid = ConsistentIDID2AdaPrompt(
        bridge.load(tclip.CLIPVisionModel(tclip.CLIPVisionConfig(**CID_VISION)),
                    jcid.clip_vision_params),
        bridge.load(tL.ProjPlus(512, D, D, 4), jcid.image_proj_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(num_id_vecs=4, clip=text_t), ttok),
                    bridge.sbg_tree(jcid.subj_basis_generator)),
        face_backend=DeterministicBackend())
    assert tcid.out_id_embs_cfg_scale == jcid.out_id_embs_cfg_scale == 6.0
    return (jarc, jcid), (tarc, tcid)


N_TOK = 2 * tclip.CLIPVisionConfig(**CID_VISION).num_tokens


@pytest.mark.parametrize("source", ["images", "images+masks", "ids+features"])
def test_consistentid_prompts_match_jax(encoders, source):
    """Positive and negative image prompts, and (from images) the ada
    embeddings at the encoder's CFG scale 6."""
    (_, jcid), (_, tcid) = encoders
    rs = np.random.RandomState(62)
    if source == "ids+features":
        ids = rs.randn(2, 512).astype(np.float32)
        feats = rs.randn(2, N_TOK, D).astype(np.float32)
        ref = jcid.get_img_prompt_embs(init_id_embs=jnp.asarray(ids),
                                       pre_clip_features=jnp.asarray(feats), id_batch_size=2)
        out = tcid.get_img_prompt_embs(init_id_embs=_t(ids), pre_clip_features=_t(feats),
                                       id_batch_size=2)
        for o, r in zip(out[1:], ref[1:]):
            assert_close_rel(o.numpy(), r)
        return
    imgs = images(62, 2, (224, 224))  # no resize: the features are compared
    masks = ([(rs.rand(80, 96) > 0.5).astype(np.float32) for _ in imgs]
             if source == "images+masks" else None)
    _, _, feats_j = jcid.extract_init_id_embeds_from_images(imgs, fg_masks=masks)
    _, _, feats_t = tcid.extract_init_id_embeds_from_images(imgs, fg_masks=masks)
    assert feats_t.shape == (2, N_TOK, D)
    assert_close_rel(feats_t.numpy(), feats_j)
    ref = jcid.generate_adaface_embeddings(images=imgs, fg_masks=masks)
    out = tcid.generate_adaface_embeddings(images=imgs, fg_masks=masks)
    assert out[0].shape == (4, D) and out[2] == ref[2] == [4]
    assert_close_rel(out[1].numpy(), ref[1])
    assert_close_rel(out[0].numpy(), ref[0])
    neg_j = jcid.get_img_prompt_embs(images=imgs, avg_at_stage="id_emb")[3]
    neg_t = tcid.get_img_prompt_embs(images=imgs, avg_at_stage="id_emb")[3]
    assert_close_rel(neg_t.numpy(), neg_j)
    if masks is None:  # through the bicubic resize, to the ada embeddings
        imgs = images(62, 2, (80, 96))
        ref = jcid.generate_adaface_embeddings(images=imgs)
        out = tcid.generate_adaface_embeddings(images=imgs)
        assert_close_rel(out[0].numpy(), ref[0])


@pytest.mark.parametrize("avg", ["id_emb", "img_prompt_emb", None])
def test_joint_encoder_matches_jax(encoders, avg):
    (jarc, jcid), (tarc, tcid) = encoders
    jj, tj = JJoint(jax.random.PRNGKey(0), encoders=[jarc, jcid]), JointFaceID2AdaPrompt(
        [tarc, tcid])
    assert tj.num_id_vecs == jj.num_id_vecs == 20
    imgs = images(63, 2)
    ref = jj.generate_adaface_embeddings(images=imgs, avg_at_stage=avg)
    out = tj.generate_adaface_embeddings(images=imgs, avg_at_stage=avg)
    assert out[0].shape == ((20, D) if avg else (2, 20, D))
    assert out[2] == ref[2] == [16, 4]
    assert_close_rel(out[0].numpy(), ref[0])
    for o, r in zip(out[1], ref[1]):
        assert_close_rel(o.numpy(), r)
    # the batched image prompts, and a negative prompt of zeros for Arc2Face
    ids = [jnp.asarray(np.random.RandomState(64).randn(1, 512), jnp.float32)] * 2
    feats = jnp.asarray(np.random.RandomState(65).randn(1, N_TOK, D), jnp.float32)
    ref = jj.get_batched_img_prompt_embs(3, ids, [None, feats])
    out = tj.get_batched_img_prompt_embs(3, [_t(a) for a in ids], [None, _t(feats)])
    assert out[2].shape == (3, 20, D)
    assert_close_rel(out[2].numpy(), ref[2])
    assert_close_rel(out[3].numpy(), ref[3])
    assert not out[3][:, :16].any()


def _draws_single(key, stage, shapes):
    """The JAX single encoder's draws from `key`: (the random-ID path's
    from its halves), then one per perturbation, each from a fresh split."""
    out = []
    if "random" in shapes:
        k1, k2 = jax.random.split(key)
        out += [jax.random.normal(k1, shapes["random"][0]),
                jax.random.normal(k2, shapes["random"][1])]
    for shape in shapes.get(stage, ()):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, shape))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("source,stage", [("random", None), ("random", "id_emb"),
                                          ("images", "id_emb"),
                                          ("images", "img_prompt_emb")])
def test_random_id_and_perturbation_match_jax(encoders, source, stage):
    """ConsistentID (ID embeddings and CLIP features) with JAX's draws
    handed over: the random-ID path (avg None), perturbation at the ID
    embeddings or at the image prompts (averaged over 2 images)."""
    (_, jcid), (_, tcid) = encoders
    key = jax.random.PRNGKey(66)
    avg = None if source == "random" else "id_emb"
    kw = dict(avg_at_stage=avg, perturb_at_stage=stage, perturb_std=PERTURB_STD)
    shapes = {"id_emb": [(1, 512), (1, 514 if source == "random" else N_TOK, D)],
              "img_prompt_emb": [(1, 4, D)]}
    if source == "random":
        shapes["random"] = [(1, 512), (1, 514, D)]
        ref = jcid.generate_adaface_embeddings(rng=key, **kw)
        out = tcid.generate_adaface_embeddings(rng=_draws_single(key, stage, shapes), **kw)
    else:
        imgs = images(67, 2)
        ref = jcid.generate_adaface_embeddings(images=imgs, rng=key, **kw)
        out = tcid.generate_adaface_embeddings(images=imgs, rng=_draws_single(key, stage, shapes),
                                               **kw)
    plain = tcid.generate_adaface_embeddings(
        images=None if source == "random" else imgs, avg_at_stage=avg,
        rng=_draws_single(key, None, shapes))
    assert_close_rel(out[1].numpy(), ref[1])
    assert_close_rel(out[0].numpy(), ref[0])
    assert (stage is None) == torch.allclose(out[0], plain[0])


def test_joint_dropout_matches_jax(encoders):
    """In training each encoder is dropped with its probability (JAX's
    `bernoulli` is a uniform draw under p), never both; a dropped encoder
    gives zero rows."""
    (jarc, jcid), (tarc, tcid) = encoders
    jj = JJoint(jax.random.PRNGKey(0), encoders=[jarc, jcid], is_training=True)
    tj = JointFaceID2AdaPrompt([tarc, tcid], is_training=True)
    imgs = images(68, 1)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        draws = []
        for _ in range(2):
            key, sub = jax.random.split(key)
            draws.append(float(jax.random.uniform(sub)))
            assert bool(jax.random.bernoulli(sub, 0.99)) == (draws[-1] < 0.99)
        draws.append(float(jax.random.uniform(key)))
        ref = jj.generate_adaface_embeddings(images=imgs, p_dropout=0.99,
                                             rng=jax.random.PRNGKey(seed))
        out = tj.generate_adaface_embeddings(images=imgs, p_dropout=0.99, rng=draws)
        assert out[0].shape == (20, D) and out[2] == ref[2] == [16, 4]
        zero = (out[0].abs().sum(-1) == 0).sum().item()
        assert zero in (4, 16)
        assert_close_rel(out[0].numpy(), ref[0])


def test_faceless_images_get_the_seeded_embedding(encoders):
    """skip_non_faces=False: an image without a face gets numpy's
    RandomState(0) unit embedding, and its CLIP features are kept."""
    (_, jcid), (_, tcid) = encoders
    imgs = [np.zeros((64, 64, 3), np.uint8)] + images(69, 1)
    jb, tb = jcid.face_backend, tcid.face_backend
    try:
        jcid.face_backend, tcid.face_backend = JBackend(False), DeterministicBackend(False)
        ref = jcid.extract_init_id_embeds_from_images(imgs, skip_non_faces=False)
        out = tcid.extract_init_id_embeds_from_images(imgs, skip_non_faces=False)
        skipped = tcid.extract_init_id_embeds_from_images(imgs)
    finally:
        jcid.face_backend, tcid.face_backend = jb, tb
    assert out[0] == ref[0] == 1 and skipped[1].shape == (1, 512)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-7)
    assert_close_rel(out[2].numpy(), ref[2])


@pytest.mark.parametrize("keep_norm,relative", [(True, True), (False, True), (True, False)])
def test_perturb_tensor_matches_jax(keep_norm, relative):
    key = jax.random.PRNGKey(70)
    x = np.random.RandomState(70).randn(3, 5, 8).astype(np.float32)
    noise = np.asarray(jax.random.normal(key, x.shape))
    ref = jperturb(key, jnp.asarray(x), 0.2, std_is_relative=relative, keep_norm=keep_norm)
    out = perturb_tensor(_t(x), 0.2, noise=_t(noise), std_is_relative=relative,
                         keep_norm=keep_norm)
    assert_close_rel(out.numpy(), ref, rtol=1e-6)
    xt = _t(x)
    assert perturb_tensor(xt, 0.0, _t(noise)) is xt
    with pytest.raises(ValueError, match="shape"):
        Draws(handed=[noise]).normal((2, 2), "cpu")


def test_create_encoders_by_name_on_the_cpu():
    """`create_id2ada_prompt_encoder` builds each encoder with random
    weights; tiny configs keep it quick."""
    tok = CLIPTokenizer.character_fallback()
    text = tclip.CLIPTextConfig(**TEXT_KW)
    joint = create_id2ada_prompt_encoder(
        "jointIDs", torch.Generator().manual_seed(0), tok, "cpu",
        arc2face_kw=dict(text_cfg=text, sbg_cfg=SubjBasisConfig(clip=text)),
        consistentid_kw=dict(vision_cfg=tclip.CLIPVisionConfig(**CID_VISION),
                             sbg_cfg=SubjBasisConfig(num_id_vecs=4, clip=text), proj_depth=1))
    assert isinstance(joint, JointFaceID2AdaPrompt) and joint.num_id_vecs == 20
    ada, _, lens = joint.generate_adaface_embeddings(images=images(71, 2))
    assert ada.shape == (20, D) and lens == [16, 4] and torch.isfinite(ada).all()
    with pytest.raises(ValueError, match="unknown id2ada encoder"):
        create_id2ada_prompt_encoder("insightface", device="cpu")
