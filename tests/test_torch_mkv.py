"""MKV attention and the MKV-extended prompt2token_proj, the port against the
JAX package on the CPU in fp32.

The CLIP tower at per-layer K/V multipliers 1, 2 and 3 (`_mkv_attention`:
the copies token-interleaved, the causal and additive biases repeated per
key), causal and with `attn_bias`, at 1e-5; `extend_mkv` with JAX's draws
handed over (JAX's noise transposed: its weights are [in, out]) equal to
JAX's extension; `squeeze_mkv ∘ extend_mkv` without noise the identity;
`layer_multipliers`; the SubjBasisGenerator's extend and squeeze;
`load_adaface_ckpt(want_mkv_multipliers=...)` re-extending and squeezing;
`Trainer.load(extend_mkv_multiplier=2)` against the JAX trainer's `load` on
a checkpoint each package wrote of the same weights; and an MKV checkpoint
served: through `scripts/_common_torch.load_adaface` and
`AdaFaceWrapper.load_adaface_ckpt`, the ada embeddings against the JAX
wrapper's with the same extension.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaface_tpu.id2ada import subj_basis_generator as jsbg
from adaface_tpu.models import clip as jclip
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.train import checkpoint as jckpt
from adaface_tpu.train import train_step as jstep
from adaface_tpu.train import trainer as jtrainer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada import subj_basis_generator as tsbg
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.train import checkpoint as tckpt
from adaface_tpu_torch.utils.tensor import Draws
from tests.test_torch_models import TEXT_KW, numpy_params, one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
KW3 = dict(TEXT_KW, num_layers=3)
D = TEXT_KW["hidden_size"]


def assert_rel(out, ref, rtol=RTOL, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: max error {err:.3e} of the largest |ref|"


def jax_noise(layers, key, multipliers) -> list[np.ndarray]:
    """The normals JAX's `extend_mkv(.., key, multipliers)` draws, in its
    order, transposed to the port's [out, in] layout."""
    out = []
    for i, lp in enumerate(layers):
        mult = multipliers[i] if i < len(multipliers) else 1
        if mult == 1:
            continue
        for name in ("k", "v"):
            w = lp["attn"][name]["w"]
            key, sub = jax.random.split(key)
            shape = (w.shape[0], (mult - 1) * w.shape[1])
            out.append(np.asarray(jax.random.normal(sub, shape, w.dtype)).T)
    return out


@pytest.fixture(scope="module")
def text_params():
    return numpy_params(lambda k: jclip.init_text_params(k, jclip.CLIPTextConfig(**KW3)), 40)


def test_mkv_tower_matches_jax(text_params):
    """The causal text tower at multipliers [1, 2, 3] (the bridge builds each
    layer at its tree's width); one layer at 2 and at 3 with an additive bias,
    causal and not."""
    key = jax.random.PRNGKey(41)
    ext = jclip.extend_mkv(text_params, key, [1, 2, 3])
    cfg_j, cfg_t = jclip.CLIPTextConfig(**KW3), tclip.CLIPTextConfig(**KW3)
    model = bridge.load(tclip.CLIPTextModel(cfg_t), ext)
    assert [layer.kv_mult for layer in model.layers] == [1, 2, 3]
    rs = np.random.RandomState(42)
    ids = rs.randint(0, cfg_j.vocab_size, (2, 77)).astype(np.int32)
    ref = jax.jit(lambda p: jclip.text_encode(p, ids, cfg_j)["last_hidden_state"])(ext)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).long())
    assert_rel(out.numpy(), ref, what="tower")
    x = rs.randn(2, 9, D).astype(np.float32)
    for mult, layer in ((2, 1), (3, 2)):
        for causal, bias in ((True, rs.randn(2, 1, 9, 9)), (False, rs.randn(2, 1, 1, 9) * 3)):
            bias = bias.astype(np.float32)
            lp = ext["layers"][layer]
            ref = jclip._encoder_layer(lp, jnp.asarray(x), cfg_j.num_heads, cfg_j.layer_norm_eps,
                                       jnp.asarray(bias), causal)
            with torch.inference_mode():
                got = model.layers[layer](torch.from_numpy(x), torch.from_numpy(bias), causal)
            assert_rel(got.numpy(), ref, what=f"layer mult {mult} causal {causal}")


def test_extend_mkv_handed_draws_match_jax(text_params):
    """On a state dict and on the module in place: JAX's extension, with its
    draws handed over; the biases repeated, unperturbed."""
    key, mults = jax.random.PRNGKey(43), [2, 1, 3]
    ext = jclip.extend_mkv(text_params, key, mults)
    want = bridge.state_dict(ext)
    model = bridge.load(tclip.CLIPTextModel(tclip.CLIPTextConfig(**KW3)), text_params)
    noise = jax_noise(text_params["layers"], key, mults)
    sd = tclip.extend_mkv(model.state_dict(), mults, Draws(handed=list(noise)))
    tclip.extend_mkv(model, mults, Draws(handed=list(noise)))
    for got in (sd, model.state_dict()):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    assert tclip.layer_multipliers(model) == mults


def test_squeeze_of_extend_is_the_identity(text_params):
    """Without noise, squeezing an extension gives the weights back exactly
    (multipliers 2 and 4: the means are exact); the port's squeeze of a
    perturbed extension equals JAX's."""
    model = bridge.load(tclip.CLIPTextModel(tclip.CLIPTextConfig(**KW3)), text_params)
    sd = model.state_dict()
    gen = Draws(generator=torch.Generator().manual_seed(0))
    back = tclip.squeeze_mkv(tclip.extend_mkv(sd, [2, 1, 4], gen, perturb_std=0.0), [2, 1, 4])
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    ext = jclip.extend_mkv(text_params, jax.random.PRNGKey(44), [3, 2, 1])
    want = bridge.state_dict(jclip.squeeze_mkv(ext, [3, 2, 1]))
    got = tclip.squeeze_mkv(bridge.state_dict(ext), [3, 2, 1])
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_layer_multipliers_match_jax(text_params):
    ext = jclip.extend_mkv(text_params, jax.random.PRNGKey(45), [3, 1, 2])
    want = jclip.layer_multipliers(ext, jclip.CLIPTextConfig(**KW3))
    model = bridge.load(tclip.CLIPTextModel(tclip.CLIPTextConfig(**KW3)), ext)
    assert tclip.layer_multipliers(model) == want == [3, 1, 2]
    assert tclip.layer_multipliers(bridge.state_dict(ext)) == want
    assert tclip.layer_multipliers({"clip." + k: v for k, v in model.state_dict().items()},
                                   prefix="clip.") == want


@pytest.fixture(scope="module")
def sbg_pair():
    cfg_j = jsbg.SubjBasisConfig(output_dim=D, clip=jclip.CLIPTextConfig(**KW3))
    cfg_t = tsbg.SubjBasisConfig(clip=tclip.CLIPTextConfig(**KW3))
    sbg = jsbg.init_subj_basis_generator(
        jax.random.PRNGKey(46), cfg_j, tokenizer=JTokenizer.character_fallback(),
        clip_text_params=numpy_params(lambda k: jclip.init_text_params(k, cfg_j.clip), 47))
    return (sbg, cfg_j), cfg_t


def port_sbg(sbg, cfg_t):
    return bridge.load(tsbg.SubjBasisGenerator(cfg_t, CLIPTokenizer.character_fallback()),
                       bridge.sbg_tree(sbg))


def sbg_forward_pair(jparams, cfg_j, model, seed=48):
    embs = np.random.RandomState(seed).randn(2, 16, D).astype(np.float32)
    ref = jax.jit(lambda e: jsbg.subj_basis_forward(jparams, e, cfg_j))(embs)
    with torch.inference_mode():
        out = model(torch.from_numpy(embs))
    return out.numpy(), np.asarray(ref)


def test_sbg_extend_and_squeeze_match_jax(sbg_pair):
    """`extend_prompt2token_proj_attention` in place on the module and into a
    state dict, then `squeeze_prompt2token_proj_attention`: the forward at
    1e-5 and the weights at 1e-6 against JAX's."""
    (sbg, cfg_j), cfg_t = sbg_pair
    key, mults = jax.random.PRNGKey(49), [2, 3, 1]
    ext = jsbg.extend_prompt2token_proj_attention(sbg, key, mults)
    noise = jax_noise(sbg["params"]["prompt2token_proj"]["layers"], key, mults)
    model = port_sbg(sbg, cfg_t)
    sd = tsbg.extend_prompt2token_proj_attention(model.state_dict(), mults,
                                                 Draws(handed=list(noise)))
    tsbg.extend_prompt2token_proj_attention(model, mults, Draws(handed=list(noise)))
    assert tclip.layer_multipliers(model.clip) == mults
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=0, err_msg=k)
    assert_rel(*sbg_forward_pair(ext, cfg_j, model), what="extended forward")
    sq = jsbg.squeeze_prompt2token_proj_attention(ext, mults)
    tsbg.squeeze_prompt2token_proj_attention(model, mults)
    assert tclip.layer_multipliers(model.clip) == [1, 1, 1]
    assert_rel(*sbg_forward_pair(sq, cfg_j, model), what="squeezed forward")


def trainable_sd(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()
            if k not in tsbg.DERIVED_SBG_KEYS}


def test_load_adaface_ckpt_extends_and_squeezes(sbg_pair, tmp_path):
    """The manifest's multipliers come from the widths; `want_mkv_multipliers`
    re-extends a single SubjBasisGenerator as JAX's `load_adaface_ckpt` does
    (its key split once, its draws handed over), squeezes back down, and
    treats a joint list member by member."""
    (sbg, _), cfg_t = sbg_pair
    model = port_sbg(sbg, cfg_t)
    out = tckpt.save_adaface_ckpt(str(tmp_path / "a"), 3, {"arc2face": trainable_sd(model)})
    _, manifest = tckpt.load_adaface_ckpt(out)
    assert manifest["mkv_multipliers"] == {"arc2face": [1, 1, 1]}
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    layers = sbg["params"]["prompt2token_proj"]["layers"]
    noise = jax_noise(layers, sub, [2, 2, 2])
    state, _ = tckpt.load_adaface_ckpt(out, {"arc2face": [2, 2, 2]}, Draws(handed=list(noise)))
    want = bridge.state_dict({"layers": jclip.extend_mkv({"layers": layers}, sub,
                                                         [2, 2, 2])["layers"]})
    got = state["subj_basis_generators"]["arc2face"]
    for k, v in want.items():
        np.testing.assert_allclose(got[f"clip.{k}"].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    out2 = tckpt.save_adaface_ckpt(str(tmp_path / "b"), 4, {"joint": [got, trainable_sd(model)]})
    state2, manifest2 = tckpt.load_adaface_ckpt(out2, {"joint": [[1, 1, 1], [1, 1, 1]]})
    assert manifest2["mkv_multipliers"] == {"joint": [[2, 2, 2], [1, 1, 1]]}
    squeezed, same = state2["subj_basis_generators"]["joint"]
    want_sq = tsbg.squeeze_prompt2token_proj_attention(got, [2, 2, 2])
    for k, v in want_sq.items():
        assert torch.equal(squeezed[k], v), k
    for k, v in trainable_sd(model).items():
        assert torch.equal(same[k], v), k


def test_trainer_load_extends_as_jax(sbg_pair, tmp_path):
    """`Trainer.load(extend_mkv_multiplier=2)` on the port's checkpoint
    against the JAX trainer's `load` (run on a stand-in holding its state
    and optimizer) on the JAX checkpoint of the same weights: the
    SubjBasisGenerator's weights at 1e-6, its forward at 1e-5, and the
    optimizer rebuilt over the extended parameters."""
    from tests.test_torch_trainer import make_trainer

    (sbg, cfg_j), cfg_t = sbg_pair
    trainer = make_trainer(tmp_path / "t")
    bridge.load(trainer.state.params["sbg"], bridge.sbg_tree(sbg))
    trainer.state = trainer._init_state(trainer.state.params)
    ck = trainer.save(5)
    jck = jckpt.save_adaface_ckpt(str(tmp_path / "j"), 5, {"joint": sbg["params"]})
    opt = optax.adam(1e-3)
    stand_in = types.SimpleNamespace(state=jstep.init_state({"sbg": sbg["params"]}, opt),
                                     optimizer=opt)
    assert jtrainer.Trainer.load(stand_in, jck, extend_mkv_multiplier=2) == 5
    jparams = stand_in.state.params["sbg"]
    noise = jax_noise(sbg["params"]["prompt2token_proj"]["layers"], jax.random.PRNGKey(0),
                      [2, 2, 2])
    assert trainer.load(ck, extend_mkv_multiplier=2, draws=Draws(handed=list(noise))) == 5
    model = trainer.state.params["sbg"]
    assert tclip.layer_multipliers(model.clip) == [2, 2, 2]
    want = bridge.state_dict(bridge.sbg_tree({"params": jparams, "buffers": sbg["buffers"]}))
    for k, v in trainable_sd(model).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
    assert_rel(*sbg_forward_pair({"params": jparams, "buffers": sbg["buffers"]}, cfg_j, model),
               what="forward")
    k_weight = model.clip.layers[0].attn["k"].weight
    assert any(p is k_weight for p in trainer.state.optimizer.params) and k_weight.requires_grad


def test_mkv_checkpoint_serves_as_jax(tmp_path, monkeypatch):
    """An MKV-extended Arc2Face SubjBasisGenerator written by
    `save_adaface_ckpt`, loaded by the CLIs' `load_adaface` and by
    `AdaFaceWrapper.load_adaface_ckpt` (after a load of the unextended
    weights shrank the tower back): the ada embeddings against the JAX
    wrapper's with the same extension, at 1e-5."""
    from tests.test_torch_slice import make_wrapper_pair

    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import _common_torch

    jw, tw = make_wrapper_pair()
    jenc, tenc = jw.id2ada_prompt_encoder, tw.id2ada_prompt_encoder
    key, n_layers = jax.random.PRNGKey(50), TEXT_KW["num_layers"]
    mults = [2] * n_layers
    noise = jax_noise(jenc.subj_basis_generator["params"]["prompt2token_proj"]["layers"], key,
                      mults)
    jenc.subj_basis_generator = jsbg.extend_prompt2token_proj_attention(
        jenc.subj_basis_generator, key, mults)
    plain = trainable_sd(tenc.subj_basis_generator)
    ext = tsbg.extend_prompt2token_proj_attention(plain, mults, Draws(handed=list(noise)))
    ck = tckpt.save_adaface_ckpt(str(tmp_path / "mkv"), 1, {"arc2face": ext})
    fid = np.random.RandomState(51).randn(1, 512).astype(np.float32)
    ada_j = np.asarray(jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid)))
    _common_torch.load_adaface(tenc, ck)
    assert tclip.layer_multipliers(tenc.subj_basis_generator.clip) == mults
    ada_t = tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    assert_rel(ada_t.numpy(), ada_j, what="load_adaface")
    tsbg.load_sbg_state_dict(tenc.subj_basis_generator, plain)
    assert tclip.layer_multipliers(tenc.subj_basis_generator.clip) == [1] * n_layers
    tw.load_adaface_ckpt(ck)
    ada_t = tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid))
    assert_rel(ada_t.numpy(), ada_j, what="AdaFaceWrapper.load_adaface_ckpt")

