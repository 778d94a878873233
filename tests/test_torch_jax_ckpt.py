"""Checkpoints of the JAX trainer into the port: `scripts/export_jax_ckpt.py`.

A JAX `Trainer.save` (run on a stand-in holding the trainable state) writes
an Orbax checkpoint at tiny widths: an Arc2Face one with the UNet's
attention and FFN adapters, a joint one (Arc2Face + ConsistentID), and an
MKV-extended Arc2Face one (`tests/test_torch_mkv.py` extends as JAX does).
The script exports each; then the port's `AdaFaceWrapper.load_adaface_ckpt`
(and `load_unet_lora_weights`) and `Trainer.load` read the export. The
weights must equal JAX's exactly; the ada embeddings of the port's wrapper
must match the JAX wrapper's with the checkpoint's generators within 1e-5
(`make_wrapper_pair`: both wrappers on one set of tiny weights).
"""

import copy
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada import subj_basis_generator as jsbg
from adaface_tpu.models import unet as junet
from adaface_tpu.train import checkpoint as jckpt
from adaface_tpu.train import trainer as jtrainer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.train import train_step as tstep
from adaface_tpu_torch.train import trainer as ttrainer
from tests.test_torch_comp import lora_trees
from tests.test_torch_models import TEXT_KW, UNET_KW
from tests.test_torch_slice import make_wrapper_pair
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
ADA_RTOL = 1e-5
STEP = 250


@pytest.fixture(scope="module")
def exporter():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import export_jax_ckpt
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return export_jax_ckpt


def jittered(tree, seed: int):
    """Each leaf moved by seeded noise: a trained state, not the init the
    port's wrapper already holds."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rs.randn(*np.shape(a)).astype(np.float32)),
        tree)


def jax_save(tmp_path, sbg_params, lora=None) -> str:
    """`Trainer.save` of the JAX package on a stand-in holding the state."""
    params = {"sbg": sbg_params, **(lora or {})}
    stand_in = types.SimpleNamespace(
        cfg=types.SimpleNamespace(log_dir=str(tmp_path / "jax"), unfreeze_unet=False),
        state=types.SimpleNamespace(params=params))
    return jtrainer.Trainer.save(stand_in, STEP)


def port_trainer(tmp_path, sbgs, lora_cfg=None) -> ttrainer.Trainer:
    """A port `Trainer` over copies of the wrapper's SubjBasisGenerator(s)
    (and fresh adapters), on a stand-in frozen UNet."""
    trainable = {"sbg": [copy.deepcopy(m) for m in sbgs] if len(sbgs) > 1
                 else copy.deepcopy(sbgs[0])}
    if lora_cfg is not None:
        trainable.update(attn_lora=tunet.AttnLoRA(lora_cfg), ffn_lora=tunet.FFNLoRA(lora_cfg))
    cfg = ttrainer.TrainerConfig(log_dir=str(tmp_path / "port"), optimizer="cadamw",
                                 warmup_steps=0, echo_every=0)
    return ttrainer.Trainer(cfg, tstep.TrainConfig(), {"unet": torch.nn.Linear(1, 1)},
                            trainable, None, None)


def jax_sbg_sd(params) -> dict:
    return {k: v.numpy() for k, v in bridge.state_dict(
        {("clip" if k == "prompt2token_proj" else k): v for k, v in params.items()}).items()}


def assert_sbg_equal(module, params, what):
    want = jax_sbg_sd(params)
    got = {n: p.detach().numpy() for n, p in module.named_parameters()
           if n not in tstep.FROZEN_SBG_PARAMS}
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", ["arc2face", "joint", "mkv"])
def test_exported_jax_checkpoint_loads_into_the_port(case, exporter, tmp_path):
    jw, tw = make_wrapper_pair(encoder="jointIDs" if case == "joint" else "arc2face")
    jencs = getattr(jw.id2ada_prompt_encoder, "encoders", [jw.id2ada_prompt_encoder])
    tencs = getattr(tw.id2ada_prompt_encoder, "encoders", [tw.id2ada_prompt_encoder])
    sbgs = [e.subj_basis_generator for e in jencs]
    if case == "mkv":
        mults = [2] * TEXT_KW["num_layers"]
        sbgs = [jsbg.extend_prompt2token_proj_attention(sbgs[0], jax.random.PRNGKey(3), mults)]
    trained = [jittered(s["params"], 30 + i) for i, s in enumerate(sbgs)]
    lora = lora_cfg = None
    if case == "arc2face":
        cfg_j = junet.UNetConfig(**UNET_KW, lora_rank=4)
        attn, ffn = lora_trees(cfg_j, 31)
        lora = {"attn_lora": attn, "ffn_lora": ffn}
        lora_cfg = tunet.UNetConfig(**UNET_KW, lora_rank=4)
    src = jax_save(tmp_path, trained if case == "joint" else trained[0], lora)
    dst = exporter.main([src, str(tmp_path / "exported")])

    # the weights as JAX restores them, exactly
    state, manifest = jckpt.load_checkpoint(src)
    saved = state["subj_basis_generators"]["joint"]
    saved = list(saved) if case == "joint" else [saved]
    tw.load_adaface_ckpt(dst)
    for i, (tenc, params) in enumerate(zip(tencs, saved)):
        assert_sbg_equal(tenc.subj_basis_generator, params, f"wrapper sbg {i}")
    if case == "mkv":
        assert tclip.layer_multipliers(tencs[0].subj_basis_generator.clip) == mults
    trainer = port_trainer(tmp_path, [e.subj_basis_generator for e in tencs], lora_cfg)
    assert trainer.load(dst) == manifest["step"] == STEP
    for i, (m, params) in enumerate(zip(trainer.state.params["sbg"] if case == "joint"
                                        else [trainer.state.params["sbg"]], saved)):
        assert_sbg_equal(m, params, f"trainer sbg {i}")
    assert {id(p) for p in trainer.state.optimizer.params} == {
        id(p) for p in tstep.trainable_parameters(trainer.state.params)}
    if lora is not None:
        tw.load_unet_lora_weights(dst, ffn_adapter="unet_distill")
        for key in ("attn_lora", "ffn_lora"):
            want = {k: v.numpy() for k, v in bridge.lora_state_dict(
                state["unet_lora_modules"][key]).items()}
            for got in (trainer.state.params[key].state_dict(),
                        getattr(tw.pipeline.m, key).state_dict()):
                assert sorted(got) == sorted(want), key
                for k in want:
                    np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"{key} {k}")

    # the ada embeddings against the JAX wrapper with the same generators
    for jenc, params in zip(jencs, saved):
        jenc.subj_basis_generator = dict(jenc.subj_basis_generator,
                                         params=jax.tree_util.tree_map(jnp.asarray, params))
    rs = np.random.RandomState(32)
    imgs = [rs.randint(0, 256, (224, 224, 3)).astype(np.uint8) for _ in range(2)]
    ada_j = np.asarray(jw.prepare_adaface_embeddings(images=imgs))
    ada_t = tw.prepare_adaface_embeddings(images=imgs).numpy()
    assert ada_t.shape == ada_j.shape
    err = np.abs(ada_t - ada_j).max() / np.abs(ada_j).max()
    assert err <= ADA_RTOL, f"ada embeddings: {err:.3e} of the largest"
