"""The Stage-1 joint and ConsistentID configurations through
`train_torch.build_trainer` against JAX's `train.py`, on the CPU at tiny
widths.

Both CLIs build their stacks from `configs/stage1-distill-joint.yaml`
(Arc2Face + ConsistentID, the static suffix on) and
`configs/stage1-distill-consistentid.yaml` with the towers cut as
`tests/test_torch_cli.py` cuts them (the modules' configs patched, a
tokenizer of each side's own); JAX's `Trainer` is replaced by a stand-in
that keeps what `train.py` hands it. Then: the SubjBasisConfigs (suffix 4 in
each sub-encoder of the joint, 0 for ConsistentID), the placeholder width,
the trainable set (names and shapes, each SubjBasisGenerator's), and,
with JAX's params carried into the port through `core/bridge.py`, one
unet-distill micro-step's loss and the SubjBasisGenerators' gradients in
fp32 at 1e-4 (one JAX compile a case).

The joint's ada embeddings are Arc2Face's 16 + 4 suffix tokens then
ConsistentID's 4 + 4; the placeholder holds 20 (`encoder.num_id_vecs`, as
in `train.py`), so the prompt takes Arc2Face's 20 and ConsistentID's
SubjBasisGenerator gets a gradient of zero in both packages.
"""

import argparse
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada import face_id_to_ada_prompt as jfid
from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.text import tokenizer as jtokmod
from adaface_tpu.train import prompt_batch as jpb
from adaface_tpu.train import train_step as jstep
from adaface_tpu.utils import compile_cache
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada import face_id_to_ada_prompt as tfid
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.train import prompt_batch as tpb
from adaface_tpu_torch.train import train_step as tstep
from tests.test_torch_models import D, VAE_KW, numpy_params
from tests.test_torch_train import TRAIN_TEXT_KW, assert_rel, make_png_dataset, rel_l2
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
HW = 64
RTOL = 1e-4
VIS_KW = dict(hidden_size=D, num_layers=1, num_heads=2, intermediate_size=64, image_size=224,
              patch_size=32)
# two levels, one resnet each, cross-attention at the top: what a config's
# path reaches at a fraction of the JAX compile of the four-level tiny UNet
UNET_KW = dict(block_channels=(16, 32), layers_per_block=1, down_has_attn=(True, False),
               up_has_attn=(False, True), cross_attn_dim=D, num_heads=2, norm_groups=8)
CONFIGS = {"joint": "stage1-distill-joint.yaml", "consistentID": "stage1-distill-consistentid.yaml"}


class Kept:
    """Stands in for JAX's `Trainer`: keeps what `train.py` hands it."""

    last = None

    def __init__(self, cfg, train_cfg, frozen, trainable, encoder, em, **kw):
        self.cfg, self.train_cfg, self.frozen, self.trainable = cfg, train_cfg, frozen, trainable
        self.encoder, self.em, self.kw = encoder, em, kw
        Kept.last = self

    def fit(self, *args, **kw):
        pass


def jax_build(config: str, data: str, tmp_path, monkeypatch) -> Kept:
    """`train.py`'s `build_and_train` at tiny widths, its trainer kept."""
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda *a, **k: None)
    import train

    text_j = jclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    vis_j = jclip.CLIPVisionConfig(**VIS_KW)
    real_unet, real_text, real_vae = (junet.init_unet_params, jclip.init_text_params,
                                      jvae.init_vae_params)
    real_enc = jfid.create_id2ada_prompt_encoder
    # the initialisers' trees with numpy leaves (`numpy_params`): op by op
    # the JAX UNet's alone takes seconds on the CPU
    monkeypatch.setattr(junet, "SD15_UNET", junet.UNetConfig(**UNET_KW))
    monkeypatch.setattr(junet, "init_unet_params",
                        lambda k, cfg: numpy_params(lambda kk: real_unet(kk, cfg), 60))
    monkeypatch.setattr(jclip, "init_text_params", lambda k, cfg=None: numpy_params(
        lambda kk: real_text(kk, text_j), 61))
    monkeypatch.setattr(jvae, "init_vae_params", lambda k, cfg=None: numpy_params(
        lambda kk: real_vae(kk, jvae.VAEConfig(**VAE_KW)), 62))
    monkeypatch.setattr("adaface_tpu.models.arcface.init_arcface_params", lambda k: {})
    monkeypatch.setattr(jtokmod, "default_tokenizer", jtokmod.CLIPTokenizer.character_fallback)

    def tiny_enc(name, rng, **kw):
        if name != "consistentID":  # Arc2Face's own text tower
            kw["text_cfg"] = text_j
        return real_enc(name, rng, tokenizer=jtokmod.CLIPTokenizer.character_fallback(),
                        face_backend=JBackend(), clip_vision_cfg=vis_j, sbg_clip_cfg=text_j,
                        output_dim=D, **kw)

    monkeypatch.setattr(jfid, "create_id2ada_prompt_encoder", tiny_enc)
    monkeypatch.setattr("adaface_tpu.train.trainer.Trainer", Kept)
    args = argparse.Namespace(
        data_roots=[data], log_dir=str(tmp_path / "j"), scale_lr=False, base_model=None,
        comp_unet_weight_path=None, mix_subj_data_roots=None, subject_string="z",
        default_cls_delta_string="person", resume=False, adaface_ckpt_path=None,
        extend_mkv_multiplier=1, max_steps=1)
    cfg = train.apply_dotlist(train.yaml.safe_load((REPO / "configs" / config).read_text()),
                              [f"trainer.image_size={HW}"])
    train.build_and_train(cfg, args)
    return Kept.last


def port_build(config: str, data: str, tmp_path, monkeypatch):
    """`train_torch.build_trainer` at the same widths → the trainer."""
    import train_torch

    text_t = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    vis_t = tclip.CLIPVisionConfig(**VIS_KW)
    real_enc = tfid.create_id2ada_prompt_encoder
    arc_kw = dict(text_cfg=text_t, sbg_cfg=SubjBasisConfig(clip=text_t))
    cid_kw = dict(vision_cfg=vis_t, sbg_cfg=SubjBasisConfig(num_id_vecs=4, clip=text_t))

    def tiny_enc(name, gen, tok, device, **kw):
        kw["face_backend"] = DeterministicBackend()
        if name == "consistentID":
            return real_enc(name, gen, tok, device, **cid_kw, **kw)
        return real_enc(name, gen, tok, device, arc2face_kw=arc_kw, consistentid_kw=cid_kw, **kw)

    monkeypatch.setattr(tfid, "create_id2ada_prompt_encoder", tiny_enc)
    monkeypatch.setattr(tunet, "UNet2DConditionModel",
                        lambda real=tunet.UNet2DConditionModel: real(tunet.UNetConfig(**UNET_KW)))
    monkeypatch.setattr(tclip, "CLIPTextModel", lambda real=tclip.CLIPTextModel: real(text_t))
    monkeypatch.setattr(tvae, "VAEEncoder",
                        lambda real=tvae.VAEEncoder: real(tvae.VAEConfig(**VAE_KW)))
    monkeypatch.setattr("adaface_tpu_torch.text.tokenizer.default_tokenizer",
                        CLIPTokenizer.character_fallback)
    cfg, args = train_torch.parse_args([
        f"trainer.image_size={HW}", "--base", str(REPO / "configs" / config), "--data_roots", data,
        "--log_dir", str(tmp_path / "t"), "--device", "cpu"])
    trainer, _, _ = train_torch.build_trainer(cfg, args)
    return trainer


def as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def jax_sbg_sd(params, buffers=None) -> dict:
    """A JAX SubjBasisGenerator's params (or their gradients) under the
    port's names; the frozen tables zero where only params are given."""
    if buffers is None:
        return bridge.state_dict({("clip" if k == "prompt2token_proj" else k): v
                                  for k, v in params.items()})
    return bridge.state_dict(bridge.sbg_tree({"params": params, "buffers": buffers}))


def make_batch(jem, tem, n_vec: int, seed: int = 72):
    """One unet-distill batch for both sides: the 4-block prompts with the
    placeholder as the dataset writes it, latents, a teacher prediction."""
    rs = np.random.RandomState(seed)
    b, hw = 2, HW // 8
    z = "z" + ", " * (n_vec - 1)
    subj = [f"a photo of {z} in a park", f"{z} smiling"]
    cls = ["a photo of a young woman in a park", "a young woman smiling"]
    jb = jpb.build_4block_prompt_batch(jem, subj, subj, cls, cls)
    tb = tpb.build_4block_prompt_batch(tem, subj, subj, cls, cls)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    batch = dict(jb)
    batch.update(
        x_start=rs.randn(b, 4, hw, hw).astype(np.float32),
        img_prompt_embs=rs.randn(b, n_vec, D).astype(np.float32),
        clip_skip_weights=rs.dirichlet([1.0, 2.0, 2.0]).astype(np.float32),
        noise=rs.randn(b, 4, hw, hw).astype(np.float32), t=np.array([880, 720], np.int32),
        teacher_noise_pred=rs.randn(b, 4, hw, hw).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch = {k: v.long() if k in ("prompt_ids", "splice_map", "uncond_ids", "t",
                                   "merge_map") else v for k, v in tbatch.items()}
    return jbatch, tbatch


@pytest.mark.parametrize("name", ["joint", "consistentID"])
def test_stage1_config_matches_train_py(name, tmp_path, monkeypatch):
    data = make_png_dataset(tmp_path / "pngs", size=HW)
    kept = jax_build(CONFIGS[name], data, tmp_path, monkeypatch)
    trainer = port_build(CONFIGS[name], data, tmp_path, monkeypatch)

    # the encoders, their SubjBasisConfigs and the placeholder
    suffix = 4 if name == "joint" else 0
    jcfgs, tcfgs = as_list(kept.train_cfg.sbg), as_list(trainer.tcfg.sbg)
    assert [c.num_id_vecs for c in tcfgs] == [c.num_id_vecs for c in jcfgs] == (
        [16, 4] if name == "joint" else [4])
    assert [c.num_static_img_suffix_embs for c in tcfgs] == [
        c.num_static_img_suffix_embs for c in jcfgs] == [suffix] * len(jcfgs)
    assert trainer.encoder.num_id_vecs == kept.encoder.num_id_vecs
    assert trainer.em.placeholders[0].num_vectors == kept.em.placeholders[0].num_vectors
    assert trainer.em.placeholders[0].num_vectors == (20 if name == "joint" else 4)
    for key in ("unet_distill_weight", "prompt_emb_delta_weight", "recon_bg_pixel_weight"):
        assert getattr(trainer.tcfg, key) == getattr(kept.train_cfg, key), key

    # the trainable set: one SubjBasisGenerator an encoder, the same tensors
    jsbgs, tsbgs = as_list(kept.trainable["sbg"]), as_list(trainer.state.params["sbg"])
    assert sorted(trainer.state.params) == sorted(kept.trainable) == ["sbg"]
    assert len(jsbgs) == len(tsbgs)
    for jp, tm in zip(jsbgs, tsbgs):
        want = {k: tuple(v.shape) for k, v in jax_sbg_sd(jp).items()}
        got = {k: tuple(p.shape) for k, p in tm.named_parameters() if p.requires_grad}
        assert got == want
        assert ("static_img_suffix_embs" in got) == bool(suffix)
    assert {id(p) for p in trainer.state.optimizer.params} == {
        id(p) for m in tsbgs for p in m.parameters() if p.requires_grad}

    # JAX's weights into the port's modules
    bufs = as_list(kept.frozen["sbg_buffers"])
    for jp, jb, tm in zip(jsbgs, bufs, tsbgs):
        bridge.load(tm, bridge.sbg_tree({"params": jp, "buffers": jb}))
    bridge.load(trainer.frozen["unet"], kept.frozen["unet"])
    bridge.load(trainer.frozen["text_encoder"], kept.frozen["text_encoder"])
    params = trainer.state.params
    tstep.trainable_parameters(params)

    # one unet-distill micro-step: the loss and the gradients
    jbatch, tbatch = make_batch(kept.em, trainer.em, trainer.em.placeholders[0].num_vectors)
    # the configs' towers as built (both CLIs leave TrainConfig's at SD1.5)
    jcfg = dataclasses.replace(kept.train_cfg, unet=junet.UNetConfig(**UNET_KW),
                               clip_text=jclip.CLIPTextConfig(**TRAIN_TEXT_KW))
    tcfg = dataclasses.replace(trainer.tcfg, unet=tunet.UNetConfig(**UNET_KW),
                               clip_text=tclip.CLIPTextConfig(**TRAIN_TEXT_KW))
    sched_j = jsched.DiffusionSchedule.create()

    def loss_j(tr):
        return jstep.unet_distill_loss_fn(tr, kept.frozen, jbatch, sched_j, jcfg,
                                          jax.random.PRNGKey(0))

    (lj, mj), gj = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(kept.trainable)
    lt, mt = tstep.unet_distill_loss_fn(params, trainer.frozen, tbatch,
                                        tsched.DiffusionSchedule.create(), tcfg)
    lt.backward()
    for key in ("loss", "loss_unet_distill", "loss_prompt_emb_delta"):
        assert_rel(mt[key].item(), mj[key], rtol=RTOL, what=key)
    norms = []
    for i, (g, tm) in enumerate(zip(as_list(gj["sbg"]), tsbgs)):
        ref = jax_sbg_sd(g)
        got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
               for n, p in tm.named_parameters() if p.requires_grad}
        names = sorted(got)
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
        scale = np.linalg.norm(flat(ref))
        norms.append(scale)
        if scale == 0:  # no token of this encoder reaches the prompt
            assert not flat(got).any(), i
            continue
        assert rel_l2(flat(got), flat(ref)) <= RTOL, i
        if suffix:
            g_sfx, r_sfx = got["static_img_suffix_embs"], np.asarray(ref["static_img_suffix_embs"])
            assert np.linalg.norm(r_sfx) > 1e-3 * scale
            assert rel_l2(g_sfx, r_sfx) <= RTOL
    # Arc2Face's generator (or ConsistentID's alone) trains; the joint's
    # ConsistentID tokens lie past the 20 the placeholder holds
    assert norms[0] > 0 and (len(norms) == 1 or norms[1] == 0)
