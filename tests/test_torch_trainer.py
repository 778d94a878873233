"""The port's Stage-1 trainer on the CPU: `Trainer.fit` at tiny widths on a
PNG folder, against itself with the batches prepared in a second thread,
its accumulation, checkpoints and what it refuses; the host half of its
batch preparation against the JAX trainer's (the numpy draws of the
planner, the dataset and the CLIP-skip weights agree bit for bit without
help); the YAML reader against PyYAML; the CLI's parser.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
import yaml

from adaface_tpu.data.personalized import PersonalizedBase as JDataset
from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.text.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.text.embedding_manager import PlaceholderSpec as JSpec
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.train.checkpoint import save_adaface_ckpt as jsave
from adaface_tpu.train.train_step import TrainConfig as JTrainConfig
from adaface_tpu.train.trainer import Trainer as JTrainer
from adaface_tpu.train.trainer import TrainerConfig as JTrainerConfig
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.data.personalized import PersonalizedBase
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.id2ada.teachers import create_unet_teacher
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import _build
from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.models import arcface as tarc
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from adaface_tpu_torch.train.recon_step import ReconStepConfig
from adaface_tpu_torch.train.train_step import TrainConfig
from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig
from adaface_tpu_torch.utils import config as tconfig
from tests.test_torch_models import D, UNET_KW, VAE_KW, numpy_params
from tests.test_torch_train import TRAIN_TEXT_KW, make_png_dataset
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.from_numpy(np.array(a))
IMAGE_SIZE = 64  # latents 8x8


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    return make_png_dataset(tmp_path_factory.mktemp("pngs"), size=IMAGE_SIZE)


def port_stack(seed: int = 0):
    """Random tiny port modules: UNet, CLIP text, VAE encoder and an
    Arc2Face encoder, from one torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    cpu = torch.device("cpu")
    text_cfg = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    unet = build(lambda: tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), cpu,
                 torch.float32, tunet.init_unet_weights_, gen)
    text = build(lambda: tclip.CLIPTextModel(text_cfg), cpu, torch.float32,
                 tclip.init_text_weights_, gen)
    vae = build(lambda: tvae.VAEEncoder(tvae.VAEConfig(**VAE_KW)), cpu, torch.float32,
                init_fan_in_, gen)
    tok = CLIPTokenizer.character_fallback()
    enc = Arc2FaceID2AdaPrompt.random_init(gen, tok, cpu, text_cfg=text_cfg,
                                           sbg_cfg=SubjBasisConfig(clip=text_cfg))
    return unet, text, vae, enc, tok


def make_trainer(log_dir, prefetch: int = 0, **kw) -> Trainer:
    unet, text, vae, enc, tok = port_stack()
    em = EmbeddingManager(tok, [PlaceholderSpec("z", 16)])
    cfg = TrainerConfig(log_dir=str(log_dir), batch_size=2, max_steps=4, accum_steps=2,
                        ckpt_every=4, optimizer="prodigy", lr=1.0, warmup_steps=1,
                        optimizer_kwargs=dict(d_coef=1.0, scheduler_cycles=1,
                                              scheduler_type="Linear", d0=1e-3),
                        image_size=IMAGE_SIZE, prefetch=prefetch, p_perturb_face_id_embs=0.5,
                        echo_every=0, **{"unet_distill_iter_gap": 1, **kw})
    tcfg = TrainConfig(unet=tunet.UNetConfig(**UNET_KW), sbg=enc.sbg_cfg,
                       clip_text=tclip.CLIPTextConfig(**TRAIN_TEXT_KW))
    return Trainer(cfg, tcfg, {"unet": unet, "text_encoder": text},
                   {"sbg": enc.subj_basis_generator}, enc, em, vae=vae,
                   teacher=create_unet_teacher("simple_unet", unet=unet))


def fixed_faces(img):
    """Two faces whatever the pixels (the larger the foreground)."""
    return [(np.array([8, 6, 52, 50], np.float32), 0.9), (np.array([0, 30, 24, 62], np.float32),
                                                          0.8)]


def make_recon_trainer(log_dir, prefetch: int = 0, **kw) -> Trainer:
    """`make_trainer`'s stack with the recon towers: a tiny VAE decoder, a
    random ArcFace without squeeze-excitation, a detector of fixed boxes."""
    unet, text, vae, enc, tok = port_stack()
    gen = torch.Generator().manual_seed(1)
    decoder = build(lambda: tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), torch.device("cpu"),
                    torch.float32, init_fan_in_, gen)
    arc = build(lambda: tarc.ArcFace(use_se=False), torch.device("cpu"), torch.float32,
                tarc.init_arcface_weights_, gen)
    em = EmbeddingManager(tok, [PlaceholderSpec("z", 16)])
    opts = dict(log_dir=str(log_dir), batch_size=2, max_steps=4, accum_steps=2, ckpt_every=0,
                optimizer="cadamw", lr=1e-3, warmup_steps=0, image_size=IMAGE_SIZE,
                prefetch=prefetch, echo_every=0,
                recon_cfg=ReconStepConfig(compute_dtype="float32"))
    opts.update(kw)
    tcfg = TrainConfig(unet=tunet.UNetConfig(**UNET_KW), sbg=enc.sbg_cfg,
                       clip_text=tclip.CLIPTextConfig(**TRAIN_TEXT_KW))
    return Trainer(TrainerConfig(**opts), tcfg, {"unet": unet, "text_encoder": text},
                   {"sbg": enc.subj_basis_generator}, enc, em, vae=vae, vae_decoder=decoder,
                   arcface=arc, host_detector=HostFaceDetector(detector_fn=fixed_faces))


def sbg_params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.state.params["sbg"].named_parameters()}


def run_fit(trainer, png_root, steps: int = 4):
    """fit on a fresh dataset → (metrics of each step, the SBG's params
    after each step, the flags of each step)."""
    metrics, params, flags = [], [], []
    real = trainer._post_step

    def post(step, f, m):
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(sbg_params(trainer))
        flags.append(f)
        return real(step, f, m)

    trainer._post_step = post
    trainer.fit(PersonalizedBase(png_root, num_vectors_per_subj_token=16, size=IMAGE_SIZE,
                                 seed=0), num_steps=steps)
    return metrics, params, flags


def test_fit_two_updates_prefetch_and_accumulation(png_root, tmp_path):
    """Two optimizer updates (4 micro-steps, accumulation 2): finite losses,
    the parameters still after micro-steps 1 and 3 and moved after 2 and 4,
    the teacher's buckets drawn, a checkpoint at step 4 that reloads equal;
    the same metrics and parameters with the batches prepared two ahead in
    a second thread."""
    inline = make_trainer(tmp_path / "p0", prefetch=0)
    start = sbg_params(inline)
    m0, p0, flags = run_fit(inline, png_root)
    m2, p2, _ = run_fit(make_trainer(tmp_path / "p2", prefetch=2), png_root)
    assert len(m0) == 4 and all(np.isfinite(m["loss"]) for m in m0)
    assert m0 == m2
    for a, b in zip(p0, p2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    changed = lambda a, b: any(not torch.equal(a[k], b[k]) for k in a)  # noqa: E731
    assert [changed(a, b) for a, b in zip([start] + p0[:-1], p0)] == [False, True, False, True]
    assert {f.iter_type for f in flags} == {"unet_distill"}
    assert all(2 <= f.num_denoising_steps <= 4 for f in flags)
    # the checkpoint of the last step reloads into a fresh trainer
    ck = Trainer.latest_ckpt(str(tmp_path / "p0"))
    assert ck.endswith("embeddings_gs-4")
    fresh = make_trainer(tmp_path / "fresh")
    assert not all(torch.equal(v, p0[-1][k]) for k, v in sbg_params(fresh).items())
    assert fresh.load(ck) == 4
    got = sbg_params(fresh)
    assert all(torch.equal(got[k], p0[-1][k]) for k in got)
    rows = (tmp_path / "p0" / "metrics.csv").read_text().splitlines()
    assert len(rows) == 5 and rows[0].startswith("step,wall_time,loss,")


def test_checkpoint_layout_matches_jax(tmp_path):
    """The manifest's keys and the tree's top level as the JAX package
    writes them; the state holds each trainable parameter and not the
    frozen embedding tables."""
    trainer = make_trainer(tmp_path / "t")
    out = trainer.save(7)
    manifest = json.loads((pathlib.Path(out) / "manifest.json").read_text())
    jout = jsave(str(tmp_path / "j"), 7, {"joint": {"w": np.zeros(2, np.float32)}})
    jmanifest = json.loads((pathlib.Path(jout) / "manifest.json").read_text())
    assert sorted(manifest) == sorted(jmanifest) and manifest["step"] == 7
    assert manifest["kind"] == jmanifest["kind"] == "adaface"
    state = torch.load(pathlib.Path(out) / "state.pt", weights_only=True)
    assert sorted(state) == ["subj_basis_generators"]
    saved = state["subj_basis_generators"]["joint"]
    want = {k for k, p in trainer.state.params["sbg"].named_parameters() if p.requires_grad}
    assert set(saved) == want and "clip.token_embedding" not in saved


@pytest.mark.parametrize("kw", [dict(comp_distill_iter_gap=3), dict(unet_distill_iter_gap=0)])
def test_trainer_refuses_recon_and_comp_plans(png_root, tmp_path, kw):
    """A plan with comp-distill iterations (ported since Stage 2: refused
    before it) builds and takes a comp step, without face towers on the
    fallback branch; a recon plan (every iteration recon, the identity towers
    wired, the adversarial branch drawn every time) builds and takes a step,
    identity losses included."""
    if "comp_distill_iter_gap" in kw:
        trainer = make_trainer(tmp_path, **kw)
        trainer.comp_cfg = dataclasses.replace(trainer.comp_cfg, num_denoising_steps=2,
                                               compute_dtype="float32")
        metrics = trainer.fit(PersonalizedBase(png_root, num_vectors_per_subj_token=16,
                                               size=IMAGE_SIZE, seed=0), num_steps=1)
        assert np.isfinite(float(metrics["loss"])) and "loss_mb_suppress" in metrics
        assert list(trainer._steps) == [("comp_distill", 4)]
        return
    trainer = make_recon_trainer(tmp_path, p_do_adv_attack=1.0, **kw)
    metrics = trainer.fit(PersonalizedBase(png_root, num_vectors_per_subj_token=16,
                                           size=IMAGE_SIZE, seed=0), num_steps=1)
    assert np.isfinite(float(metrics["loss"])) and "loss_arcface_align_recon" in metrics
    assert list(trainer._steps) == [("recon", False, True, "recon_loss")]


def test_prepared_batches_host_parts_match_jax(png_root, tmp_path):
    """The first three batches of the port's `_batch_iterator` against the
    JAX trainer's, no VAE and no teacher on either side: the planner's
    flags, the prompt batch, the masks and the Dirichlet CLIP-skip weights
    equal (numpy draws on both sides), and the first row's image-prompt
    embeddings (never perturbed) through the bridged Arc2Face encoder
    within 1e-4."""
    text_j = jclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    vis = jclip.CLIPVisionConfig(hidden_size=D, num_layers=1, num_heads=2, intermediate_size=64,
                                 image_size=224, patch_size=32)
    jtok = JTokenizer.character_fallback()
    jenc = JArc2Face(jax.random.PRNGKey(1), tokenizer=jtok, face_backend=JBackend(),
                     clip_vision_cfg=vis, sbg_clip_cfg=text_j, text_cfg=text_j, output_dim=D,
                     text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_j),
                                                      80),
                     clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, vis),
                                                     81))
    unet_j = junet.UNetConfig(**UNET_KW)
    frozen = {"unet": numpy_params(lambda k: junet.init_unet_params(k, unet_j), 82),
              "text_encoder": numpy_params(lambda k: jclip.init_text_params(k, text_j), 83),
              "sbg_buffers": jenc.subj_basis_generator["buffers"]}
    kw = dict(batch_size=2, max_steps=3, accum_steps=1, image_size=IMAGE_SIZE,
              comp_distill_iter_gap=0, unet_distill_iter_gap=1, p_perturb_face_id_embs=0.5,
              prefetch=0, seed=5)
    jtr = JTrainer(JTrainerConfig(log_dir=str(tmp_path / "j"), optimizer="adamw", **kw),
                   JTrainConfig(unet=unet_j, sbg=jenc.sbg_cfg, clip_text=text_j), frozen,
                   {"sbg": jenc.subj_basis_generator["params"]}, jenc,
                   JEM(jtok, [JSpec("z", 16)]), vae_params=None, teacher=None)
    ref = list(jtr._batch_iterator(JDataset(png_root, size=IMAGE_SIZE, seed=0, use_native=False),
                                   3))

    tok = CLIPTokenizer.character_fallback()
    text_t = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    tenc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jenc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), tok),
                    bridge.sbg_tree(jenc.subj_basis_generator)),
        tok, face_backend=DeterministicBackend())
    unet, text, _, _, _ = port_stack()
    ttr = Trainer(TrainerConfig(log_dir=str(tmp_path / "t"), echo_every=0, **kw),
                  TrainConfig(unet=tunet.UNetConfig(**UNET_KW), sbg=tenc.sbg_cfg, clip_text=text_t),
                  {"unet": unet, "text_encoder": text}, {"sbg": tenc.subj_basis_generator}, tenc,
                  EmbeddingManager(tok, [PlaceholderSpec("z", 16)]))
    out = list(ttr._batch_iterator(PersonalizedBase(png_root, size=IMAGE_SIZE, seed=0), 3))
    perturbed = 0
    for (sj, fj, bj), (st, ft, bt) in zip(ref, out):
        assert sj == st and dataclasses.asdict(fj) == dataclasses.asdict(ft)
        for key in ("prompt_ids", "splice_map", "prompt_emb_mask", "uncond_ids", "img_mask",
                    "fg_mask", "clip_skip_weights", "clip_skip_weights_fixed", "face_detected"):
            np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]), err_msg=key)
        assert bt["x_start"].shape == bj["x_start"].shape == (2, 4, 8, 8)
        assert bt["teacher_noise_pred"].shape == bj["teacher_noise_pred"].shape
        ij, it = np.asarray(bj["img_prompt_embs"]), bt["img_prompt_embs"].numpy()
        err = np.abs(it[0] - ij[0]).max() / np.abs(ij[0]).max()
        assert err <= 1e-4
        perturbed += int(not np.allclose(ij[1], ij[0]))
    assert 0 < perturbed  # the perturbed-ID branch ran on both sides


def test_yaml_reader_matches_pyyaml():
    """Every configuration in `configs/` read as PyYAML reads it, and the
    dot-list overrides as `train.py` applies them."""
    paths = sorted((REPO / "configs").glob("*.yaml"))
    assert paths
    for path in paths:
        assert tconfig.load(str(path)) == yaml.safe_load(path.read_text()), path.name
    cfg = tconfig.apply_dotlist(tconfig.load(str(REPO / "configs/stage1-distill-arc2face.yaml")),
                                ["trainer.batch_size=2", "trainer.optimizer_kwargs.d_coef=0.5",
                                 "model.out_id_embs_cfg_scales=[1.0, 2.0]", "new.key=null"])
    assert cfg["trainer"]["batch_size"] == 2 and cfg["trainer"]["optimizer_kwargs"]["d_coef"] == 0.5
    assert cfg["model"]["out_id_embs_cfg_scales"] == [1.0, 2.0] and cfg["new"] == {"key": None}
    for text in ("a:\n  - 1\n", "a: &x 1\n", "a: |\n  b\n"):
        with pytest.raises(ValueError):
            tconfig.loads(text)


def test_cli_builds_on_the_cpu_when_asked(monkeypatch, png_root, tmp_path):
    """`train_torch.py` parses the stage-1 configuration and builds its
    stack on the card unless `--device cpu` is given (the build itself is
    patched out: the stack is full width)."""
    import train_torch

    seen = {}

    def fake_build_and_train(cfg, args):
        seen.update(cfg=cfg, args=args)
        return {}

    monkeypatch.setattr(train_torch, "build_and_train", fake_build_and_train)
    train_torch.main(["trainer.max_steps=3", "--base",
                      str(REPO / "configs/stage1-distill-arc2face.yaml"), "--data_roots", png_root])
    assert seen["args"].device == "cuda" and seen["cfg"]["trainer"]["max_steps"] == 3
    assert seen["cfg"]["trainer"]["optimizer"] == "prodigy"
    train_torch.main(["--base", str(REPO / "configs/stage1-distill-arc2face.yaml"),
                      "--data_roots", png_root, "--device", "cpu"])
    assert seen["args"].device == "cpu"


def test_launch_counter_is_thread_safe():
    """`_build.count` from more threads than cores, switching every
    microsecond, loses no update (the prefetch thread counts its launches
    beside the step's)."""
    import os
    import sys
    import threading

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 5000
    _build.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count("k") for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.LAUNCHES["k"] == n_threads * per_thread
    _build.reset_launch_counts()
