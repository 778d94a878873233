"""The port's recon trainer on the CPU against the JAX trainer: a JAX and a
port trainer on one set of tiny weights (`recon_pair`) for
`finetune-unet`-shaped runs, the host half of their recon batches, a fit's
losses on the JAX trainer's batches with its draws handed over, and the
UNet's `unet_fp16.safetensors` against the JAX trainer's export.
"""

import dataclasses
import itertools
import pathlib

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.data.personalized import PersonalizedBase as JDataset
from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt as JArc2Face
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.text.embedding_manager import EmbeddingManager as JEM
from adaface_tpu.text.embedding_manager import PlaceholderSpec as JSpec
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.tools import ckpt_lib as jckpt
from adaface_tpu.train.face_detect import HostFaceDetector as JDetector
from adaface_tpu.train.recon_step import ReconStepConfig as JReconStepConfig
from adaface_tpu.train.recon_step import sample_recon_rand as JSampleRand
from adaface_tpu.train.train_step import TrainConfig as JTrainConfig
from adaface_tpu.train.trainer import Trainer as JTrainer
from adaface_tpu.train.trainer import TrainerConfig as JTrainerConfig
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.data.personalized import PersonalizedBase
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models import arcface as tarc
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.tools import ckpt_lib as tckpt
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from adaface_tpu_torch.train.recon_step import ReconStepConfig
from adaface_tpu_torch.train.train_step import TrainConfig
from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests.test_torch_models import D, VAE_KW, numpy_params
from tests.test_torch_recon import RECON_UNET_KW, arcface_params
from tests.test_torch_train import TRAIN_TEXT_KW, make_png_dataset
from tests.test_torch_trainer import IMAGE_SIZE, _t, fixed_faces
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    return make_png_dataset(tmp_path_factory.mktemp("pngs"), size=IMAGE_SIZE)


def _first_face_if_bright(img):
    """A face where the uint8 image's mean is over 100: the same verdict on
    both sides, which see the same pixels."""
    return [(np.array([4, 4, 60, 60], np.float32), 1.0)] if img.mean() > 100 else []


def recon_pair(tmp_path, seed: int = 100, **kw):
    """A JAX trainer and the port's on one set of tiny weights for
    `finetune-unet`-shaped runs (every iteration recon, the UNet trained):
    the JAX VAE's encoder and decoder, ArcFace, the Arc2Face encoder."""
    text_j = jclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    vis = jclip.CLIPVisionConfig(hidden_size=D, num_layers=1, num_heads=2, intermediate_size=64,
                                 image_size=224, patch_size=32)
    jtok = JTokenizer.character_fallback()
    jenc = JArc2Face(jax.random.PRNGKey(1), tokenizer=jtok, face_backend=JBackend(),
                     clip_vision_cfg=vis, sbg_clip_cfg=text_j, text_cfg=text_j, output_dim=D,
                     text_encoder_params=numpy_params(lambda k: jclip.init_text_params(k, text_j),
                                                      seed),
                     clip_vision_params=numpy_params(lambda k: jclip.init_vision_params(k, vis),
                                                     seed + 1))
    unet_j = junet.UNetConfig(**RECON_UNET_KW)
    vae_j = jvae.VAEConfig(**VAE_KW)
    unet_p = numpy_params(lambda k: junet.init_unet_params(k, unet_j), seed + 2)
    text_p = numpy_params(lambda k: jclip.init_text_params(k, text_j), seed + 3)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, vae_j), seed + 4)
    arc_p = arcface_params(seed + 5)
    detector_fn = kw.pop("detector_fn", fixed_faces)
    # the FFN adapter draw keys a step of its own in the JAX trainer (one
    # more compile of the same graph): pinned to the recon adapter
    opts = dict(batch_size=2, max_steps=4, accum_steps=2, ckpt_every=0, optimizer="cadamw",
                lr=1e-3, warmup_steps=0, image_size=IMAGE_SIZE, comp_distill_iter_gap=0,
                unet_distill_iter_gap=0, unfreeze_unet=True, prefetch=0, seed=5,
                p_recon_ffn_comp_adapter=0.0)
    opts.update(kw)
    jrcfg = JReconStepConfig(compute_dtype="float32", vae_cfg=vae_j,
                             recon_face_align_loss_thres=-1.0)
    jtr = JTrainer(JTrainerConfig(log_dir=str(tmp_path / "j"), recon_cfg=jrcfg, **opts),
                   JTrainConfig(unet=unet_j, sbg=jenc.sbg_cfg, clip_text=text_j,
                                training_perturb_prob=0.0),
                   {"unet": unet_p, "text_encoder": text_p,
                    "sbg_buffers": jenc.subj_basis_generator["buffers"]},
                   {"sbg": jenc.subj_basis_generator["params"]}, jenc,
                   JEM(jtok, [JSpec("z", 16)]), vae_params=vae_p, arcface_params=arc_p,
                   host_detector=JDetector(detector_fn=detector_fn))
    tok = CLIPTokenizer.character_fallback()
    text_t = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    tenc = Arc2FaceID2AdaPrompt(
        bridge.load(tclip.CLIPTextModel(text_t), jenc.text_encoder_params),
        bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), tok),
                    bridge.sbg_tree(jenc.subj_basis_generator)),
        tok, face_backend=DeterministicBackend())
    vae_t = tvae.VAEConfig(**VAE_KW)
    ttr = Trainer(
        TrainerConfig(log_dir=str(tmp_path / "t"), echo_every=0,
                      recon_cfg=ReconStepConfig(compute_dtype="float32",
                                                recon_face_align_loss_thres=-1.0), **opts),
        TrainConfig(unet=tunet.UNetConfig(**RECON_UNET_KW), sbg=tenc.sbg_cfg, clip_text=text_t,
                    training_perturb_prob=0.0),
        {"unet": bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**RECON_UNET_KW)),
                             unet_p),
         "text_encoder": bridge.load(tclip.CLIPTextModel(text_t), text_p)},
        {"sbg": tenc.subj_basis_generator}, tenc, EmbeddingManager(tok, [PlaceholderSpec("z", 16)]),
        vae=bridge.load(tvae.VAEEncoder(vae_t), bridge.vae_encoder_tree(vae_p)),
        vae_decoder=bridge.load(tvae.VAEDecoder(vae_t), bridge.vae_decoder_tree(vae_p)),
        arcface=bridge.load(tarc.ArcFace(use_se=False), arc_p),
        host_detector=HostFaceDetector(detector_fn=detector_fn))
    return jtr, ttr, unet_p


def test_recon_batches_host_parts_match_jax(png_root, tmp_path):
    """The first three recon batches of the port's `_batch_iterator` against
    the JAX trainer's, with `skip_non_faces` resampling the photos its
    detector finds no face on: the flags, the prompt batch, the masks, the
    CLIP-skip weights, the input pixels, their detections and the attn-LoRA
    gate equal; the VAE's latents within 1e-5."""
    jtr, ttr, _ = recon_pair(tmp_path, skip_non_faces=True, detector_fn=_first_face_if_bright,
                             p_normal_recon_on_pure_noise=0.5)
    # the sampler is sized for the steps asked for and the resampling draws
    # past them: ask for more steps than are taken
    ref = list(itertools.islice(jtr._batch_iterator(
        JDataset(png_root, size=IMAGE_SIZE, seed=0, use_native=False), 8), 3))
    out = list(itertools.islice(ttr._batch_iterator(
        PersonalizedBase(png_root, size=IMAGE_SIZE, seed=0), 8), 3))
    detected = []
    for (sj, fj, bj), (st, ft, bt) in zip(ref, out):
        assert sj == st and dataclasses.asdict(fj) == dataclasses.asdict(ft)
        assert ft.iter_type == "recon"
        for key in ("prompt_ids", "splice_map", "prompt_emb_mask", "uncond_ids", "img_mask",
                    "fg_mask", "clip_skip_weights", "clip_skip_weights_fixed", "face_detected",
                    "ref_images", "ref_face_bboxes", "ref_face_detected", "recon_attn_lora_gate"):
            np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]), err_msg=key)
        assert_rel = np.abs(bt["x_start"].numpy() - np.asarray(bj["x_start"])).max()
        assert assert_rel <= 1e-5 * np.abs(np.asarray(bj["x_start"])).max()
        detected.append(bt["ref_face_detected"].numpy())
    assert np.concatenate(detected).any()  # some photos have a face
    assert np.mean(ttr.face_stats.buffers["face_detected"]) == np.mean(
        jtr.face_stats.buffers["face_detected"])


def test_finetune_fit_matches_jax_losses(png_root, tmp_path):
    """A `finetune-unet`-shaped fit (recon on images, the UNet trained
    beside the SubjBasisGenerator, accumulation 2, cautious AdamW): four
    micro-steps of the port's `Trainer.fit` on the JAX trainer's batches
    with its draws handed over, against the JAX trainer's losses (1e-5
    relative); the UNet still inside an accumulation window and moved at
    each update."""
    jtr, ttr, _ = recon_pair(tmp_path)
    ds = lambda: JDataset(png_root, size=IMAGE_SIZE, seed=0, use_native=False)  # noqa: E731
    seen = []
    real = jtr._post_step
    jtr._post_step = lambda step, f, m, b: seen.append((step, f, m, b)) or real(step, f, m, b)
    jtr.fit(ds(), num_steps=4)
    assert [f.iter_type for _, f, _, _ in seen] == ["recon"] * 4

    sched = jsched.DiffusionSchedule.create()

    def handed():
        for step, f, _, b in seen:
            rcfg = dataclasses.replace(jtr.cfg.recon_cfg, on_pure_noise=f.normal_recon_on_pure_noise,
                                       do_adv_attack=f.do_adv_attack)
            _, k_rand = jax.random.split(jax.random.PRNGKey(f.seed))
            jr = JSampleRand(k_rand, b["x_start"], sched, rcfg)
            tr = {k: _t(jr[k]) for k in ("noises", "rel_ts", "x_start0")}
            tr["t0"] = _t(jr["t0"]).long()
            tr["adv_uniform"] = float(jr["adv_uniform"])
            tr["adv_dropout_u"] = _t(jax.random.uniform(jr["adv_dropout_key"], (2, 512)))
            tb = {k: (_t(v).long() if np.asarray(v).dtype.kind in "iu" else _t(v))
                  for k, v in b.items()}
            yield step, f, dict(tb, recon_rand=tr)

    ttr._batch_iterator = lambda *a, **kw: handed()
    losses, unet_w = [], []
    tunet_mod = ttr.state.params["unet"]
    real_t = ttr._post_step

    def post(step, f, m):
        losses.append(float(m["loss"]))
        unet_w.append(tunet_mod.conv_in.weight.detach().clone())
        return real_t(step, f, m)

    ttr._post_step = post
    start = tunet_mod.conv_in.weight.detach().clone()
    ttr.fit(None, num_steps=4)
    ref = [float(m["loss"]) for _, _, m, _ in seen]
    np.testing.assert_allclose(losses, ref, rtol=1e-5)
    changed = [not torch.equal(a, b) for a, b in zip([start] + unet_w[:-1], unet_w)]
    assert changed == [False, True, False, True]


def test_unet_fp16_safetensors_matches_jax_export(tmp_path):
    """With `unfreeze_unet` a checkpoint holds `unet_fp16.safetensors`, which
    `safetensors.numpy.load_file` reads back equal in keys and values to the
    JAX trainer's export of the same UNet (`cast_fp16(flatten_tree(...))`)."""
    from safetensors.numpy import load_file

    jtr, ttr, unet_p = recon_pair(tmp_path)
    out = pathlib.Path(ttr.save(3))
    got = load_file(str(out / "unet_fp16.safetensors"))
    want = jckpt.cast_fp16(jckpt.flatten_tree(unet_p))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float16 and np.array_equal(got[k], want[k]), k
    # the JAX trainer's own file, and the port's reader on it
    jout = pathlib.Path(jtr.save(3))
    jfile = load_file(str(jout / "unet_fp16.safetensors"))
    assert sorted(jfile) == sorted(got)
    back = tckpt.load_state_dict(str(jout / "unet_fp16.safetensors"))
    assert all(np.array_equal(back[k], jfile[k]) for k in jfile)
