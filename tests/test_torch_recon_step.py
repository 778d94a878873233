"""The recon iteration of the PyTorch port (`train/recon_step.py`) against
the JAX package's `recon_loss_fn_v2`, on the CPU, through `make_train_step`
on both sides: on images (the steps restart from the input latents), on pure
noise (priming steps, then steps chained with gradient) and with the
adversarial branch, each with the whole UNet trainable beside the
SubjBasisGenerator, as `configs/finetune-unet.yaml` trains them.

Tiny towers in fp32 (16x16 latents: the UNet's top level and the VAE
decoder's mid block have 256 tokens, where both packages take their flash
path), one set of numpy weights through the bridge, the same batch, and the
JAX draws handed over (`batch["recon_rand"]`). The host detector returns the
same boxes whatever the pixels (a detector that thresholds pixels could
tell two fp32 decodes 1e-6 apart from each other), so the identity losses
are live on both sides. The face embedding is `SmoothTower` on both sides
(patched into the JAX module): through a random ArcFace's max-pools and
PReLUs an fp32 rounding apart flips a kink, and the gradients drift by
about 1e-4 for that alone (`tests/test_torch_recon.py` holds the losses
through the random ArcFace, `tests/test_torch_trainer.py` a fit with it).
Each JAX variant is compiled once, for the module.

Tolerances: the loss and its parts 1e-5 relative; the gradients of the
SubjBasisGenerator and of the UNet (and their global norm) 1e-4 relative L2
over each set (a backward through a UNet and a VAE decoder, summed in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu.train import train_step as jstep
from adaface_tpu.train.face_detect import HostFaceDetector as JDetector
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.train import optimizers as topt
from adaface_tpu_torch.train import recon_step as trecon
from adaface_tpu_torch.train import train_step as tstep
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from tests.test_torch_models import VAE_KW, numpy_params
from tests.test_torch_recon import RECON_UNET_KW, SmoothTower, arcface_params
from tests.test_torch_train import (_jax_sbg_state_dict, _keep_grads, assert_rel,
                                    build_step_pair, make_batch, rel_l2)

GRAD_REL_L2 = 1e-4
HW, PX = 16, 64
# priming steps on pure noise: 2 of the reference's 4 (the cls and subject
# contexts alternate at 2 already; each unrolled UNet call lengthens the JAX
# compile)
PRIMING = 2
# (label, on pure noise, adversarial branch, align-loss threshold)
VARIANTS = [("images", False, False, -1.0), ("pure_noise", True, False, 0.8),
            ("adversarial", False, True, -1.0)]


def fixed_faces(img):
    """Three faces whatever the pixels: the largest is the foreground, the
    other two the background slots."""
    return [(np.array([8, 6, 52, 50], np.float32), 0.9),
            (np.array([0, 30, 24, 62], np.float32), 0.8),
            (np.array([40, 0, 63, 20], np.float32), 0.7)]


def recon_batch(jm, tm):
    """make_batch's prompts and latents plus what a recon batch carries: an
    img_mask with masked keys, a fg mask, the input pixels and their faces."""
    jb, tb = make_batch(jm, tm, 0, seed=81)
    rs = np.random.RandomState(82)
    img_mask = np.ones((2, 1, HW, HW), np.float32)
    img_mask[1, :, :, -3:] = 0.0
    fg = np.ones((2, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    extra = {"img_mask": img_mask, "fg_mask": fg,
             "ref_images": np.clip(rs.randn(2, 3, PX, PX) * 0.4, -1, 1).astype(np.float32),
             "ref_face_bboxes": np.array([[8, 8, 40, 40], [4, 10, 60, 58]], np.float32),
             "ref_face_detected": np.ones((2,), np.float32),
             "recon_attn_lora_gate": np.float32(0.0)}
    jb.update({k: jnp.asarray(v) for k, v in extra.items()})
    tb.update({k: torch.from_numpy(np.array(v)) for k, v in extra.items()})
    return jb, tb


def handed_rand(jb, rcfg):
    """JAX's draws of the iteration from one key, for both sides: the JAX
    dict, and the port's (the dropout as the uniforms JAX's bernoulli reads)."""
    sched = jsched.DiffusionSchedule.create()
    jr = jrecon.sample_recon_rand(jax.random.PRNGKey(7), jb["x_start"], sched, rcfg)
    nb = min(rcfg.adv_bs, jb["x_start"].shape[0])
    tr = {k: torch.from_numpy(np.array(jr[k])) for k in ("t0", "noises", "rel_ts", "x_start0")}
    tr["t0"] = tr["t0"].long()
    tr["adv_uniform"] = float(jr["adv_uniform"])
    tr["adv_dropout_u"] = torch.from_numpy(
        np.array(jax.random.uniform(jr["adv_dropout_key"], (nb, 512))))
    return jr, tr


@pytest.fixture(scope="module")
def stacks():
    with pytest.MonkeyPatch.context() as mp:
        smooth = SmoothTower()
        mp.setattr(jfl, "arcface_embed", smooth.jax_embed)
        yield build_stacks(smooth)


def build_stacks(tower):
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair(
        seed=90, unet_kw=RECON_UNET_KW)
    jcfg = dataclasses.replace(jcfg, training_perturb_prob=0.0)
    tcfg = dataclasses.replace(tcfg, training_perturb_prob=0.0)
    vae_cfg = jvae.VAEConfig(**VAE_KW)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, vae_cfg), 91)
    arc_p = arcface_params(92)
    jfrozen = dict(jfrozen, vae=vae_p, arcface=arc_p)
    jtrain = dict(jtrain, unet=jfrozen["unet"])
    tfrozen = dict(tfrozen, vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                                            bridge.vae_decoder_tree(vae_p)),
                   arcface=tower)
    tparams = dict(tparams, unet=tfrozen["unet"])
    jb, tb = recon_batch(jm, tm)
    return (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb


@pytest.fixture(scope="module")
def jax_results(stacks):
    """Each variant's JAX step, compiled once: (metrics, SBG state dict of
    the gradients, UNet state dict of the gradients)."""
    (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, _), jb, _ = stacks
    sched = jsched.DiffusionSchedule.create()
    ref_sbg = {k: v.clone() for k, v in tparams["sbg"].state_dict().items()}
    ref_unet = tparams["unet"].state_dict()
    zeros = {k: jnp.zeros_like(v) if k in ("token_embedding", "position_embedding") else v
             for k, v in jfrozen["sbg_buffers"].items()}
    out = {}
    for label, noise, adv, thres in VARIANTS:
        rcfg = jrecon.ReconStepConfig(on_pure_noise=noise, do_adv_attack=adv,
                                      recon_face_align_loss_thres=thres, vae_cfg=vae_cfg,
                                      compute_dtype="float32", num_priming_steps=PRIMING)
        opt = optax.chain(_keep_grads(), optax.set_to_zero())
        step = jstep.make_train_step(
            jrecon.make_recon_loss_fn(rcfg, JDetector(detector_fn=fixed_faces)), opt, jfrozen,
            sched, jcfg, donate=False)
        jr, _ = handed_rand(jb, rcfg)
        state, metrics = step(jstep.init_state(jtrain, opt), dict(jb, recon_rand=jr),
                              jax.random.PRNGKey(0))
        g = state.opt_state[0]["g"]
        out[label] = ({k: float(v) for k, v in metrics.items()},
                      _jax_sbg_state_dict(g["sbg"], zeros, ref_sbg),
                      bridge.fuse_projections(bridge.state_dict(g["unet"]), ref_unet))
    return out


@pytest.mark.parametrize("label,noise,adv,thres", VARIANTS)
def test_recon_step_matches_jax(stacks, jax_results, label, noise, adv, thres):
    """One recon step through `make_train_step` with the JAX draws handed
    over: the loss and its parts, and the gradients the optimizer is given,
    of the SubjBasisGenerator and of the whole UNet."""
    _, (tfrozen, tparams, tcfg), jb, tb = stacks
    jmetrics, jsbg, junet_g = jax_results[label]
    rcfg = trecon.ReconStepConfig(on_pure_noise=noise, do_adv_attack=adv,
                                  recon_face_align_loss_thres=thres, compute_dtype="float32",
                                  num_priming_steps=PRIMING)
    _, tr = handed_rand(jb, rcfg)
    opt = topt.make_optimizer("cadamw", tstep.trainable_parameters(tparams), 0.0,
                              warmup_steps=0, total_steps=10)
    grads = {}
    real_step = opt.step

    def capture():
        for part in ("sbg", "unet"):
            grads[part] = {n: p.grad.clone() for n, p in tparams[part].named_parameters()
                           if p.grad is not None}
        return real_step()

    opt.step = capture
    step = tstep.make_train_step(
        trecon.make_recon_loss_fn(rcfg, HostFaceDetector(detector_fn=fixed_faces)), tfrozen,
        tsched.DiffusionSchedule.create(), tcfg)
    _, metrics = step(tstep.init_state(tparams, opt), dict(tb, recon_rand=tr))
    assert set(metrics) == set(jmetrics)
    for key, ref in jmetrics.items():
        assert_rel(metrics[key].item(), ref, GRAD_REL_L2 if key == "grad_norm" else 1e-5, key)
    assert jmetrics["loss_arcface_align_recon"] > 0 and jmetrics["recon_face_detected_frac"] == 1
    for part, ref in (("sbg", jsbg), ("unet", junet_g)):
        names = sorted(grads[part])
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
        got = flat({n: g.numpy() for n, g in grads[part].items()})
        assert np.abs(got).max() > 0
        assert rel_l2(got, flat(ref)) <= GRAD_REL_L2, part
    # nothing moved (lr 0), and the UNet's gradient reached its every tensor
    assert len(grads["unet"]) == len(list(tparams["unet"].parameters()))


def test_single_step_recon_loss_fn_matches_jax(stacks):
    """The single-step `recon_loss_fn` of `train_step.py` (the subject
    denoise with the last up block's capture and the self-attention key
    mask, the no-grad class anchor, the mb-suppress loss), the whole UNet
    trainable, through `make_train_step` on both sides: the loss and its
    parts, and the gradients of the SubjBasisGenerator and of the UNet."""
    (jfrozen, jtrain, jcfg, _), (tfrozen, tparams, tcfg), jb, tb = stacks
    opt = optax.chain(_keep_grads(), optax.set_to_zero())
    step = jstep.make_train_step(jstep.recon_loss_fn, opt, jfrozen,
                                 jsched.DiffusionSchedule.create(), jcfg, donate=False)
    state, jmetrics = step(jstep.init_state(jtrain, opt), jb, jax.random.PRNGKey(0))
    g = state.opt_state[0]["g"]
    zeros = {k: jnp.zeros_like(v) if k in ("token_embedding", "position_embedding") else v
             for k, v in jfrozen["sbg_buffers"].items()}
    ref = {"sbg": _jax_sbg_state_dict(g["sbg"], zeros, tparams["sbg"].state_dict()),
           "unet": bridge.fuse_projections(bridge.state_dict(g["unet"]),
                                           tparams["unet"].state_dict())}
    topt_ = topt.make_optimizer("cadamw", tstep.trainable_parameters(tparams), 0.0,
                                warmup_steps=0, total_steps=10)
    grads = {}
    real_step = topt_.step

    def capture():
        for part in ("sbg", "unet"):
            grads[part] = {n: p.grad.clone() for n, p in tparams[part].named_parameters()
                           if p.grad is not None}
        return real_step()

    topt_.step = capture
    tstep_fn = tstep.make_train_step(tstep.recon_loss_fn, tfrozen,
                                     tsched.DiffusionSchedule.create(), tcfg)
    _, metrics = tstep_fn(tstep.init_state(tparams, topt_), tb)
    assert set(metrics) == set(jmetrics) and float(jmetrics["loss_mb_suppress"]) > 0
    for key, r in jmetrics.items():
        assert_rel(metrics[key].item(), r, GRAD_REL_L2 if key == "grad_norm" else 1e-5, key)
    for part in ("sbg", "unet"):
        names = sorted(grads[part])
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
        assert rel_l2(flat({n: t.numpy() for n, t in grads[part].items()}),
                      flat(ref[part])) <= GRAD_REL_L2, part
