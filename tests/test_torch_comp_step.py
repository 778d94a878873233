"""The Stage-2 iteration of the PyTorch port against the JAX package, on the
CPU: `comp_distill_loss_fn` through `make_train_step` on both sides, with
the identity family (a tiny VAE decoder, a smooth face tower, an injected
detector of fixed faces) and without it (the fallback on the batch's
boxes). The adapters in the recon and unet-distill losses, `Trainer.fit`
over a Stage-2 plan and the CLI are in `tests/test_torch_comp.py`.

Tiny towers in fp32: the two-level UNet of `tests/test_torch_comp.py` with
adapters at rank 4, 16x16 latents, one priming and two denoising steps,
batch 2 (UNet batch 8 in the conditional call). JAX's draws are handed over
(`batch["comp_rand"]`, `batch["redenoise_rand"]`); the host detector
returns the same faces whatever the pixels (`fixed_faces`), so both sides
take the same branches; a third variant mixes the sc / mc attention
matrices (`mix_sc_mc_attn`). The face embedding is `SmoothTower` on both sides (patched into
the JAX module), as in `tests/test_torch_recon_step.py`: gradients through
a random ArcFace's kinks are not comparable across packages. Each JAX
variant is compiled once, for the module.

Tolerances: the loss and every metric 1e-5 relative; the gradients of the
SubjBasisGenerator and of each adapter 1e-4 relative L2 over each set; the
adapters' unused parts (the k / v adapters, the other FFN names) exactly 0
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import comp_step as jcomp
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import prompt_batch as jpb
from adaface_tpu.train.face_detect import HostFaceDetector as JDetector
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.train import comp_step as tcomp
from adaface_tpu_torch.train import prompt_batch as tpb
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from tests.test_torch_comp import (TRAINED, assert_step_matches, fixed_faces,  # noqa: F401
                                   jax_grads_state_dicts, jax_step, one_torch_thread, port_step,
                                   with_adapters)
from tests.test_torch_models import D, VAE_KW, numpy_params
from tests.test_torch_recon import SmoothTower, arcface_params

GRAD_REL_L2 = 1e-4
B, HW, PX = 2, 16, 64
COMP_KW = dict(num_priming_steps=1, num_denoising_steps=2, compute_dtype="float32")


def comp_batch(jm, tm, seed: int = 124):
    """The same 5-block comp batch for both sides (numpy)."""
    rs = np.random.RandomState(seed)
    ph = jm.expand_placeholder(jm.placeholders[0])
    assert ph == tm.expand_placeholder(tm.placeholders[0])
    ss = [f"a photo of {ph}"] * B
    sc = [f"a photo of {ph} riding a bike"] * B
    cs = ["a photo of a young woman"] * B
    cc = ["a photo of a young woman riding a bike"] * B
    rep = jpb.make_comp_rep_prompts(sc, ["cinematic"] * B, ["riding a bike"] * B)
    assert rep == tpb.make_comp_rep_prompts(sc, ["cinematic"] * B, ["riding a bike"] * B)
    jb = jpb.build_comp_prompt_batch(jm, ss, sc, rep, cs, cc)
    tb = tpb.build_comp_prompt_batch(tm, ss, sc, rep, cs, cc)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    fg = np.ones((B, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    batch = dict(jb, noise=rs.randn(B, 4, HW, HW).astype(np.float32),
                 x_start=rs.randn(B, 4, HW, HW).astype(np.float32),
                 img_prompt_embs=rs.randn(B, 16, D).astype(np.float32),
                 clip_skip_weights=rs.dirichlet([1.0, 2.0, 2.0]).astype(np.float32),
                 clip_skip_weights_fixed=np.array([0.2, 0.4, 0.4], np.float32), fg_mask=fg,
                 ss_face_bboxes=np.array([[2, 2, 12, 12], [3, 1, 14, 11]], np.float32),
                 sc_face_bboxes=np.array([[4, 3, 11, 13], [2, 2, 12, 12]], np.float32),
                 sc_fg_mask_percent=np.float32(0.23),
                 ref_images=np.clip(rs.randn(B, 3, PX, PX) * 0.4, -1, 1).astype(np.float32),
                 ref_face_bboxes=np.array([[8, 8, 40, 40], [4, 10, 60, 58]], np.float32),
                 ref_face_detected=np.ones((B,), np.float32),
                 comp_sc_face_detected_mean=np.float32(0.9),
                 comp_sc_face_detected_n=np.float32(10.0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype.kind in "iu"
              else torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jbatch, tbatch


def handed_rand(jb, ccfg):
    """JAX's draws of the iteration, for both sides: `sample_comp_rand` from
    one key and the re-denoise's two normals."""
    sched = jsched.DiffusionSchedule.create()
    jr = jcomp.sample_comp_rand(jax.random.PRNGKey(7), jb["noise"], sched, ccfg)
    rs = np.random.RandomState(125)
    shape = (ccfg.num_denoising_steps, B, 4, HW, HW)
    red = {"x": rs.randn(*shape).astype(np.float32), "n": rs.randn(*shape).astype(np.float32)}
    tr = {k: torch.from_numpy(np.array(v)) for k, v in jr.items()}
    tr["prime_t0"], tr["den_t0"] = tr["prime_t0"].long(), tr["den_t0"].long()
    tr["prime_cfg_scale"] = float(jr["prime_cfg_scale"])
    return (dict(comp_rand=jr, redenoise_rand={k: jnp.asarray(v) for k, v in red.items()}),
            dict(comp_rand=tr, redenoise_rand={k: torch.from_numpy(v) for k, v in red.items()}))


@pytest.fixture(scope="module")
def stacks():
    with pytest.MonkeyPatch.context() as mp:
        smooth = SmoothTower()
        mp.setattr(jfl, "arcface_embed", smooth.jax_embed)
        yield build_stacks(smooth)


def build_stacks(tower):
    """(JAX frozen, trainable, TrainConfig; the port's frozen, params,
    TrainConfig; the JAX and port batches) on one set of tiny weights, both
    adapters trained."""
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = with_adapters(120)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**VAE_KW)), 122)
    jfrozen = dict(jfrozen, vae=vae_p, arcface=arcface_params(123))
    tfrozen = dict(tfrozen, vae=bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                                            bridge.vae_decoder_tree(vae_p)), arcface=tower)
    jb, tb = comp_batch(jm, tm)
    return (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm), jb, tb


COMP_VARIANTS = ["identity", "fallback", "mix"]
# `mix_sc_mc_attn`: three UNet calls a step ([sc, mc] with mixed attention
# matrices), the captures joined; no adapter and no normalization run, so
# only the SubjBasisGenerator has a gradient
VARIANT_KW = {"mix": dict(mix_sc_mc_attn=True)}


def fixed_detections(ccfg):
    """`fixed_faces` on every decode of a comp step, in the batch layout of
    the JAX package's precomputed detections (`comp_detections_to_batch`):
    the JAX graph then has no host callback, and its compilation is cached;
    the port detects inline with the same detector."""
    s = ccfg.num_denoising_steps
    det = JDetector(detector_fn=fixed_faces, max_bg=ccfg.max_bg_faces)
    frames = lambda n: np.zeros((n, 3, PX, PX), np.float32)  # noqa: E731
    return jcomp.comp_detections_to_batch(det(frames(s * B + B)), det(frames(s * B)),
                                          det(frames(s * B)), s, B, ccfg.max_bg_faces)


@pytest.fixture(scope="module")
def jax_comp_results(stacks):
    (jfrozen, jtrain, jcfg, _), (_, tparams, _, _), jb, _ = stacks
    out = {}
    for label in COMP_VARIANTS:
        ccfg = jcomp.CompDistillConfig(vae_cfg=jvae.VAEConfig(**VAE_KW), **COMP_KW,
                                       **VARIANT_KW.get(label, {}))
        hand, _ = handed_rand(jb, ccfg)
        if label == "identity":
            frozen, hand = jfrozen, dict(hand, comp_face_dets=fixed_detections(ccfg))
        else:
            frozen = {k: v for k, v in jfrozen.items() if k not in ("vae", "arcface")}
        metrics, g = jax_step(lambda *a, c=ccfg: jcomp.comp_distill_loss_fn(*a, comp_cfg=c),
                              frozen, jtrain, jcfg, dict(jb, **hand))
        out[label] = metrics, jax_grads_state_dicts(g, jfrozen, tparams)
    return out


@pytest.mark.parametrize("label", COMP_VARIANTS)
def test_comp_distill_step_matches_jax(stacks, jax_comp_results, label):
    """One comp step through `make_train_step` with JAX's draws handed over:
    the loss and every metric, and the gradients of the SubjBasisGenerator
    and of both adapters; with the identity family live (every align gate
    open: the injected faces are confident), without the face towers, and
    with the sc / mc attention mixed (no adapter runs: their gradients are
    exactly 0 on both sides)."""
    _, (tfrozen, tparams, tcfg, _), jb, tb = stacks
    jmetrics, jgrads = jax_comp_results[label]
    ccfg = tcomp.CompDistillConfig(**COMP_KW, **VARIANT_KW.get(label, {}))
    det = HostFaceDetector(detector_fn=fixed_faces) if label == "identity" else None
    frozen = tfrozen if det else {k: v for k, v in tfrozen.items() if k not in ("vae", "arcface")}
    _, hand = handed_rand(jb, jcomp.CompDistillConfig(**COMP_KW))
    metrics, grads = port_step(tcomp.make_comp_loss_fn(ccfg, det), frozen, tparams, tcfg,
                               dict(tb, **hand))
    if label == "identity":
        assert jmetrics["loss_arcface_align_comp"] > 0 and jmetrics["comp_sc_face_detected"] == 1
    else:
        assert jmetrics["loss_mb_suppress"] >= 0 and "loss_arcface_align_comp" not in jmetrics
    if label == "mix":
        for part in ("attn_lora", "ffn_lora"):
            for n, g in grads[part].items():
                assert not g.any() and not np.asarray(jgrads[part][n]).any(), (part, n)
        assert_step_matches(metrics, grads, jmetrics, jgrads, ("sbg",))
    else:
        assert_step_matches(metrics, grads, jmetrics, jgrads, TRAINED)
