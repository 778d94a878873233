"""The port's data-parallel recon steps on the CPU: two gloo ranks (one
`torch.multiprocessing` spawn for the file, `tests/torch_dp_workers.py`),
fp32, tiny towers, a global batch of 4.

- the single-step `recon_loss_fn` (the case of `tests/test_train.py:110-129`
  at dp=2, no perturbation) against JAX's single-device step on the
  combined batch: loss and parts to 1e-5 relative, gradients to 1e-4
  relative L2, parameters after one cautious AdamW update to 1e-5;
- the same loss with the ada embeddings' perturbation (its std over the
  global batch, its noise drawn for the global batch and sliced), and
  `recon_loss_fn_v2` on images (the UNet trained beside the
  SubjBasisGenerator) and on pure noise, with the identity losses live (a
  host detector that finds the same faces whatever the pixels, a smooth
  face tower), against the port's own single-process step on the whole
  batch: loss and metrics to 1e-5 relative, gradients to 1e-5 relative L2,
  parameters after the update to 1e-5. These losses divide by global
  counts: the fg/bg-weighted recon means, the masked background-suppression
  mean, the detected faces of the ArcFace alignment and the background
  faces, the prompt-delta cosine's weights.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from adaface_tpu.train import train_step as jstep
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.train import recon_step as trecon
from tests.test_torch_dp_distill import HW, dp_batch, jax_step
from tests.test_torch_models import VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_recon import RECON_UNET_KW
from tests.test_torch_train import GRAD_REL_L2, LR, assert_rel, build_step_pair, rel_l2
from tests.torch_dp_workers import SmoothFace, _step_case, dp_cases, run_ranks

PX = 64
B = 4


def recon_extra(seed: int) -> dict:
    """What a recon batch carries beyond the step batch: masks (a masked
    key column, half the fg off), the input pixels and their faces (one
    instance undetected), the adapters' gate."""
    rs = np.random.RandomState(seed)
    img_mask = np.ones((B, 1, HW, HW), np.float32)
    img_mask[1, :, :, -3:] = 0.0
    fg = np.ones((B, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    fg[3, :, :3] = 0.0
    return {"img_mask": img_mask, "fg_mask": fg, "face_detected": np.array([1, 1, 0, 1],
                                                                           np.float32),
            "ref_images": np.clip(rs.randn(B, 3, PX, PX) * 0.4, -1, 1).astype(np.float32),
            "ref_face_bboxes": np.array([[8, 8, 40, 40], [4, 10, 60, 58], [0, 0, 64, 64],
                                         [10, 12, 50, 56]], np.float32),
            "ref_face_detected": np.array([1, 1, 0, 1], np.float32),
            "recon_attn_lora_gate": np.float32(0.0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair(
        seed=90, unet_kw=RECON_UNET_KW)
    jb, tb = dp_batch(jm, tm, B, 0, 63, recon_extra(64))
    refs, payload = {}, {}
    jcfg0 = dataclasses.replace(jcfg, training_perturb_prob=0.0)
    tcfg0 = dataclasses.replace(tcfg, training_perturb_prob=0.0)
    refs["recon_vs_jax"] = jax_step(jstep.recon_loss_fn, jfrozen, jtrain, jcfg0, jb, tparams)
    payload["recon_vs_jax"] = {"kind": "step", "loss": "recon", "lr": LR, "cfg": tcfg0,
                               "frozen": tfrozen, "params": copy.deepcopy(tparams), "batch": tb}
    tcfg1 = dataclasses.replace(tcfg, training_perturb_prob=1.0)  # always perturbed
    payload["recon_perturbed"] = {"kind": "step", "loss": "recon", "lr": LR, "cfg": tcfg1,
                                  "frozen": tfrozen, "params": copy.deepcopy(tparams),
                                  "batch": tb, "draws": 5}
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), bridge.vae_decoder_tree(
        numpy_params(lambda k: __import__("adaface_tpu.models.vae", fromlist=["x"])
                     .init_vae_params(k, __import__("adaface_tpu.models.vae", fromlist=["x"])
                                      .VAEConfig(**VAE_KW)), 91)))
    frozen_v2 = dict(tfrozen, vae=vae, arcface=SmoothFace())
    for name, noise, unet in (("recon_v2_images", False, True),
                              ("recon_v2_pure_noise", True, False)):
        params = copy.deepcopy(tparams)
        frozen = dict(frozen_v2)
        if unet:  # finetuning: the UNet trains, a copy of its own
            frozen["unet"] = params["unet"] = copy.deepcopy(tfrozen["unet"])
        rcfg = trecon.ReconStepConfig(on_pure_noise=noise, num_priming_steps=2,
                                      compute_dtype="float32",
                                      recon_face_align_loss_thres=0.8 if noise else -1.0)
        payload[name] = {"kind": "step", "loss": "recon_v2", "rcfg": rcfg, "lr": LR,
                         "cfg": tcfg, "frozen": frozen, "params": params, "batch": tb,
                         "draws": 7}
    for name in ("recon_perturbed", "recon_v2_images", "recon_v2_pure_noise"):
        refs[name] = _step_case(copy.deepcopy(payload[name]), None)
    tmp = tmp_path_factory.mktemp("dp_recon")
    return refs, run_ranks(dp_cases, payload, str(tmp)), tparams


def _flat(d: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(d[n]).ravel() for n in names])


def test_recon_2_ranks_match_jax_single_device(runs):
    refs, ranks, tparams = runs
    metrics_j, grads_j, params_j = refs["recon_vs_jax"]
    r0, r1 = ranks[0]["recon_vs_jax"], ranks[1]["recon_vs_jax"]
    assert r0["metrics"] == r1["metrics"] and r0["metrics"]["loss_mb_suppress"] > 0
    for key, ref in metrics_j.items():
        assert_rel(r0["metrics"][key], ref, GRAD_REL_L2 if key == "grad_norm" else 1e-5, key)
    names = sorted(r0["grads"]["sbg"])
    assert rel_l2(_flat({n: g.numpy() for n, g in r0["grads"]["sbg"].items()}, names),
                  _flat(grads_j, names)) <= GRAD_REL_L2
    for n, p in r0["params"]["sbg"].items():
        assert torch.equal(p, r1["params"]["sbg"][n]), n
        assert_rel(p.numpy(), params_j[n], what=n)


@pytest.mark.parametrize("name", ["recon_perturbed", "recon_v2_images", "recon_v2_pure_noise"])
def test_recon_2_ranks_match_single_process(runs, name):
    refs, ranks, _ = runs
    ref, r0, r1 = refs[name], ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(ref["metrics"])
    for key, want in ref["metrics"].items():
        assert_rel(r0["metrics"][key], want, 1e-5, key)
    if name.startswith("recon_v2"):
        assert ref["metrics"]["loss_arcface_align_recon"] > 0  # the identity losses are live
    for part, grads in ref["grads"].items():
        names = sorted(grads)
        assert names == sorted(r0["grads"][part]), part
        assert rel_l2(_flat({n: g.numpy() for n, g in r0["grads"][part].items()}, names),
                      _flat({n: g.numpy() for n, g in grads.items()}, names)) <= 1e-5, part
    for part, sd in ref["params"].items():
        for n, p in sd.items():
            assert torch.equal(r0["params"][part][n], r1["params"][part][n]), n
            assert_rel(r0["params"][part][n].numpy(), p.numpy(), what=f"{part} {n}")
