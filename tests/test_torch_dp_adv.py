"""The recon iteration's adversarial branch under data parallelism, on the
CPU: two gloo ranks (one `torch.multiprocessing` spawn for the file,
`tests/torch_dp_workers.py`), fp32, tiny towers, a global batch of 4.

The branch attacks the global batch's first nb = min(adv_bs, 4) instances:
at adv_bs 2 rank 0 holds every attacked row and rank 1 none (it still joins
the reductions), at adv_bs 3 they span both ranks, at adv_bs 4 an
undetected input on rank 1 turns the attack off on both.

- `recon_loss_fn_v2` on images with `do_adv_attack` (the identity losses
  live: a host detector that finds the same faces whatever the pixels, a
  smooth face tower) against the port's own single process on the whole
  batch, at adv_bs 2 and 3: loss and metrics to 1e-5 relative, gradients to
  1e-5 relative L2, parameters after one cautious AdamW update to 1e-5;
- `_adv_attacked_noise` alone: each rank's adjusted rows equal to the
  single process's slice, to 1e-6;
- the port's single-process adversarial noise against JAX's
  `_adv_attacked_noise` on the same inputs and draws (JAX's dropout key
  handed over as the uniforms its bernoulli reads), to 1e-5 relative L2.
  `tests/test_torch_recon_step.py` holds the whole step with the branch
  against JAX, not the noise itself.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import vae as jvae
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.train import recon_step as trecon
from tests.test_torch_dp_distill import HW, dp_batch
from tests.test_torch_models import VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_recon import RECON_UNET_KW, SmoothTower
from tests.test_torch_train import LR, assert_rel, build_step_pair, rel_l2
from tests.torch_dp_workers import SmoothFace, _step_case, adv_noise_case, dp_cases, run_ranks

PX = 64
B = 4
STEP_ADV_BS = (2, 3)
NOISE_ADV_BS = (2, 3, 4)


def adv_extra(seed: int) -> dict:
    """What a recon batch carries beyond the step batch: masks (a masked key
    column, half the fg off), the input pixels and their faces (the last
    instance undetected: outside the first 3, inside the first 4)."""
    rs = np.random.RandomState(seed)
    img_mask = np.ones((B, 1, HW, HW), np.float32)
    img_mask[1, :, :, -3:] = 0.0
    fg = np.ones((B, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    fg[2, :, :3] = 0.0
    return {"img_mask": img_mask, "fg_mask": fg,
            "ref_images": np.clip(rs.randn(B, 3, PX, PX) * 0.4, -1, 1).astype(np.float32),
            "ref_face_bboxes": np.array([[8, 8, 40, 40], [4, 10, 60, 58], [12, 6, 56, 52],
                                         [10, 12, 50, 56]], np.float32),
            "ref_face_detected": np.array([1, 1, 1, 0], np.float32),
            "recon_attn_lora_gate": np.float32(0.0)}


def noise_rand(adv_bs: int, seed: int) -> tuple[dict, dict]:
    """The branch's draws from one JAX key: JAX's dict, and the port's (the
    dropout as the uniforms JAX's bernoulli reads)."""
    key, ukey = jax.random.split(jax.random.PRNGKey(seed))
    nb = min(adv_bs, B)
    u = float(jax.random.uniform(ukey))
    return ({"adv_dropout_key": key, "adv_uniform": jnp.float32(u)},
            {"adv_dropout_u": torch.from_numpy(np.array(jax.random.uniform(key, (nb, 512)))),
             "adv_uniform": u})


@pytest.fixture(scope="module")
def stacks():
    (_, _, _, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair(seed=90,
                                                                  unet_kw=RECON_UNET_KW)
    jb, tb = dp_batch(jm, tm, B, 0, 63, adv_extra(64))
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**VAE_KW)), 91)
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                      bridge.vae_decoder_tree(vae_p))
    noise = np.random.RandomState(65).randn(B, 4, HW, HW).astype(np.float32)
    return tfrozen, tparams, tcfg, jb, tb, vae_p, vae, noise


@pytest.fixture(scope="module")
def runs(stacks, tmp_path_factory):
    tfrozen, tparams, tcfg, _, tb, _, vae, noise = stacks
    frozen = dict(tfrozen, vae=vae, arcface=SmoothFace())
    refs, payload = {}, {}
    for adv_bs in STEP_ADV_BS:
        rcfg = trecon.ReconStepConfig(num_priming_steps=2, compute_dtype="float32",
                                      recon_face_align_loss_thres=-1.0, do_adv_attack=True,
                                      adv_bs=adv_bs)
        payload[f"step_adv{adv_bs}"] = {"kind": "step", "loss": "recon_v2", "rcfg": rcfg,
                                        "lr": LR, "cfg": tcfg, "frozen": frozen,
                                        "params": copy.deepcopy(tparams), "batch": tb,
                                        "draws": 7}
    for adv_bs in NOISE_ADV_BS:
        rcfg = trecon.ReconStepConfig(do_adv_attack=True, adv_bs=adv_bs)
        payload[f"noise_adv{adv_bs}"] = {"kind": "adv_noise", "frozen": frozen, "batch": tb,
                                         "noise": torch.from_numpy(noise),
                                         "rand": noise_rand(adv_bs, 66)[1], "rcfg": rcfg}
    for name, case in payload.items():
        single = _step_case if case["kind"] == "step" else adv_noise_case
        refs[name] = single(copy.deepcopy(case), None)
    tmp = tmp_path_factory.mktemp("dp_adv")
    return refs, run_ranks(dp_cases, payload, str(tmp)), noise


def _flat(d: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(d[n]).ravel() for n in names])


@pytest.mark.parametrize("adv_bs", STEP_ADV_BS)
def test_adv_recon_2_ranks_match_single_process(runs, adv_bs):
    refs, ranks, _ = runs
    name = f"step_adv{adv_bs}"
    ref, r0, r1 = refs[name], ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(ref["metrics"])
    for key, want in ref["metrics"].items():
        assert_rel(r0["metrics"][key], want, 1e-5, key)
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


@pytest.mark.parametrize("adv_bs", NOISE_ADV_BS)
def test_adv_noise_2_ranks_match_single_process(runs, adv_bs):
    refs, ranks, noise = runs
    name = f"noise_adv{adv_bs}"
    ref = refs[name].numpy()
    got = np.concatenate([ranks[0][name].numpy(), ranks[1][name].numpy()])
    assert got.shape == ref.shape == noise.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    moved = np.abs(ref - noise).reshape(B, -1).max(1)
    nb = min(adv_bs, B)
    if adv_bs < B:  # the first nb rows attacked, the others untouched
        assert (moved[:nb] > 1e-4).all() and (moved[nb:] == 0).all(), moved
    else:  # the last input's face went undetected: no attack anywhere
        assert (moved == 0).all(), moved


@pytest.mark.parametrize("adv_bs", (2, 3))
def test_adv_noise_matches_jax(stacks, adv_bs):
    """The single process's attacked noise against JAX's, same inputs and
    draws, the face embedding `SmoothTower` on both sides."""
    tfrozen, _, _, jb, tb, vae_p, vae, noise = stacks
    smooth = SmoothTower()
    jrand, trand = noise_rand(adv_bs, 67)
    jcfg = jrecon.ReconStepConfig(do_adv_attack=True, adv_bs=adv_bs,
                                  vae_cfg=jvae.VAEConfig(**VAE_KW))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfl, "arcface_embed", smooth.jax_embed)
        want = np.asarray(jax.jit(lambda bt, n: jrecon._adv_attacked_noise(
            {"arcface": None, "vae": vae_p}, bt, jrand, n, jcfg, HW))(
                jb, jnp.asarray(noise)))
    rcfg = trecon.ReconStepConfig(do_adv_attack=True, adv_bs=adv_bs)
    got = trecon._adv_attacked_noise({"arcface": smooth, "vae": vae}, tb, trand,
                                     torch.from_numpy(noise), rcfg, HW).numpy()
    nb = min(adv_bs, B)
    assert np.abs(want[:nb] - noise[:nb]).max() > 1e-4  # the attack is live
    np.testing.assert_array_equal(got[nb:], noise[nb:])
    assert rel_l2(got[:nb] - noise[:nb], want[:nb] - noise[:nb]) <= 1e-5
    assert rel_l2(got, want) <= 1e-5
