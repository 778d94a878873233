"""The port's data-parallel unet-distill step on the CPU: two gloo ranks
(one `torch.multiprocessing` spawn for the file, `tests/torch_dp_workers.py`),
fp32, the tiny towers of `tests/test_torch_train.py`, against JAX's
single-device step on the combined batch of 4: one step, and a 2-step
teacher chain folded into the batch (the cases of
`tests/test_train.py:322-359` at dp=2). The loss and its parts to 1e-5
relative, the gradients to 1e-4 relative L2 (the bound of
`test_unet_distill_step_matches_jax`), the parameters after one cautious
AdamW update to 1e-5; the two ranks' gradients and parameters equal bit for
bit. `dp_batch` and `jax_step` serve `tests/test_torch_dp_recon.py` too.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import optimizers as jopt
from adaface_tpu.train import prompt_batch as jpb
from adaface_tpu.train import train_step as jstep
from adaface_tpu_torch.train import prompt_batch as tpb
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import (GRAD_REL_L2, LR, _jax_sbg_state_dict, _keep_grads,
                                    assert_rel, build_step_pair, rel_l2)
from tests.torch_dp_workers import dp_cases, run_ranks

SUBJ = ["a photo of z, , , , , , , , , , , , , , , , in a park",
        "z, , , , , , , , , , , , , , , , smiling"]
CLS = ["a photo of a young woman, in a park", "a young woman, smiling"]
HW = 16


def dp_batch(jm, tm, b: int, multi: int, seed: int, extra: dict | None = None):
    """make_batch's step batch at batch b (the two prompt pairs repeated),
    with `extra` numpy leaves → (JAX batch, port batch)."""
    rs = np.random.RandomState(seed)
    subj, cls = SUBJ * (b // 2), CLS * (b // 2)
    jb = jpb.build_4block_prompt_batch(jm, subj, subj, cls, cls)
    tb = tpb.build_4block_prompt_batch(tm, subj, subj, cls, cls)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    batch = dict(jb)
    batch.update(x_start=rs.randn(b, 4, HW, HW).astype(np.float32),
                 img_prompt_embs=rs.randn(b, 16, 64).astype(np.float32),
                 clip_skip_weights=rs.dirichlet([1.0, 2.0, 2.0]).astype(np.float32))
    if multi:
        batch.update(teacher_x_ts=rs.randn(multi, b, 4, HW, HW).astype(np.float32),
                     teacher_ts=rs.randint(500, 900, (multi, b)).astype(np.int32),
                     teacher_noise_preds=rs.randn(multi, b, 4, HW, HW).astype(np.float32))
    else:
        batch.update(noise=rs.randn(b, 4, HW, HW).astype(np.float32),
                     t=rs.randint(300, 900, (b,)).astype(np.int32),
                     teacher_noise_pred=rs.randn(b, 4, HW, HW).astype(np.float32))
    batch.update(extra or {})
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tbatch = {k: v.long() if v.dtype in (torch.int32, torch.int64) else v
              for k, v in tbatch.items()}
    return jbatch, tbatch


def jax_step(loss_fn, jfrozen, jtrain, jcfg, jbatch, tparams):
    """JAX's single-device step with cautious AdamW → (metrics, the
    SubjBasisGenerator's gradients and parameters after, as port state
    dicts)."""
    opt = optax.chain(_keep_grads(), jopt.make_optimizer("cadamw", LR, warmup_steps=0,
                                                         total_steps=10))
    step = jstep.make_train_step(loss_fn, opt, jfrozen, jsched.DiffusionSchedule.create(),
                                 jcfg, donate=False)
    state, metrics = step(jstep.init_state(jtrain, opt), jbatch, jax.random.PRNGKey(0))
    ref = tparams["sbg"].state_dict()
    zeros = {k: jnp.zeros_like(v) if k in ("token_embedding", "position_embedding") else v
             for k, v in jfrozen["sbg_buffers"].items()}
    return ({k: float(v) for k, v in metrics.items()},
            _jax_sbg_state_dict(state.opt_state[0]["g"]["sbg"], zeros, ref),
            _jax_sbg_state_dict(state.params["sbg"], jfrozen["sbg_buffers"], ref))


DISTILL = {"distill_1step": (0, 61), "distill_chain2": (2, 62)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and both ranks' results of each case, one spawn."""
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair()
    refs, payload = {}, {}
    for name, (multi, seed) in DISTILL.items():
        jb, tb = dp_batch(jm, tm, 4, multi, seed)
        refs[name] = jax_step(jstep.unet_distill_loss_fn, jfrozen, jtrain, jcfg, jb, tparams)
        payload[name] = {"kind": "step", "loss": "unet_distill", "lr": LR, "cfg": tcfg,
                         "frozen": tfrozen, "params": copy.deepcopy(tparams), "batch": tb}
    tmp = tmp_path_factory.mktemp("dp")
    return refs, run_ranks(dp_cases, payload, str(tmp)), tparams


@pytest.mark.parametrize("name", sorted(DISTILL))
def test_unet_distill_2_ranks_match_jax_single_device(runs, name):
    refs, ranks, tparams = runs
    metrics_j, grads_j, params_j = refs[name]
    r0, r1 = ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    for key in ("loss", "loss_unet_distill", "loss_prompt_emb_delta"):
        assert_rel(r0["metrics"][key], metrics_j[key], what=key)
    assert_rel(r0["metrics"]["grad_norm"], metrics_j["grad_norm"], GRAD_REL_L2, "grad_norm")
    grads = r0["grads"]["sbg"]
    names = sorted(grads)
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
    assert rel_l2(flat({n: g.numpy() for n, g in grads.items()}), flat(grads_j)) <= GRAD_REL_L2
    for n in names:  # the ranks were handed the same summed gradients
        assert torch.equal(grads[n], r1["grads"]["sbg"][n]), n
    moved = 0.0
    for n, p in r0["params"]["sbg"].items():
        assert torch.equal(p, r1["params"]["sbg"][n]), n
        assert_rel(p.numpy(), params_j[n], what=n)
        moved = max(moved, float((p - tparams["sbg"].state_dict()[n]).abs().max()))
    assert moved > LR / 2
