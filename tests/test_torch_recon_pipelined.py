"""The port's two-phase recon step and its pipelined runner
(`make_two_phase_recon_step`, `make_pipelined_recon_runner`) on the CPU:
the two-phase step against the port's inline step, the runner against the
sequential two-phase steps at a learning rate of 0 (as JAX's
`tests/test_recon_step.py:252`), and at a learning rate above 0 over three
pushes and a flush against JAX's runner, in losses and final parameters.

`tests/test_torch_recon_step.py`'s stacks (tiny towers in fp32, `SmoothTower`
for ArcFace on both sides), the host detector of fixed boxes whatever the
pixels. JAX's runner trains the SubjBasisGenerator alone (one compile of its
collect and one of its train step); each push hands both sides the same
draws (`batch["recon_rand"]`, from JAX's key of the push).

Tolerances: the two-phase step against the inline one 1e-5 relative (the
collect runs the subject, class and unconditional rows in one UNet call,
the inline step in two); the runner against the sequential steps equal bit
for bit (the same computations in the same order); against JAX's runner the
losses and the SubjBasisGenerator's final parameters 1e-5 relative.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import optimizers as jopt
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu.train import train_step as jstep
from adaface_tpu.train.face_detect import HostFaceDetector as JDetector
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.train import optimizers as topt
from adaface_tpu_torch.train import recon_step as trecon
from adaface_tpu_torch.train import train_step as tstep
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from adaface_tpu_torch.utils.tensor import as_draws
from tests.test_torch_recon import SmoothTower
from tests.test_torch_recon_step import PRIMING, build_stacks, fixed_faces
from tests.test_torch_train import _jax_sbg_state_dict, assert_rel, rel_l2
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

CASES = [("images", False, False), ("pure_noise", True, False), ("adversarial", False, True)]
PUSHES = 3
LR = 1e-3


@pytest.fixture(scope="module")
def stacks():
    with pytest.MonkeyPatch.context() as mp:
        smooth = SmoothTower()
        mp.setattr(jfl, "arcface_embed", smooth.jax_embed)
        yield build_stacks(smooth)


def port_rcfg(noise: bool = False, adv: bool = False) -> trecon.ReconStepConfig:
    return trecon.ReconStepConfig(on_pure_noise=noise, do_adv_attack=adv,
                                  compute_dtype="float32", num_priming_steps=PRIMING,
                                  recon_face_align_loss_thres=-1.0)


def port_state(params, lr: float = 0.0):
    opt = topt.make_optimizer("adamw", tstep.trainable_parameters(params), lr,
                              warmup_steps=0, total_steps=10)
    return tstep.init_state(params, opt)


@pytest.mark.parametrize("label,noise,adv", CASES)
def test_two_phase_equals_inline_step(stacks, label, noise, adv):
    """The two-phase step (collect, detect on the frames, train) against the
    inline step, as JAX's `tests/test_recon_step.py:211` holds its pair: the
    decodes are no larger than `collect_px_size` (64 ≤ 256), so the
    detections are the same, and the loss, its parts and the gradients'
    norm agree. Both from one generator seed (the collect forks the step's
    stream); the learning rate is 0. Then the phases called one by one on
    one stream, as the runner calls them: the step's result bit for bit."""
    _, (tfrozen, tparams, tcfg), _, tb = stacks
    rcfg = port_rcfg(noise, adv)
    sched = tsched.DiffusionSchedule.create()
    det = HostFaceDetector(detector_fn=fixed_faces)
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    inline = tstep.make_train_step(trecon.make_recon_loss_fn(rcfg, det), tfrozen, sched, tcfg)
    _, ref = inline(port_state(tparams), tb, gen())
    two = trecon.make_two_phase_recon_step(rcfg, det, tfrozen, sched, tcfg)
    _, got = two(port_state(tparams), tb, gen())
    assert set(got) == set(ref)
    for key in ref:
        assert_rel(got[key].item(), ref[key].item(), 1e-5, key)
    assert ref["loss_arcface_align_recon"].item() > 0
    draws = as_draws(gen(), "cpu")
    out = two.collect(port_state(tparams), tb, draws)
    _, again = two.train(port_state(tparams), two.detect_on(out, tb), draws)
    for key in ref:
        assert again[key].item() == got[key].item(), key


def pushed_batches(jb, tb, rcfg):
    """PUSHES batches: the stack's batch with the draws of JAX's key i."""
    out = []
    for i in range(PUSHES):
        jr = jrecon.sample_recon_rand(jax.random.PRNGKey(100 + i), jb["x_start"],
                                      jsched.DiffusionSchedule.create(), rcfg)
        tr = {k: torch.from_numpy(np.array(jr[k])) for k in ("noises", "rel_ts", "x_start0")}
        tr["t0"] = torch.from_numpy(np.array(jr["t0"])).long()
        tr["adv_uniform"] = float(jr["adv_uniform"])
        tr["adv_dropout_u"] = torch.from_numpy(np.array(
            jax.random.uniform(jr["adv_dropout_key"], (2, 512))))
        out.append((dict(jb, recon_rand=jr), dict(tb, recon_rand=tr)))
    return out


@pytest.mark.parametrize("noise", [False, True])
def test_runner_equals_sequential_at_lr0(stacks, noise):
    """At a learning rate of 0 the parameters never move, so the pipelined
    stream (collect(N+1) before train(N)) gives the sequential two-phase
    steps' metrics bit for bit: push 0 returns nothing, pushes 1 and 2 return
    steps 0 and 1, the flush step 2; a second flush nothing."""
    (_, _, _, vae_cfg), (tfrozen, tparams, tcfg), jb, tb = stacks
    rcfg = port_rcfg(noise)
    jr_cfg = jrecon.ReconStepConfig(on_pure_noise=noise, num_priming_steps=PRIMING)
    batches = [t for _, t in pushed_batches(jb, tb, jr_cfg)]
    two = trecon.make_two_phase_recon_step(rcfg, HostFaceDetector(detector_fn=fixed_faces),
                                           tfrozen, tsched.DiffusionSchedule.create(), tcfg)
    state = port_state(tparams)
    seq = [two(state, b, torch.Generator().manual_seed(i))[1] for i, b in enumerate(batches)]
    runner = trecon.make_pipelined_recon_runner(two)
    pipe = []
    try:
        for i, b in enumerate(batches):
            out = runner.push(state, b, torch.Generator().manual_seed(i))
            assert (out is None) == (i == 0)
            if out is not None:
                pipe.append(out[1])
        pipe.append(runner.flush(state)[1])
        assert runner.flush(state) is None
    finally:
        runner.close()
    assert len(pipe) == PUSHES
    for got, ref in zip(pipe, seq):
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].item() == ref[key].item(), key


def sbg_only_stacks(stacks):
    """The stacks with the SubjBasisGenerator alone trainable (the UNet
    frozen), on both sides; the port's SubjBasisGenerator a copy."""
    (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb = stacks
    jtrain = {"sbg": jtrain["sbg"]}
    tparams = {"sbg": copy.deepcopy(tparams["sbg"])}
    return (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb


def test_runner_matches_jax_runner(stacks):
    """At a learning rate above 0 (AdamW, no warmup), three pushes and a
    flush of the port's runner against JAX's `make_pipelined_recon_runner`
    over its two-phase step, recon on images with one denoising step (one
    decode a step: the JAX graphs compile sooner), the SubjBasisGenerator
    trained: the three losses and the final parameters."""
    (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb = sbg_only_stacks(stacks)
    jr_cfg = jrecon.ReconStepConfig(vae_cfg=vae_cfg, compute_dtype="float32",
                                    num_denoising_steps=1, recon_face_align_loss_thres=-1.0)
    batches = pushed_batches(jb, tb, jr_cfg)
    sched = jsched.DiffusionSchedule.create()
    opt = jopt.make_optimizer("adamw", LR, warmup_steps=0, total_steps=10)
    jtwo = jrecon.make_two_phase_recon_step(jr_cfg, JDetector(detector_fn=fixed_faces), opt,
                                            jfrozen, sched, jcfg)
    jrunner = jrecon.make_pipelined_recon_runner(jtwo)
    jstate, ref = jstep.init_state(jtrain, opt), []
    for i, (b, _) in enumerate(batches):
        out = jrunner.push(jstate, b, jax.random.PRNGKey(i))
        if out is not None:
            jstate, m = out
            ref.append(float(m["loss"]))
    jstate, m = jrunner.flush(jstate)
    ref.append(float(m["loss"]))

    ref_sbg = {k: v.clone() for k, v in tparams["sbg"].state_dict().items()}
    two = trecon.make_two_phase_recon_step(
        dataclasses.replace(port_rcfg(), num_denoising_steps=1),
        HostFaceDetector(detector_fn=fixed_faces), tfrozen, tsched.DiffusionSchedule.create(),
        tcfg)
    runner = trecon.make_pipelined_recon_runner(two)
    state, got = port_state(tparams, LR), []
    try:
        for i, (_, b) in enumerate(batches):
            out = runner.push(state, b, torch.Generator().manual_seed(i))
            if out is not None:
                state, m = out
                got.append(m["loss"].item())
        state, m = runner.flush(state)
        got.append(m["loss"].item())
    finally:
        runner.close()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    want = _jax_sbg_state_dict(jstate.params["sbg"], jfrozen["sbg_buffers"], ref_sbg)
    moved, off = 0, {}
    for name, p in tparams["sbg"].state_dict().items():
        moved += not np.array_equal(ref_sbg[name].numpy(), p.numpy())
        if name.endswith("attn.k.bias"):
            # a key bias shifts every logit of a row alike: its gradient is 0
            # but for rounding, which AdamW scales up to whole steps
            continue
        err = rel_l2(p.numpy(), np.asarray(want[name]))
        if err > 1e-5:
            off[name] = err
    assert not off, off
    assert moved > 0


def test_detector_calls_take_turns_across_threads():
    """The batch-prefetch thread's input detection and a pipelined step's
    detection worker share one `HostFaceDetector`, whose backend need not be
    reentrant: calls from more threads than cores, with a short switch
    interval, never overlap inside the backend, and each gets its own
    result."""
    import os
    import sys
    import threading

    inside, overlaps = [0], []
    guard = threading.Lock()

    def backend(img):
        with guard:
            inside[0] += 1
            overlaps.append(inside[0] > 1)
        v = float(img[0, 0, 0])
        for _ in range(200):  # a few switch intervals inside the backend
            pass
        with guard:
            inside[0] -= 1
        return [(np.array([0, 0, 4 + v, 4 + v], np.float32), 1.0)]

    det = HostFaceDetector(detector_fn=backend, min_size=1)
    n = 4 * (os.cpu_count() or 1)
    got = [None] * n

    def work(i):
        frames = np.full((3, 64, 64, 3), i % 50, np.uint8)
        got[i] = det(frames).fg_bboxes[:, 2].tolist()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(overlaps) == 3 * n and not any(overlaps)
    assert got == [[4.0 + i % 50] * 3 for i in range(n)]
