"""The recon iteration's two phases in the PyTorch port against the JAX
package, on the CPU: the collect pass (`recon_loss_fn_v2(collect_mode=True)`)
on images, on pure noise and with the adversarial branch; the downsizer of
its detection frames against `jax.image.resize`; the host side of the split
(`detect_frames`, `detections_to_batch`); the train phase's loss and metrics
with the same detections handed in; the draws both phases share
(`Draws.fork`) and the constants a step reads without a host copy
(`device_constant`). The two-phase step and the pipelined runner are
`tests/test_torch_recon_pipelined.py`'s.

The stacks are `tests/test_torch_recon_step.py`'s (tiny towers in fp32, 16x16
latents decoded to 64x64, the UNet trainable beside the SubjBasisGenerator,
`SmoothTower` for ArcFace on both sides) with JAX's draws handed over in
`batch["recon_rand"]`. The collect pass here downsizes its 64x64 decodes to
32x32 frames, so the resize runs on the recon path too. Each JAX side is
jitted once a case (eager JAX runs the interpreted flash kernels op by op).

Tolerances: the collect's predictions and its primed state 1e-5 relative to
their largest magnitude, the timesteps equal; the uint8 frames within one
level, on at most 0.1% of the values (a float a rounding apart truncates to
the next level); the downsizer 1e-5; the train phase's loss and metrics
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu.train.face_detect import HostFaceDetector as JDetector
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.train import recon_step as trecon
from adaface_tpu_torch.train.face_detect import HostFaceDetector, detect_frames
from adaface_tpu_torch.utils.tensor import Draws, device_constant
from tests.test_torch_recon import SmoothTower
from tests.test_torch_recon_step import PRIMING, build_stacks, fixed_faces, handed_rand
from tests.test_torch_train import assert_rel
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

FRAME_PX = 32  # the collect's frames: the 64x64 decodes downsized
# (label, on pure noise, adversarial branch)
CASES = [("images", False, False), ("pure_noise", True, False), ("adversarial", False, True)]


@pytest.fixture(scope="module")
def stacks():
    with pytest.MonkeyPatch.context() as mp:
        smooth = SmoothTower()
        mp.setattr(jfl, "arcface_embed", smooth.jax_embed)
        yield build_stacks(smooth)


def configs(noise: bool, adv: bool, vae_cfg, px: int = FRAME_PX, thres: float = -1.0):
    """The JAX and the port's ReconStepConfig of a case."""
    kw = dict(on_pure_noise=noise, do_adv_attack=adv, compute_dtype="float32",
              num_priming_steps=PRIMING, collect_px_size=px, recon_face_align_loss_thres=thres)
    return jrecon.ReconStepConfig(vae_cfg=vae_cfg, **kw), trecon.ReconStepConfig(**kw)


_COLLECTED = {}


def jax_collect(jtrain, jfrozen, jb, jcfg, jr_cfg):
    """JAX's collect pass, jitted, the frozen towers closed over; once a
    case for the module (the train phase reads the collect test's)."""
    key = (jr_cfg.on_pure_noise, jr_cfg.do_adv_attack)
    if key not in _COLLECTED:
        sched = jsched.DiffusionSchedule.create()
        fn = jax.jit(lambda params, batch: jrecon.recon_loss_fn_v2(
            params, jfrozen, batch, sched, jcfg, jax.random.PRNGKey(0), rcfg=jr_cfg,
            collect_mode=True)[1])
        _COLLECTED[key] = fn(jtrain, jb)
    return _COLLECTED[key]


def port_collect(tparams, tfrozen, tb, tcfg, rcfg):
    with torch.no_grad():
        return trecon.recon_loss_fn_v2(tparams, tfrozen, tb, tsched.DiffusionSchedule.create(),
                                       tcfg, None, rcfg=rcfg, collect_mode=True)[1]


def assert_close(got: torch.Tensor, ref, tol: float, what: str):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, what
    err = np.abs(got.numpy().astype(np.float64) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), (what, err)


def assert_frames(got: torch.Tensor, ref):
    got, ref = got.numpy().astype(np.int16), np.asarray(ref).astype(np.int16)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    diff = np.abs(got - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("label,noise,adv", CASES)
def test_collect_matches_jax(stacks, label, noise, adv):
    """The collect pass's frames, class and unconditional predictions (and
    on pure noise the primed latents and timesteps) against JAX's."""
    (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb = stacks
    jr_cfg, rcfg = configs(noise, adv, vae_cfg)
    jr, tr = handed_rand(jb, jr_cfg)
    ref = jax_collect(jtrain, jfrozen, dict(jb, recon_rand=jr), jcfg, jr_cfg)
    out = port_collect(tparams, tfrozen, dict(tb, recon_rand=tr), tcfg, rcfg)
    assert set(ref) <= set(out) and out["decode_px"] == 64
    assert tuple(out["recon_px"].shape) == (2, 2, FRAME_PX, FRAME_PX, 3)
    assert out["recon_px"].dtype == torch.uint8
    assert_frames(out["recon_px"], ref["recon_px"])
    for key in ("eps_cls", "eps_un") + (("x_primed",) if noise else ()):
        assert_close(out[key], ref[key], 1e-5, key)
    if noise:
        np.testing.assert_array_equal(out["t_primed"].numpy(), np.asarray(ref["t_primed"]))
    else:
        assert "x_primed" not in ref and "x_primed" not in out


@pytest.mark.parametrize("shape,size", [((2, 3, 64, 64), 32), ((1, 3, 512, 512), 256),
                                        ((2, 3, 96, 96), 40)])
def test_downsize_matches_jax_resize(shape, size):
    """The frames' resize against `jax.image.resize(..., "linear")` in fp32
    (antialiased when it shrinks), and the uint8 frames against JAX's
    clip-and-truncate of it."""
    px = np.clip(np.random.RandomState(size).randn(*shape) * 0.6, -1.2, 1.2).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(px), (*shape[:2], size, size), "linear")
    got = trecon.resize_frames(torch.from_numpy(px), size)
    assert_close(got, ref, 1e-5, "resize")
    want = np.asarray(jnp.clip((ref.transpose(0, 2, 3, 1) + 1.0) * 127.5, 0, 255)
                      .astype(jnp.uint8))
    assert_frames(trecon.downsize_frames(torch.from_numpy(px), size), want)
    # no resize at or under the size, nor at size 0
    small = torch.from_numpy(px[..., :size, :size])
    assert torch.equal(trecon.resize_frames(small, size), small)
    assert torch.equal(trecon.resize_frames(torch.from_numpy(px), 0), torch.from_numpy(px))


def sized_faces(img):
    """Faces of several sizes around a detector's 20-pixel minimum and
    around what the frames shrink it to (by 4: 5 pixels), not in order of
    size."""
    h, w = img.shape[:2]
    return [(np.array([1, 1, 4, 5], np.float32), 0.4),
            (np.array([4, 6, 26, 27], np.float32), 0.8),
            (np.array([2, 2, 8, 9], np.float32), 0.9),
            (np.array([w - 20, h - 12, w - 1, h - 1], np.float32), 0.7),
            (np.array([10, 3, 16, 8], np.float32), 0.5)]


@pytest.mark.parametrize("scale", [1.0, 4.0, 2.5])
def test_detect_frames_and_batch_match_jax(scale):
    """`detect_frames` (the detector's minimum size shrunk into the frames'
    space for the call, the boxes scaled back) against JAX's `detect_on`
    arithmetic (`recon_step.py:594-617`) on its own detector, and
    `detections_to_batch` against JAX's; the port's detector keeps its
    minimum size."""
    s_steps, b = 2, 3
    frames = np.random.RandomState(3).randint(0, 256, (s_steps * b, 32, 32, 3)).astype(np.uint8)
    det = HostFaceDetector(detector_fn=sized_faces)
    got = detect_frames(det, frames, scale)
    assert det.min_size == 20
    jdet = JDetector(detector_fn=sized_faces)
    if scale != 1.0:
        jdet.min_size = max(1, int(round(20 / scale)))
    ref = jdet(frames)
    if scale != 1.0:
        ref.fg_bboxes, ref.bg_bboxes = ref.fg_bboxes * scale, ref.bg_bboxes * scale
    for key in ("fg_bboxes", "detected", "confidences", "bg_bboxes", "bg_valid"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.detected.any() and (scale == 1.0 or got.bg_valid.any())
    jb = jrecon.detections_to_batch(ref, s_steps, b, jdet.max_bg)
    tb = trecon.detections_to_batch(got, s_steps, b, det.max_bg)
    assert set(jb) == set(tb)
    for key in jb:
        assert tb[key].dtype == torch.float32
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)


def jax_phase_batch(jb, out, dets, s_steps, b):
    phase_a = {k: out[k] for k in ("eps_cls", "eps_un", "x_primed", "t_primed") if k in out}
    return dict(jb, recon_phase_a=phase_a,
                recon_face_dets=jrecon.detections_to_batch(dets, s_steps, b, 2))


@pytest.mark.parametrize("label,noise,adv", CASES[:2])
def test_train_phase_matches_jax(stacks, label, noise, adv):
    """The train phase's loss and metrics with the collect's output and one
    set of detections handed to both sides (the detector's on the port's
    frames, content-independent), against JAX's."""
    (jfrozen, jtrain, jcfg, vae_cfg), (tfrozen, tparams, tcfg), jb, tb = stacks
    jr_cfg, rcfg = configs(noise, adv, vae_cfg, thres=0.8 if noise else -1.0)
    jr, tr = handed_rand(jb, jr_cfg)
    jb, tb = dict(jb, recon_rand=jr), dict(tb, recon_rand=tr)
    ref_out = jax_collect(jtrain, jfrozen, jb, jcfg, jr_cfg)
    out = port_collect(tparams, tfrozen, tb, tcfg, rcfg)
    frames = out["recon_px"].numpy()
    s_steps, b = frames.shape[:2]
    dets = detect_frames(HostFaceDetector(detector_fn=fixed_faces),
                         frames.reshape(-1, *frames.shape[2:]), out["decode_px"] / FRAME_PX)
    sched = jsched.DiffusionSchedule.create()
    jloss = jax.jit(lambda params, batch: jrecon.recon_loss_fn_v2(
        params, jfrozen, batch, sched, jcfg, jax.random.PRNGKey(0), rcfg=jr_cfg)[1])
    ref = jloss(jtrain, jax_phase_batch(jb, ref_out, dets, s_steps, b))
    phase_a = {k: out[k] for k in ("eps_cls", "eps_un", "x_primed", "t_primed") if k in out}
    with torch.no_grad():
        _, metrics = trecon.recon_loss_fn_v2(
            tparams, tfrozen, dict(tb, recon_phase_a=phase_a,
                                   recon_face_dets=trecon.detections_to_batch(dets, s_steps, b)),
            tsched.DiffusionSchedule.create(), tcfg, None, rcfg=rcfg)
    assert set(metrics) == set(ref)
    for key, v in ref.items():
        assert_rel(metrics[key].item(), float(v), 1e-5, key)
    assert float(ref["loss_arcface_align_recon"]) > 0 and float(ref["recon_face_detected_frac"]) == 1


def test_collect_draws_equal_train_draws():
    """The collect pass takes its draws from a fork of the step's stream:
    the stream itself is left for the train phase, which draws the same
    values; handed draws alike."""
    d = Draws(generator=torch.Generator().manual_seed(4))
    f = d.fork()
    a = [f.normal((3,), "cpu"), f.uniforms((), "cpu"), f.integers((2,), 0, 9, "cpu")]
    b = [d.normal((3,), "cpu"), d.uniforms((), "cpu"), d.integers((2,), 0, 9, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h = Draws(handed=[np.ones(3, np.float32), 0.25])
    g = h.fork()
    assert torch.equal(g.normal((3,), "cpu"), h.normal((3,), "cpu"))
    assert g.uniform() == h.uniform() == 0.25


def test_device_constant_is_made_once_outside_inference_mode():
    """The constants a step reads (`utils.tensor.device_constant`) are made
    once per values, dtype and device, equal to `torch.tensor`'s, and,
    made first under `torch.inference_mode()`, still saved by autograd."""
    vals = (0.299, 0.587, 0.114)
    with torch.inference_mode():
        w = device_constant(vals, "cpu")
    assert not w.is_inference() and w is device_constant(list(vals), "cpu")
    assert torch.equal(w, torch.tensor(vals))
    ids = device_constant((3, 1, 4), "cpu", torch.long)
    assert ids.dtype == torch.long and ids is not device_constant((3, 1, 4), "cpu")
    x = torch.ones(3, requires_grad=True)
    (x * w).sum().backward()
    assert torch.equal(x.grad, w)
