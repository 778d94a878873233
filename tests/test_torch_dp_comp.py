"""The port's data-parallel comp-distill step on the CPU: two gloo ranks
(one `torch.multiprocessing` spawn for the file, `tests/torch_dp_workers.py`),
fp32, the tiny two-level UNet of `tests/test_torch_comp.py` with both
adapters trained at rank 4, one priming and two denoising steps, 16x16
latents, a global batch of 4 (UNet batch 8 a rank in the conditional call),
against the port's own single-process step on the whole batch: with the
identity family (a tiny VAE decoder, a smooth face tower, a host detector of
fixed confident faces) and without it (the fallback on the batch's boxes).
Every instance takes the global batch's first instance's ada embeddings and
its priming noise; the draws are the global batch's, sliced; the elastic
matching's means over the batch, the detection gates, the face-mask
fractions and every masked mean are global. The loss and every metric to
1e-5 relative, the gradients of the SubjBasisGenerator and of each adapter
to 1e-5 relative L2 over each set, the parameters after one cautious AdamW
update to 1e-5; the two ranks' parameters equal bit for bit.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.train import comp_step as tcomp
from adaface_tpu_torch.train import prompt_batch as tpb
from tests.test_torch_comp import with_adapters
from tests.test_torch_models import D, VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import LR, assert_rel, rel_l2
from tests.torch_dp_workers import SmoothFace, _step_case, dp_cases, run_ranks

B, HW, PX = 4, 16, 64
COMP_KW = dict(num_priming_steps=1, num_denoising_steps=2, compute_dtype="float32")


def comp_batch(tm, seed: int = 126) -> dict:
    """A 5-block comp batch of 4 (the port's tensors)."""
    rs = np.random.RandomState(seed)
    ph = tm.expand_placeholder(tm.placeholders[0])
    ss = [f"a photo of {ph}"] * B
    sc = [f"a photo of {ph} riding a bike", f"a photo of {ph} in a park"] * (B // 2)
    cs = ["a photo of a young woman"] * B
    cc = ["a photo of a young woman riding a bike", "a photo of a young woman in a park"] \
        * (B // 2)
    rep = tpb.make_comp_rep_prompts(sc, ["cinematic"] * B,
                                    ["riding a bike", "in a park"] * (B // 2))
    fg = np.ones((B, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    fg[2, :, :4] = 0.0
    batch = dict(tpb.build_comp_prompt_batch(tm, ss, sc, rep, cs, cc),
                 noise=rs.randn(B, 4, HW, HW).astype(np.float32),
                 x_start=rs.randn(B, 4, HW, HW).astype(np.float32),
                 img_prompt_embs=rs.randn(B, 16, D).astype(np.float32),
                 clip_skip_weights=rs.dirichlet([1.0, 2.0, 2.0]).astype(np.float32),
                 clip_skip_weights_fixed=np.array([0.2, 0.4, 0.4], np.float32), fg_mask=fg,
                 ss_face_bboxes=np.array([[2, 2, 12, 12], [3, 1, 14, 11], [1, 2, 13, 15],
                                          [4, 4, 10, 12]], np.float32),
                 sc_face_bboxes=np.array([[4, 3, 11, 13], [2, 2, 12, 12], [3, 3, 15, 14],
                                          [0, 1, 9, 10]], np.float32),
                 sc_fg_mask_percent=np.float32(0.23),
                 ref_images=np.clip(rs.randn(B, 3, PX, PX) * 0.4, -1, 1).astype(np.float32),
                 ref_face_bboxes=np.array([[8, 8, 40, 40], [4, 10, 60, 58], [6, 6, 50, 50],
                                           [10, 4, 56, 60]], np.float32),
                 ref_face_detected=np.array([1, 1, 0, 1], np.float32),
                 comp_sc_face_detected_mean=np.float32(0.9),
                 comp_sc_face_detected_n=np.float32(10.0))
    return {k: torch.from_numpy(np.array(v)).long() if np.asarray(v).dtype.kind in "iu"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


VARIANTS = ("identity", "fallback")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from adaface_tpu.models import vae as jvae

    _, (tfrozen, tparams, tcfg, tm) = with_adapters(120)
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), bridge.vae_decoder_tree(
        numpy_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**VAE_KW)), 122)))
    batch = comp_batch(tm)
    payload, refs = {}, {}
    for name in VARIANTS:
        frozen = dict(tfrozen, vae=vae, arcface=SmoothFace()) if name == "identity" else tfrozen
        payload[name] = {"kind": "step", "loss": "comp", "ccfg": tcomp.CompDistillConfig(**COMP_KW),
                         "lr": LR, "cfg": tcfg, "frozen": frozen,
                         "params": copy.deepcopy(tparams), "batch": batch, "draws": 9}
        refs[name] = _step_case(copy.deepcopy(payload[name]), None)
    tmp = tmp_path_factory.mktemp("dp_comp")
    return refs, run_ranks(dp_cases, payload, str(tmp))


@pytest.mark.parametrize("name", VARIANTS)
def test_comp_2_ranks_match_single_process(runs, name):
    refs, ranks = runs
    ref, r0, r1 = refs[name], ranks[0][name], ranks[1][name]
    assert r0["metrics"] == r1["metrics"]
    assert set(r0["metrics"]) == set(ref["metrics"])
    for key, want in ref["metrics"].items():
        assert_rel(r0["metrics"][key], want, 1e-5, key)
    if name == "identity":
        assert ref["metrics"]["loss_arcface_align_comp"] > 0  # the identity family is live
    for part, grads in ref["grads"].items():
        names = sorted(grads)
        assert names == sorted(r0["grads"][part]), part
        flat = lambda d: np.concatenate([d[n].numpy().ravel() for n in names])  # noqa: E731
        assert rel_l2(flat(r0["grads"][part]), flat(grads)) <= 1e-5, part
    for part, sd in ref["params"].items():
        for n, p in sd.items():
            assert torch.equal(r0["params"][part][n], r1["params"][part][n]), n
            assert_rel(r0["params"][part][n].numpy(), p.numpy(), what=f"{part} {n}")
