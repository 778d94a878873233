"""Tensor parallelism of the port on the CPU (`parallel/mesh.py`
`make_mesh(dp, tp)` and `shard_params`, the tp region of
`parallel/collectives.py`, the UNet's and the CLIP towers' split layers):

- placement: JAX's `shard_params` on a dp 2 × tp 2 mesh of four CPU devices
  (`device_put` only) and the port's on each of the four ranks shard the
  same leaves of a tiny UNet and text-encoder tree; each port rank holds
  numel / tp of every sharded leaf, its slice of each GEGLU half and of each
  MKV copy; at 3 heads the port keeps every attention whole where JAX
  splits 48 / 24 columns (the head-boundary replications, named);
- steps: one unet-distill step and one single-step recon step at dp 2 × tp
  2 (four gloo ranks; the two-level UNet of `tests/test_torch_recon.py`),
  and one comp step at tp 2 with tiny adapters (the comp UNet's weights cut
  by the UNet's map and swapped in), against the port's single process
  (loss ≤ 1e-5 relative, gradients ≤ 1e-4 relative L2, fp32) and against
  JAX's single-device step (1e-4, the bound of `tests/test_train.py:360`),
  one JAX compile a case (the recon and comp ones are the computations of
  `tests/test_torch_dp_recon.py` and `tests/test_torch_comp_step.py`: their
  persistent-cache entries serve both files); the
  recon iteration with the identity losses at dp 2 × tp 2 and the comp
  step with the identity family at tp 2 (host detection on each tp rank,
  its inputs checked equal) against the single process alone;
- the tp ranks' metrics and gradients equal bit for bit;
- two planted faults (`chip_compare.tp_fault`: `o`'s bias added on every
  rank; the GEGLU cut as JAX's contiguous layout) each exceed the bounds.

Three spawns for the file (four ranks, two ranks and the single process:
`tests/torch_dp_workers.py tp_cases`); the JAX references run beside them.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_compare
from adaface_tpu.core.params import map_with_path
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu.parallel import mesh as jmesh
from adaface_tpu.train import comp_step as jcomp
from adaface_tpu.train import train_step as jstep
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import mmdit as tmmdit
from adaface_tpu_torch.models import motion as tmotion
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.parallel import collectives as tcoll
from adaface_tpu_torch.parallel import mesh as tmesh
from adaface_tpu_torch.train import comp_step as tcomp
from adaface_tpu_torch.train import recon_step as trecon
from tests.test_torch_comp import jax_grads_state_dicts, with_adapters
from tests.test_torch_comp import jax_step as jax_grad_step
from tests.test_torch_comp_step import COMP_KW, comp_batch, handed_rand
from tests.test_torch_dp_distill import dp_batch, jax_step
from tests.test_torch_dp_recon import recon_extra
from tests.test_torch_models import TEXT_KW, UNET_KW, VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_recon import RECON_UNET_KW
from tests.test_torch_train import GRAD_REL_L2, LR, build_step_pair, rel_l2
from tests.torch_dp_workers import SmoothFace, join_ranks, start_ranks, tp_cases

LOSS_REL = 1e-5  # the port's tp ranks against its single process, fp32
JAX_REL = 1e-4  # against JAX's single-device step (`tests/test_train.py:360`)

# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

HEADS3_UNET_KW = dict(block_channels=(24, 48, 48, 48), cross_attn_dim=48, num_heads=3,
                      norm_groups=8)
HEADS3_TEXT_KW = dict(hidden_size=48, num_layers=2, num_heads=3, intermediate_size=96)
PLACEMENTS = {"heads2": (UNET_KW, TEXT_KW), "heads3": (HEADS3_UNET_KW, HEADS3_TEXT_KW)}


def _trees(unet_kw: dict, text_kw: dict):
    """numpy-drawn JAX trees of a tiny UNet and text encoder, the text
    encoder's first layer with K and V at MKV multiplier 2."""
    unet = numpy_params(lambda k: junet.init_unet_params(k, junet.UNetConfig(**unet_kw)), 150)
    text = numpy_params(lambda k: jclip.init_text_params(k, jclip.CLIPTextConfig(**text_kw)), 151)
    attn = dict(text["layers"][0]["attn"])
    for n in ("k", "v"):
        w, b = attn[n]["w"], attn[n]["b"]
        attn[n] = {"w": jnp.concatenate([w, w * 1.5], axis=1), "b": jnp.concatenate([b, -b])}
    text["layers"][0] = dict(text["layers"][0], attn=attn)
    return unet, text


def _jax_specs(tree) -> dict:
    mesh = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    out = {}
    map_with_path(lambda path, x: out.__setitem__(path, tuple(x.sharding.spec)),
                  jmesh.shard_params(tree, mesh))
    return out


def _expected_part(full: np.ndarray, path: str, spec: tuple, t: int, mult: int) -> np.ndarray:
    """This tp rank's part of a JAX leaf [in, out] as the port lays it out:
    the rank's columns (rows for ('tp', None)), of each GEGLU half and of
    each MKV copy."""
    axis = 1 if spec == (None, "tp") else 0
    groups = 2 if path.endswith("ff/proj_in/w") else (mult if path.endswith(("k/w", "v/w"))
                                                      and "attn/" in path else 1)
    return np.concatenate([np.split(g, 2, axis)[t] for g in np.split(full, groups, axis)], axis)


@pytest.mark.parametrize("name", sorted(PLACEMENTS))
def test_shard_params_places_as_jax(name):
    """The port's placement map against JAX's on the same trees; each of the
    four ranks' parts (dp_rank = rank // 2, tp_rank = rank % 2) against the
    full leaf; at 3 heads the attentions JAX splits stay whole in the port."""
    unet_kw, text_kw = PLACEMENTS[name]
    unet_tree, text_tree = _trees(unet_kw, text_kw)
    text_cfg = tclip.CLIPTextConfig(**text_kw)
    for tree, build in ((unet_tree, lambda: tunet.UNet2DConditionModel(
                            tunet.UNetConfig(**unet_kw))),
                        (text_tree, lambda: tclip.CLIPTextModel(text_cfg))):
        jspecs = _jax_specs(tree)
        full = {}
        map_with_path(lambda path, x: full.__setitem__(path, np.asarray(x)), tree)
        template = bridge.load(build(), tree)
        jsharded = {p for p, s in jspecs.items() if s}
        for rank in range(4):
            mesh = tmesh.Mesh(dp=2, rank=rank, local_rank=0, tp=2)
            assert (mesh.dp_rank, mesh.tp_rank) == (rank // 2, rank % 2)
            module = copy.deepcopy(template)
            placements = tmesh.shard_params(module, mesh)
            assert set(placements) == set(jspecs)
            mine = {p for p, s in placements.items() if s}
            whole = jsharded - mine
            if name == "heads2":
                assert whole == set()
            else:  # every attention's q, k, v, o: 3 heads do not split in 2
                assert whole and all(p.rsplit("/", 2)[-2] in "qkvo" for p in whole), sorted(whole)
                assert whole == {p for p in jsharded if "attn" in p}, sorted(whole)
                assert mine == {p for p in jsharded if "attn" not in p}
            assert mine <= jsharded and all(placements[p] == jspecs[p] for p in mine)
            local = bridge.tree_state_dict(module)
            for path in jspecs:
                got, want = local[path.replace("/", ".")], full[path]
                if path not in mine:
                    np.testing.assert_array_equal(got, want, err_msg=path)
                    continue
                assert got.size * 2 == want.size, path
                mult = want.shape[1] // text_cfg.hidden_size if path.startswith("layers/") else 1
                np.testing.assert_array_equal(
                    got, _expected_part(want, path, placements[path], rank % 2, mult),
                    err_msg=path)


def test_shard_params_refuses():
    """No tp forward: the MMDiT, the motion modules, a SubjBasisGenerator's
    tower's owner; a state dict without the module it loads into; a module
    cut twice. tp_part against numpy; outside a mesh `check_tp_equal` is a
    no-op."""
    mesh = tmesh.Mesh(dp=1, rank=1, local_rank=0, tp=2)
    mm = tmmdit.MMDiT(tmmdit.MMDiTConfig(in_channels=4, out_channels=4, depth=1, hidden=64,
                                         num_heads=2, context_dim=32, pooled_dim=32,
                                         pos_embed_max_size=8))
    with pytest.raises(NotImplementedError, match="MMDiT has no tensor-parallel forward"):
        tmesh.shard_params(mm, mesh)
    mo = tmotion.MotionModules(tunet.UNetConfig(**RECON_UNET_KW),
                               tmotion.MotionConfig(num_heads=2, norm_groups=8))
    with pytest.raises(NotImplementedError, match="MotionModules"):
        tmesh.shard_params(mo, mesh)
    unet = tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW))
    sd = unet.state_dict()
    with pytest.raises(ValueError, match="like="):
        tmesh.shard_params(sd, mesh)
    placements = tmesh.shard_params(sd, mesh, like=unet)
    assert sd["time_mlp.fc1.weight"].shape[0] * 2 == unet.time_mlp["fc1"].weight.shape[0]
    assert placements["time_mlp/fc1/w"] == (None, "tp")
    tmesh.shard_params(unet, mesh)
    assert all(torch.equal(v, unet.state_dict()[k]) for k, v in sd.items())
    with pytest.raises(ValueError, match="sharded already"):
        tmesh.shard_params(unet, mesh)
    x = torch.arange(2 * 12 * 3.0).reshape(2, 12, 3)
    want = np.concatenate([np.split(g, 2, 1)[1] for g in np.split(x.numpy(), 3, 1)], 1)
    np.testing.assert_array_equal(tcoll.tp_part(x, mesh, dim=1, parts=3).numpy(), want)
    tcoll.check_tp_equal(x, "x")


# ---------------------------------------------------------------------------
# steps on the ranks
# ---------------------------------------------------------------------------

FOUR = ("distill", "recon", "recon_v2")  # dp 2 × tp 2
TWO = ("comp", "comp_identity", "o_bias_every_rank", "geglu_contiguous")  # tp 2


def _case(loss: str, dp: int, tcfg, frozen, params, batch, **kw) -> dict:
    return dict(kind="step", loss=loss, dp=dp, tp=2, lr=LR, cfg=tcfg, frozen=frozen,
                params=copy.deepcopy(params), batch=batch, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results of every case (two spawns), the port's single
    process's and JAX's, computed while the ranks run."""
    four, two, jrefs = {}, {}, {}
    # one stack for the unet-distill and recon steps: the recon tests' (its
    # JAX recon step is `tests/test_torch_dp_recon.py`'s)
    (rjf, rjt, rjc, rjm), (rtf, rtp, rtc, rtm) = build_step_pair(seed=90,
                                                                 unet_kw=RECON_UNET_KW)
    djb, dtb = dp_batch(rjm, rtm, 4, 0, 61)
    four["distill"] = _case("unet_distill", 2, rtc, rtf, rtp, dtb)
    rjb, rtb = dp_batch(rjm, rtm, 4, 0, 63, recon_extra(64))
    rjc0 = dataclasses.replace(rjc, training_perturb_prob=0.0)
    four["recon"] = _case("recon", 2, dataclasses.replace(rtc, training_perturb_prob=0.0),
                          rtf, rtp, rtb)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**VAE_KW)), 122)
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), bridge.vae_decoder_tree(vae_p))
    rcfg = trecon.ReconStepConfig(num_priming_steps=2, compute_dtype="float32",
                                  recon_face_align_loss_thres=-1.0)
    four["recon_v2"] = _case("recon_v2", 2, rtc, dict(rtf, vae=vae, arcface=SmoothFace()), rtp,
                             rtb, rcfg=rcfg, draws=7)
    (cjf, cjt, cjc, cjm), (ctf, ctp, ctc, ctm) = with_adapters(120)
    cjb, ctb = comp_batch(cjm, ctm)
    jccfg = jcomp.CompDistillConfig(vae_cfg=jvae.VAEConfig(**VAE_KW), **COMP_KW)
    jhand, thand = handed_rand(cjb, jccfg)
    ccfg = tcomp.CompDistillConfig(**COMP_KW)
    # the ranks' UNet starts from other weights: the comp weights swap in, cut
    base = copy.deepcopy(ctf["unet"])
    with torch.no_grad():
        for p in base.parameters():
            p.mul_(-0.5)
    comp_unet = {k: v.clone() for k, v in ctf["unet"].state_dict().items()}
    two["comp"] = _case("comp", 1, ctc, dict(ctf, unet=base), ctp, dict(ctb, **thand),
                        ccfg=ccfg, comp_unet=comp_unet)
    two["comp_identity"] = _case("comp", 1, ctc, dict(ctf, vae=vae, arcface=SmoothFace()),
                                 ctp, dict(ctb, **thand), ccfg=ccfg)
    for fault in chip_compare.TP_FAULTS:
        two[fault] = _case("unet_distill", 1, rtc, rtf, rtp, dtb, fault=fault)
    # the single process's steps in a process of their own, beside the ranks
    one = {name: dict(case, tp=None) for name, case in {**four, **two}.items()
           if "fault" not in case}
    tmp4, tmp2, tmp1 = (str(tmp_path_factory.mktemp(n)) for n in ("tp4", "tp2", "one"))
    ctx4, ctx2 = start_ranks(tp_cases, four, tmp4, 4), start_ranks(tp_cases, two, tmp2, 2)
    ctx1 = start_ranks(tp_cases, one, tmp1, 1)
    try:
        jrefs["distill"] = jax_step(jstep.unet_distill_loss_fn, rjf, rjt, rjc, djb, rtp)
        jrefs["recon"] = jax_step(jstep.recon_loss_fn, rjf, rjt, rjc0, rjb, rtp)
        frozen = {k: v for k, v in cjf.items() if k not in ("vae", "arcface")}
        metrics, g = jax_grad_step(lambda *a, c=jccfg: jcomp.comp_distill_loss_fn(*a, comp_cfg=c),
                                   frozen, cjt, cjc, dict(cjb, **jhand))
        jrefs["comp"] = metrics, jax_grads_state_dicts(g, cjf, ctp)
    finally:
        ranks4, ranks2 = join_ranks(ctx4, tmp4, 4), join_ranks(ctx2, tmp2, 2)
        refs = join_ranks(ctx1, tmp1, 1)[0]
    ranks = {name: [r[name] for r in ranks4] for name in FOUR}
    ranks.update({name: [r[name] for r in ranks2] for name in TWO})
    return ranks, refs, jrefs


def _flat(grads: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(grads[n], np.float64).ravel() for n in names])


def _distance(got: dict, ref_metrics: dict, ref_grads: dict) -> tuple[float, float]:
    """(the loss's relative difference, the worst part's gradient relative
    L2 over the rank's trained tensors) of a rank's step against a
    reference."""
    loss = abs(got["metrics"]["loss"] - ref_metrics["loss"]) / abs(ref_metrics["loss"])
    grads = 0.0
    for part, ref in ref_grads.items():
        names = sorted(got["grads"][part])
        grads = max(grads, rel_l2(_flat({n: g.numpy() for n, g in got["grads"][part].items()},
                                        names), _flat(ref, names)))
    return loss, grads


def _assert_ranks_equal(ranks: list) -> None:
    first = ranks[0]
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for part, grads in first["grads"].items():
            for n, g in grads.items():
                assert torch.equal(g, other["grads"][part][n]), (part, n)


@pytest.mark.parametrize("name", ["distill", "recon", "comp"])
def test_tp_step_matches_single_process_and_jax(runs, name):
    ranks, refs, jrefs = runs
    got, ref = ranks[name][0], refs[name]
    _assert_ranks_equal(ranks[name])
    loss, grads = _distance(got, ref["metrics"], {p: {n: g.numpy() for n, g in gs.items()}
                                                  for p, gs in ref["grads"].items()})
    assert loss <= LOSS_REL and grads <= GRAD_REL_L2, (loss, grads)
    jmetrics, jgrads = jrefs[name][:2]
    if name != "comp":  # the dp steps' references: the SubjBasisGenerator's
        jgrads = {"sbg": jgrads}
    else:
        jgrads = {p: jgrads[p] for p in got["grads"]}
    jloss, jg = _distance(got, jmetrics, {p: {n: np.asarray(g) for n, g in gs.items()}
                                          for p, gs in jgrads.items()})
    assert jloss <= JAX_REL and jg <= JAX_REL, (jloss, jg)
    for key, want in jmetrics.items():
        if key in got["metrics"]:
            assert abs(got["metrics"][key] - want) <= JAX_REL * max(abs(want), 1e-6), key


@pytest.mark.parametrize("name", ["recon_v2", "comp_identity"])
def test_tp_step_with_host_detection_matches_single_process(runs, name):
    """The identity losses live: every tp rank detects faces on its own
    copy of the decodes, checked equal, and takes the same gates."""
    ranks, refs, _ = runs
    got, ref = ranks[name][0], refs[name]
    _assert_ranks_equal(ranks[name])
    key = "loss_arcface_align_recon" if name == "recon_v2" else "loss_arcface_align_comp"
    assert ref["metrics"][key] > 0
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= LOSS_REL * max(abs(want), 1e-6), k
    loss, grads = _distance(got, ref["metrics"], {p: {n: g.numpy() for n, g in gs.items()}
                                                  for p, gs in ref["grads"].items()})
    assert loss <= LOSS_REL and grads <= GRAD_REL_L2, (loss, grads)


@pytest.mark.parametrize("fault", chip_compare.TP_FAULTS)
def test_planted_tp_faults_fail_the_bound(runs, fault):
    """`o`'s bias on every rank, or the GEGLU cut contiguously: the tp ranks
    still agree with each other, and miss the single process by more than
    the bounds the sound step holds."""
    ranks, refs, _ = runs
    _assert_ranks_equal(ranks[fault])
    ref = refs["distill"]
    loss, grads = _distance(ranks[fault][0], ref["metrics"],
                            {p: {n: g.numpy() for n, g in gs.items()}
                             for p, gs in ref["grads"].items()})
    assert loss > 100 * LOSS_REL or grads > 100 * GRAD_REL_L2, (loss, grads)
