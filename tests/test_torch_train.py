"""The Stage-1 training modules of the PyTorch port against the JAX package,
on the CPU.

The same numpy inputs go through the JAX function and its port in fp32 at
the tiny widths of `tests/test_torch_models.py`; modules get the JAX params
through the bridge. Draws JAX makes from its keys (the teacher's chain, the
embedding perturbation) are made by the test from the same keys, in the
order the JAX code splits them, and handed to the port (`Draws`); numpy
`RandomState` draws (the planner, the dataset, the compositions) are made by
both sides from the same seeds and must agree bit for bit.

Tolerances: host planning (token ids, splice and merge maps, masks, flags,
dataset pixels) equal; tensor functions and the teacher's chain 1e-5
relative to the largest magnitude; optimizers 1e-6 over 20 steps; one
unet-distill train step: loss 1e-5 relative, the SubjBasisGenerator's
gradients 1e-4 relative L2 (a backward through a UNet and a CLIP tower,
summed in another order), the parameters after the update 1e-5.
"""

import dataclasses
import functools
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from adaface_tpu.data import personalized as jdata
from adaface_tpu.id2ada import teachers as jteach
from adaface_tpu.id2ada.subj_basis_generator import (SubjBasisConfig as JSBGConfig,
                                                     init_subj_basis_generator)
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import unet as junet
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.text import embedding_manager as jem
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.train import iteration_plan as jplan
from adaface_tpu.train import losses as jloss
from adaface_tpu.train import optimizers as jopt
from adaface_tpu.train import prompt_batch as jpb
from adaface_tpu.train import train_step as jstep
from adaface_tpu.utils import tensor as jtensor
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.data import personalized as tdata
from adaface_tpu_torch.id2ada import teachers as tteach
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.text import embedding_manager as tem
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.train import iteration_plan as tplan
from adaface_tpu_torch.train import losses as tloss
from adaface_tpu_torch.train import optimizers as topt
from adaface_tpu_torch.train import prompt_batch as tpb
from adaface_tpu_torch.train import train_step as tstep
from adaface_tpu_torch.utils import image as timage
from adaface_tpu_torch.utils import tensor as ttensor
from adaface_tpu_torch.utils.tensor import Draws
from tests.test_torch_models import D, TEXT_KW, UNET_KW, numpy_params

REPO = pathlib.Path(__file__).resolve().parent.parent
FN_RTOL = 1e-5
OPT_ATOL = 1e-6
GRAD_REL_L2 = 1e-4
LR = 1e-3  # cautious AdamW's first update is about ±lr an element
# a 3-layer tower: the trainer's CLIP-skip weights mix the last 3 hidden states
TRAIN_TEXT_KW = dict(TEXT_KW, num_layers=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_rel(out, ref, rtol=FN_RTOL, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: max error {err:.3e} of the largest |ref|"


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# the port's sources import neither JAX nor the JAX package
# ---------------------------------------------------------------------------

IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|adaface_tpu|optax)\b(?!_torch)",
                    re.MULTILINE)


def test_port_sources_import_no_jax():
    """No module of `adaface_tpu_torch/`, nor `chip_smoke.py` or
    `train_torch.py`, has an import of JAX, the JAX package or optax (read
    from the sources), and the training modules import without them, PIL,
    OpenCV or PyYAML."""
    files = sorted((REPO / "adaface_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "train_torch.py"]
    bad = {str(f.relative_to(REPO)): IMPORT.findall(f.read_text()) for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
    mods = ["adaface_tpu_torch.train.trainer", "adaface_tpu_torch.train.train_step",
            "adaface_tpu_torch.train.optimizers", "adaface_tpu_torch.train.checkpoint",
            "adaface_tpu_torch.id2ada.teachers", "adaface_tpu_torch.data.personalized",
            "adaface_tpu_torch.utils.monitor", "adaface_tpu_torch.utils.config",
            "train_torch"]
    code = ("import sys\n"
            f"for m in {mods!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'adaface_tpu', 'optax', 'cv2', 'PIL',"
            " 'yaml'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=REPO)


# ---------------------------------------------------------------------------
# utils/tensor.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1.0, 5.0])
def test_gradient_scaler_matches_jax(scale):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    ref = jax.grad(lambda x: (jtensor.gen_gradient_scaler(scale)(x) * w).sum())(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = ttensor.gen_gradient_scaler(scale)(tx)
    np.testing.assert_array_equal(y.detach().numpy(), x)
    if scale > 0:
        (y * _t(w)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), rtol=1e-7)
    else:
        assert not y.requires_grad and not np.asarray(ref).any()


@pytest.mark.parametrize("n_dims,discount", [(1, 1.0), (2, 0.5)])
def test_ortho_subtract_matches_jax(n_dims, discount):
    rs = np.random.RandomState(2)
    a, b = rs.randn(2, 5, 6).astype(np.float32), rs.randn(1, 5, 6).astype(np.float32)
    ref = jtensor.ortho_subtract(jnp.asarray(a), jnp.asarray(b), b_discount=discount,
                                 on_last_n_dims=n_dims)
    out = ttensor.ortho_subtract(_t(a), _t(b), b_discount=discount, on_last_n_dims=n_dims)
    assert_rel(out.numpy(), ref)


@pytest.mark.parametrize("end,prob,keep_norm", [(None, 1.0, True), ((0.1, 0.2), 0.5, False),
                                                ((0.1, 0.2), 0.0, True)])
def test_anneal_perturb_embedding_matches_jax(end, prob, keep_norm):
    """The port with JAX's draws handed over: the std's uniform (k1), the
    noise (k2), the bernoulli's uniform (k3)."""
    emb = np.random.RandomState(3).randn(3, 4, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jtensor.anneal_perturb_embedding(key, jnp.asarray(emb), 0.3, (0.3, 0.6), end, prob,
                                           keep_norm=keep_norm)
    k1, k2, k3 = jax.random.split(key, 3)
    handed = [np.asarray(jax.random.uniform(k1, ())), np.asarray(jax.random.normal(k2, emb.shape)),
              np.asarray(jax.random.uniform(k3, ()))]
    out = ttensor.anneal_perturb_embedding(Draws(handed=handed), _t(emb), 0.3, (0.3, 0.6), end,
                                           prob, keep_norm=keep_norm)
    assert_rel(out.numpy(), ref)
    for tp in (0.0, 0.4, 1.0):
        assert ttensor.anneal_value(tp, 0.5, (1.0, 3.0)) == jtensor.anneal_value(tp, 0.5,
                                                                                (1.0, 3.0))


# ---------------------------------------------------------------------------
# text/embedding_manager.py and train/prompt_batch.py
# ---------------------------------------------------------------------------

SUBJ = ["a photo of z, , , , , , , , , , , , , , , , in a park", "z, , , , , , , , , , , , , , , "]
CLS = ["a photo of a young woman, in a park", "a young woman"]


def _managers():
    """(JAX, port) EmbeddingManagers on tokenizers of their own, with a
    two-token class-delta string."""
    jtok, ttok = JTokenizer.character_fallback(), CLIPTokenizer.character_fallback()
    cls_delta = {"z": jtok.encode_text("young woman")}
    assert cls_delta["z"] == ttok.encode_text("young woman") and len(cls_delta["z"]) > 1
    return (jem.EmbeddingManager(jtok, [jem.PlaceholderSpec("z", 16)], cls_delta_tokens=cls_delta),
            tem.EmbeddingManager(ttok, [tem.PlaceholderSpec("z", 16)], cls_delta_tokens=cls_delta))


def test_embedding_manager_plan_matches_jax():
    jm, tm = _managers()
    ref, out = jm.plan(SUBJ + CLS), tm.plan(SUBJ + CLS)
    assert sorted(ref) == sorted(out)
    assert ref["merge_map"] is not None
    for key in ("ids", "prompt_emb_mask", "prompt_pad_mask", "merge_map"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    np.testing.assert_array_equal(out["splice_maps"]["z"], ref["splice_maps"]["z"])
    ids = ref["ids"]
    np.testing.assert_array_equal(
        tem.build_splice_map(ids, tm.placeholder_ids["z"], tm.filler_id, 5),
        jem.build_splice_map(ids, jm.placeholder_ids["z"], jm.filler_id, 5))
    rows = [(0, 3), (1, 0)]
    spans = tem.scan_cls_delta_spans(ids, rows, jm.cls_delta_tokens)
    assert spans == jem.scan_cls_delta_spans(ids, rows, jm.cls_delta_tokens) and spans
    np.testing.assert_array_equal(tem.build_merge_map(*ids.shape, spans),
                                  jem.build_merge_map(*ids.shape, spans))


@pytest.mark.parametrize("scheme,cfg", [("sqrt_M", 2.0), ("M", 1.0), ("none", 1.5)])
def test_embedding_math_matches_jax(scheme, cfg):
    """splice, merge and distribute, forward and gradient."""
    jm, tm = _managers()
    plan = jm.plan(SUBJ + CLS)
    rs = np.random.RandomState(4)
    base = rs.randn(4, 77, 8).astype(np.float32)
    ada = rs.randn(4, 16, 8).astype(np.float32)
    uncond = rs.randn(1, 77, 8).astype(np.float32)
    smap, mmap = plan["splice_maps"]["z"], plan["merge_map"]
    dist_map = np.concatenate([smap[:2], smap[:2]])  # class rows take the subject rows' slots

    def jfn(base, ada):
        e = jem.splice_ada_embeddings(base, ada, jnp.asarray(smap))
        e = jem.apply_merge_map(e, jnp.asarray(mmap))
        return jem.distribute_embedding_to_M_tokens(e, jnp.asarray(dist_map), jnp.asarray(uncond),
                                                    divide_scheme=scheme, emb_cfg=cfg)

    def tfn(base, ada):
        e = tem.splice_ada_embeddings(base, ada, _t(smap))
        e = tem.apply_merge_map(e, _t(mmap))
        return tem.distribute_embedding_to_M_tokens(e, _t(dist_map), _t(uncond),
                                                    divide_scheme=scheme, emb_cfg=cfg)

    w = rs.randn(4, 77, 8).astype(np.float32)
    ref, vjp = jax.vjp(jfn, jnp.asarray(base), jnp.asarray(ada))
    ref_db, ref_da = vjp(jnp.asarray(w))
    tb, ta = _t(base).requires_grad_(), _t(ada).requires_grad_()
    out = tfn(tb, ta)
    out.backward(_t(w))
    assert_rel(out.detach().numpy(), ref)
    assert_rel(tb.grad.numpy(), ref_db)
    assert_rel(ta.grad.numpy(), ref_da)


def test_prompt_batches_match_jax():
    jm, tm = _managers()
    ref = jpb.build_4block_prompt_batch(jm, SUBJ, SUBJ, CLS, CLS)
    out = tpb.build_4block_prompt_batch(tm, SUBJ, SUBJ, CLS, CLS)
    assert sorted(ref) == sorted(out)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    rep = tpb.make_comp_rep_prompts(SUBJ, ["a", "b"], ["in a park", "on a hill"])
    assert rep == jpb.make_comp_rep_prompts(SUBJ, ["a", "b"], ["in a park", "on a hill"])
    ref = jpb.build_comp_prompt_batch(jm, SUBJ, SUBJ, rep, CLS, CLS)
    out = tpb.build_comp_prompt_batch(tm, SUBJ, SUBJ, rep, CLS, CLS)
    assert sorted(ref) == sorted(out)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


# ---------------------------------------------------------------------------
# train/losses.py
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rs = np.random.RandomState(5)
    emb = rs.randn(8, 77, 16).astype(np.float32)
    mask = (rs.rand(8, 77, 1) > 0.2).astype(np.float32)
    ref, vjp = jax.vjp(lambda e: jloss.calc_prompt_emb_delta_loss(e, jnp.asarray(mask)),
                       jnp.asarray(emb))
    te = _t(emb).requires_grad_()
    out = tloss.calc_prompt_emb_delta_loss(te, _t(mask))
    out.backward()
    assert_rel(out.item(), ref)
    assert_rel(te.grad.numpy(), vjp(jnp.float32(1.0))[0])
    x, m = rs.randn(3, 5).astype(np.float32), (rs.rand(3, 5) > 0.5).astype(np.float32)
    assert_rel(tloss.masked_mean(_t(x), _t(m)).item(), jloss.masked_mean(x, m))

    pred, gt, cls = (rs.randn(2, 4, 8, 8).astype(np.float32) for _ in range(3))
    img_mask = (rs.rand(2, 1, 8, 8) > 0.1).astype(np.float32)
    fg = (rs.rand(2, 1, 8, 8) > 0.5).astype(np.float32)
    attn = {23: rs.rand(2, 2, 16, 77).astype(np.float32), 24: rs.rand(2, 2, 16, 77).astype(
        np.float32)}
    subj = (rs.rand(2, 77) > 0.8).astype(np.float32)
    inst = np.array([1.0, 0.0], np.float32)
    ref = jloss.calc_recon_and_suppress_losses(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(cls), jnp.asarray(inst),
        {k: jnp.asarray(v) for k, v in attn.items()}, jnp.asarray(subj), jnp.asarray(img_mask),
        jnp.asarray(fg), 0.1)
    out = tloss.calc_recon_and_suppress_losses(
        _t(gt), _t(pred), _t(cls), _t(inst), {k: _t(v) for k, v in attn.items()}, _t(subj),
        _t(img_mask), _t(fg), 0.1)
    for o, r in zip(out, ref):
        assert_rel(o.item(), r)
    scores = {23: rs.randn(4, 2, 16, 77).astype(np.float32)}
    assert_rel(tloss.calc_attn_norm_loss({k: _t(v) for k, v in scores.items()}, _t(subj)).item(),
               jloss.calc_attn_norm_loss(scores, subj))


# ---------------------------------------------------------------------------
# train/optimizers.py
# ---------------------------------------------------------------------------

SHAPES = [(4, 3), (5,), (2, 2, 2)]


def _optimizer_run(port_opt, jax_opt, steps: int = 20, grad_scale: float = 1.0):
    """Run both on the same seeded params and gradients; the gradient of
    step i is drawn from RandomState(100 + i) (scaled, so the clip acts when
    asked). → (port params, JAX params, mini-steps where the port moved)."""
    rs = np.random.RandomState(9)
    p0 = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    tp = [torch.nn.Parameter(_t(p)) for p in p0]
    jp = [jnp.asarray(p) for p in p0]
    opt = port_opt(tp)
    state = jax_opt.init(jp)
    moved = []
    for i in range(steps):
        grs = np.random.RandomState(100 + i)
        gs = [(grs.randn(*s) * grad_scale).astype(np.float32) for s in SHAPES]
        for p, g in zip(tp, gs):
            p.grad = _t(g)
        moved.append(opt.step())
        upd, state = jax_opt.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
    return [p.detach().numpy() for p in tp], [np.asarray(p) for p in jp], moved


@pytest.mark.parametrize("name,kw", [
    ("cadamw", {}),
    ("prodigy", dict(scheduler_type="Linear")),
    ("prodigy", dict(scheduler_type="CosineAnnealingWarmRestarts", scheduler_cycles=2)),
    ("prodigy", dict(scheduler_type="CyclicLR", scheduler_cycles=2, d_coef=2.0)),
])
@pytest.mark.parametrize("accum,clip_scale", [(1, 1.0), (2, 0.01)])
def test_make_optimizer_matches_optax(name, kw, accum, clip_scale):
    """`make_optimizer` (clip, optimizer, `accum`-step accumulation) against
    `optax.MultiSteps(make_optimizer(...), accum)` over 20 mini-steps; the
    clip acts at grad_clip 0.2 unless the gradients are scaled down (the
    second case: the mean of two is under the clip)."""
    lr = 1.0 if name == "prodigy" else 1e-2
    common = dict(warmup_steps=3, total_steps=12, grad_clip=0.2)
    port = lambda ps: topt.make_optimizer(name, ps, lr, accum_steps=accum, **common,  # noqa
                                          **dict(kw))
    ref = jopt.make_optimizer(name, lr, **common, **dict(kw))
    if accum > 1:
        ref = optax.MultiSteps(ref, accum)
    out, want, moved = _optimizer_run(port, ref, grad_scale=clip_scale)
    for o, w in zip(out, want):
        np.testing.assert_allclose(o, w, atol=OPT_ATOL, rtol=0)
    assert moved == [(i + 1) % accum == 0 for i in range(20)]
    assert max(np.abs(o - p).max() for o, p in zip(
        out, [np.random.RandomState(9).randn(*s) for s in SHAPES])) > 10 * OPT_ATOL


@pytest.mark.parametrize("kind,cycles", [("Linear", 1), ("Linear", 3),
                                         ("CosineAnnealingWarmRestarts", 2), ("CyclicLR", 2)])
def test_schedules_match_jax(kind, cycles):
    ref = jopt.prodigy_cycle_schedule(5, 47, cycles, kind)
    out = topt.prodigy_cycle_schedule(5, 47, cycles, kind)
    for step in range(60):
        assert abs(out(step) - float(ref(jnp.int32(step)))) <= 1e-6, step
    ref, out = jopt.warmup_cosine(1e-3, 5, 47, lr_min=1e-5), topt.warmup_cosine(1e-3, 5, 47,
                                                                                  lr_min=1e-5)
    for step in range(60):
        assert abs(out(step) - float(ref(step))) <= 1e-9, step


def test_unported_optimizers_raise():
    with pytest.raises(ValueError, match="muon and adam8bit wait in ROADMAP"):
        topt.make_optimizer("muon", [torch.nn.Parameter(torch.zeros(2))], 1e-3)


# ---------------------------------------------------------------------------
# train/iteration_plan.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(comp_distill_iter_gap=0, unet_distill_iter_gap=1),
    dict(comp_distill_iter_gap=0, unet_distill_iter_gap=1, unet_distill_steps_range=(2, 3)),
    dict(comp_distill_iter_gap=4, unet_distill_iter_gap=5, has_comp_unet_weights=True),
    dict(comp_distill_iter_gap=2, fixed_comp_priming_steps=3, use_fp_trick=False),
])
def test_planner_flags_match_jax(kw):
    jp, tp = jplan.IterationPlanner(**kw), tplan.IterationPlanner(**kw)
    for step in range(50):
        assert dataclasses.asdict(tp.plan(step)) == dataclasses.asdict(jp.plan(step)), step
    assert (tp.comp_iters, tp.unet_distill_iters, tp.recon_iters) == (
        jp.comp_iters, jp.unet_distill_iters, jp.recon_iters)


# ---------------------------------------------------------------------------
# utils/image.py (PNG) and data/
# ---------------------------------------------------------------------------


def _png_with_filters(path, img: np.ndarray) -> None:
    """An 8-bit PNG whose rows cycle through the five filter types."""
    import struct
    import zlib

    bpp = 1 if img.ndim == 2 else img.shape[2]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * bpp).astype(np.int64)
    out = []
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ft, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out.append(bytes([ft]) + (f % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    colour = {1: 0, 3: 2, 4: 6}[bpp]
    with open(path, "wb") as f:
        f.write(timage.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0,
                                                                   0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,channels", [("L", None), ("RGB", 3), ("RGBA", 4)])
def test_png_reader_matches_pil(tmp_path, mode, channels):
    """The reader on PNGs PIL wrote, on rows of all five filters, and PIL
    on what the port's writer wrote; grey conversion, padding and the
    NEAREST resize as PIL does them."""
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (13, 9) if channels is None else (13, 9, channels)).astype(np.uint8)
    img[:, :4] = img[:, :1]  # runs of equal pixels, as photos have
    Image.fromarray(img, mode).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(timage.read_png(tmp_path / "pil.png"), img)
    _png_with_filters(tmp_path / "filters.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "filters.png")), img)
    np.testing.assert_array_equal(timage.read_png(tmp_path / "filters.png"), img)
    timage.write_png(tmp_path / "port.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")), img)
    pil = Image.fromarray(img, mode)
    np.testing.assert_array_equal(timage.to_grey(img), np.asarray(pil.convert("L")))
    np.testing.assert_array_equal(timage.to_rgb(img), np.asarray(pil.convert("RGB")))
    sq = jdata.pad_image_to_square(pil.convert("RGB"))
    np.testing.assert_array_equal(timage.pad_to_square(timage.to_rgb(img)), np.asarray(sq))
    for size in ((31, 31), (64, 64), (7, 7)):
        np.testing.assert_array_equal(timage.resize_nearest_pil(np.asarray(sq), size),
                                      np.asarray(sq.resize(size, Image.NEAREST)))
    Image.fromarray(img[..., :3] if channels else img).save(tmp_path / "x.jpg")
    with pytest.raises(ValueError, match="x.jpg"):
        timage.read_png(tmp_path / "x.jpg")


def make_png_dataset(root: pathlib.Path, size: int = 64, with_masks: bool = True) -> str:
    """Two subjects of two photos each (one not square), a mask for the
    first subject's photos, and metainfo with class strings."""
    import json

    for si, name in enumerate(("alice", "bob")):
        d = root / name
        d.mkdir(parents=True)
        rs = np.random.RandomState(40 + si)
        for i in range(2):
            hw = (size, size) if i == 0 else (size, size * 3 // 4)
            timage.write_png(d / f"{i}.png", rs.randint(0, 256, (*hw, 3)).astype(np.uint8))
            if with_masks and si == 0:
                timage.write_png(d / f"{i}_mask.png",
                                 (rs.rand(*hw) > 0.5).astype(np.uint8) * 255)
    (root / "metainfo.json").write_text(json.dumps(
        {"alice": {"cls_delta_string": "woman"}, "bob": {"cls_delta_string": "man"}}))
    return str(root)


def test_dataset_items_match_jax(tmp_path):
    """`PersonalizedBase` items from a PNG folder and the sampler's order
    against the JAX dataset with its numpy augmentation: pixels, masks and
    prompts equal."""
    root = make_png_dataset(tmp_path)
    jds = jdata.PersonalizedBase(root, size=64, seed=3, use_native=False)
    tds = tdata.PersonalizedBase(root, size=64, seed=3)
    assert len(tds) == len(jds) and tds.num_subjects() == jds.num_subjects()
    jidx = list(jdata.SubjectSampler(jds, 2, num_batches=6, seed=3))
    tidx = list(tdata.SubjectSampler(tds, 2, num_batches=6, seed=3))
    assert tidx == jidx
    ref = [jds[i] for i in jidx]
    out = [tds[i] for i in tidx]
    for r, o in zip(ref, out):
        assert sorted(r) == sorted(o)
        for key in r:
            if isinstance(r[key], np.ndarray):
                np.testing.assert_array_equal(o[key], r[key], err_msg=key)
            else:
                assert o[key] == r[key], key
    rb, ob = jdata.collate_batch(ref[:2]), tdata.collate_batch(out[:2])
    assert sorted(rb) == sorted(ob)
    for key in rb:
        np.testing.assert_array_equal(np.asarray(ob[key]), np.asarray(rb[key]), err_msg=key)


# ---------------------------------------------------------------------------
# id2ada/teachers.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_unet():
    cfg_j = junet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 60)
    return cfg_j, params, bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)),
                                      params)


def _teacher_draws(key, n: int, b: int, shape) -> list:
    """The teacher's draws in the JAX scan's order: per step, the next
    timestep's relative position [B] (k1), then the next noise (k2)."""
    out = []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        out += [np.asarray(jax.random.uniform(k1, (b,))),
                np.asarray(jax.random.normal(k2, shape))]
    return out


@pytest.mark.parametrize("steps,cfg_scale,ensemble", [(1, 1.0, False), (3, 1.0, False),
                                                      (2, 1.5, False), (2, 1.0, True)])
def test_teacher_chain_matches_jax(tiny_unet, steps, cfg_scale, ensemble):
    cfg_j, params, unet = tiny_unet
    rs = np.random.RandomState(61)
    b = 2
    x0 = rs.randn(b, 4, 16, 16).astype(np.float32)
    noise = rs.randn(b, 4, 16, 16).astype(np.float32)
    t = np.array([800, 710], np.int32)
    ctx = rs.randn(2 * b if cfg_scale > 1 else b, 16, D).astype(np.float32)
    jsch, tsch = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()
    kw = dict(unet_weights=[1.0, 3.0]) if ensemble else {}
    jt = jteach.create_unet_teacher("unet_ensemble" if ensemble else "simple_unet",
                                    unet_params=[params, params] if ensemble else params,
                                    unet_cfg=cfg_j, **kw)
    tt = tteach.create_unet_teacher("unet_ensemble" if ensemble else "simple_unet",
                                    unet=[unet, unet] if ensemble else unet, **kw)
    key = jax.random.PRNGKey(62)
    ref = jax.jit(lambda x0, n, t, c: jt(jsch, x0, n, t, c, num_denoising_steps=steps,
                                         cfg_scale=cfg_scale, rng=key))(x0, noise, t, ctx)
    out = tt(tsch, _t(x0), _t(noise), _t(t).long(), _t(ctx),
             Draws(handed=_teacher_draws(key, steps, b, x0.shape)), num_denoising_steps=steps,
             cfg_scale=cfg_scale)
    for name, o, r in zip(("preds", "x_starts", "noises", "ts"), out, ref):
        if name == "ts":
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            assert_rel(o.numpy(), r, what=name)
    assert jt.sample_cfg_scale(np.random.RandomState(1), True) == tt.sample_cfg_scale(
        np.random.RandomState(1), True)


# ---------------------------------------------------------------------------
# train/train_step.py: one unet-distill step
# ---------------------------------------------------------------------------


def build_step_pair(seed: int = 70, unet_kw: dict = UNET_KW):
    """(JAX frozen, trainable, TrainConfig; port frozen, params, TrainConfig;
    the JAX EmbeddingManager, the port's) on one set of tiny weights."""
    text_j = jclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    text_t = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    unet_j = junet.UNetConfig(**unet_kw)
    sbg_j = JSBGConfig(output_dim=D, clip=text_j)
    jtok, ttok = JTokenizer.character_fallback(), CLIPTokenizer.character_fallback()
    sbg = init_subj_basis_generator(
        jax.random.PRNGKey(seed), sbg_j, tokenizer=jtok,
        clip_text_params=numpy_params(lambda k: jclip.init_text_params(k, text_j), seed))
    jm = jem.EmbeddingManager(jtok, [jem.PlaceholderSpec("z", 16)])
    tm = tem.EmbeddingManager(ttok, [tem.PlaceholderSpec("z", 16)])
    text_p = numpy_params(lambda k: jclip.init_text_params(k, text_j), seed + 1)
    # the table grown by the added placeholder, as the wrappers grow it
    text_p["token_embedding"] = jnp.concatenate(
        [text_p["token_embedding"], text_p["token_embedding"][:1]], axis=0)
    unet_p = numpy_params(lambda k: junet.init_unet_params(k, unet_j), seed + 2)
    jfrozen = {"unet": unet_p, "text_encoder": text_p, "sbg_buffers": sbg["buffers"]}
    jtrain = {"sbg": sbg["params"]}
    jcfg = jstep.TrainConfig(unet=unet_j, sbg=sbg_j, clip_text=text_j)
    text_big = tclip.CLIPTextConfig(**TRAIN_TEXT_KW,
                                    vocab_size=text_p["token_embedding"].shape[0])
    tfrozen = {"unet": bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**unet_kw)), unet_p),
               "text_encoder": bridge.load(tclip.CLIPTextModel(text_big), text_p)}
    tparams = {"sbg": bridge.load(SubjBasisGenerator(SubjBasisConfig(clip=text_t), ttok),
                                  bridge.sbg_tree(sbg))}
    tcfg = tstep.TrainConfig(unet=tunet.UNetConfig(**unet_kw), sbg=tparams["sbg"].cfg,
                             clip_text=text_t)
    return (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm)


def make_batch(jm, tm, multi: int, seed: int = 71):
    """The same step batch for both sides (numpy): the 4-block prompts with
    a multi-token class string, latents and, from a teacher, either one
    noise prediction or `multi` steps of its chain."""
    rs = np.random.RandomState(seed)
    b, hw = 2, 16
    subj = ["a photo of z, , , , , , , , , , , , , , , , in a park",
            "z, , , , , , , , , , , , , , , , smiling"]
    cls = ["a photo of a young woman, in a park", "a young woman, smiling"]
    jb = jpb.build_4block_prompt_batch(jm, subj, subj, cls, cls)
    tb = tpb.build_4block_prompt_batch(tm, subj, subj, cls, cls)
    for key in jb:
        np.testing.assert_array_equal(tb[key], jb[key])
    batch = {k: v for k, v in jb.items()}
    batch.update(
        x_start=rs.randn(b, 4, hw, hw).astype(np.float32),
        img_prompt_embs=rs.randn(b, 16, D).astype(np.float32),
        clip_skip_weights=rs.dirichlet([1.0, 2.0, 2.0]).astype(np.float32))
    if multi:
        batch.update(teacher_x_ts=rs.randn(multi, b, 4, hw, hw).astype(np.float32),
                     teacher_ts=rs.randint(500, 900, (multi, b)).astype(np.int32),
                     teacher_noise_preds=rs.randn(multi, b, 4, hw, hw).astype(np.float32))
    else:
        batch.update(noise=rs.randn(b, 4, hw, hw).astype(np.float32),
                     t=np.array([880, 720], np.int32),
                     teacher_noise_pred=rs.randn(b, 4, hw, hw).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v).long() if v.dtype.kind in "iu" else _t(v) for k, v in batch.items()}
    return jbatch, tbatch


def _jax_sbg_state_dict(params, buffers, ref):
    return bridge.fuse_projections(
        bridge.state_dict(bridge.sbg_tree({"params": params, "buffers": buffers})), ref)


def _keep_grads() -> optax.GradientTransformation:
    """An optax stage that passes the gradients on and keeps them in its
    state, so one compiled step gives both."""
    return optax.GradientTransformation(lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
                                        lambda g, s, p=None: (g, {"g": g}))


@pytest.mark.parametrize("multi", [0, 3])
def test_unet_distill_step_matches_jax(multi):
    """One step through `make_train_step` on both sides from bridged
    params: the loss and its parts, the SubjBasisGenerator's gradients (the
    hidden-state layer weights' scaled by 5 on both), the gradient norm and
    the parameters after one cautious-AdamW update. Gradients are held in
    relative L2 over all of them and per tensor; the attention's key biases
    have a gradient of 0 in exact arithmetic (softmax ignores a shift of
    the logits), so theirs are held to rounding noise of the global scale."""
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair()
    jbatch, tbatch = make_batch(jm, tm, multi)
    sched_j, sched_t = jsched.DiffusionSchedule.create(), tsched.DiffusionSchedule.create()
    ref_sd = {k: v.clone() for k, v in tparams["sbg"].state_dict().items()}
    opt_j = optax.chain(_keep_grads(), jopt.make_optimizer("cadamw", LR, warmup_steps=0,
                                                           total_steps=10))
    step_j = jstep.make_train_step(jstep.unet_distill_loss_fn, opt_j, jfrozen, sched_j, jcfg,
                                   donate=False)
    state_j, metrics_j = step_j(jstep.init_state(jtrain, opt_j), jbatch, jax.random.PRNGKey(0))

    opt_t = topt.make_optimizer("cadamw", tstep.trainable_parameters(tparams), LR,
                                warmup_steps=0, total_steps=10)
    step_t = tstep.make_train_step(tstep.unet_distill_loss_fn, tfrozen, sched_t, tcfg)
    grads_t = {}  # the gradients the optimizer is given
    real_step = opt_t.step

    def capture():
        grads_t.update({name: p.grad.clone() for name, p in tparams["sbg"].named_parameters()
                        if p.grad is not None})
        return real_step()

    opt_t.step = capture
    state_t, metrics_t = step_t(tstep.init_state(tparams, opt_t), tbatch)
    for key in ("loss", "loss_unet_distill", "loss_prompt_emb_delta", "grad_norm"):
        assert_rel(metrics_t[key].item(), metrics_j[key], what=key)
    zeros = {k: jnp.zeros_like(v) if k in ("token_embedding", "position_embedding") else v
             for k, v in jfrozen["sbg_buffers"].items()}
    gref = _jax_sbg_state_dict(state_j.opt_state[0]["g"]["sbg"], zeros, ref_sd)
    for name in set(gref) - set(grads_t) - set(tstep.FROZEN_SBG_PARAMS):
        assert not np.asarray(gref[name]).any(), name  # off the face path: no gradient
    names = sorted(grads_t)
    flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
    assert rel_l2(flat({n: g.numpy() for n, g in grads_t.items()}), flat(gref)) <= GRAD_REL_L2
    scale = np.linalg.norm(flat(gref))
    for name in names:
        g, r = grads_t[name].numpy(), np.asarray(gref[name])
        if name.endswith("attn.k.bias"):
            assert np.linalg.norm(g) <= 1e-6 * scale and np.linalg.norm(r) <= 1e-6 * scale
        else:
            assert rel_l2(g, r) <= GRAD_REL_L2, name
    pref = _jax_sbg_state_dict(state_j.params["sbg"], jfrozen["sbg_buffers"], ref_sd)
    moved = 0.0
    for name, p in state_t.params["sbg"].state_dict().items():
        assert_rel(p.numpy(), pref[name], what=name)
        moved = max(moved, float(np.abs(p.numpy() - ref_sd[name].numpy()).max()))
    assert moved > LR / 2  # the update is not lost in the tolerance
