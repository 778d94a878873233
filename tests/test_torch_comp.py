"""The Stage-2 modules of the PyTorch port against the JAX package, on the
CPU: the UNet's attention and FFN adapters with their runtime flags and the
full activation capture (`models/unet.py`), the adapters through the bridge
both ways, the comp-distill losses (`train/comp_losses.py`), the pieces of
the comp identity losses (`train/comp_face_align.py`), the Laplacian
variance (`train/recon_multistep.py`) and the fg-seeded start
(`train/init_x.py`); the recon and unet-distill losses with the adapters
trained, through `make_train_step` on both sides; `Trainer.fit` over a
Stage-2 plan with the adapters checkpointed; the CLI on
`configs/stage2-comp-distill.yaml` (its modules patched to tiny ones) and
its YAML sections filtered as `train.py` filters them.

fp32 at the tiny widths of `tests/test_torch_recon.py` (a two-level UNet, 16x16
latents: its top level's 256 tokens take the flash path in the port), one
set of numpy weights on both sides, and JAX's highest-precision matmuls.
Adapters are drawn with non-zero B matrices and magnitudes off 1, so each
part of DoRA shows.

Tolerances: the UNet's output and every captured tensor 1e-5 relative to
the largest magnitude; its gradients (the input, the context and each
adapter's tensors) 1e-4 relative L2 over each set; the loss functions 1e-5
relative (their gradients 1e-4 relative L2); a train step's loss and
metrics 1e-5, its gradients 1e-4 relative L2 over each trained part, and
the parts no loss reaches exactly 0 on both sides; the Laplacian variance
and the fg-seeded start 1e-6; box geometry and the proportion classes equal.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu.train import comp_step as jcomp
from adaface_tpu.train import comp_face_align as jcfa
from adaface_tpu.train import comp_losses as jcl
from adaface_tpu.train import init_x as jinit
from adaface_tpu.train import recon_multistep as jrm
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.data.personalized import PersonalizedBase
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.train import comp_face_align as tcfa
from adaface_tpu_torch.train import comp_losses as tcl
from adaface_tpu_torch.train import init_x as tinit
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
from adaface_tpu_torch.train import comp_step as tcomp
from adaface_tpu_torch.train import recon_multistep as trm
from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from adaface_tpu_torch.train.train_step import TrainConfig
from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig
from adaface_tpu_torch.utils.tensor import Draws
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu.train import train_step as jstep
from adaface_tpu_torch.ops import schedules as tsched
from adaface_tpu_torch.train import optimizers as topt
from adaface_tpu_torch.train import recon_step as trecon
from adaface_tpu_torch.train import train_step as tstep
from tests.test_torch_models import D, UNET_KW, VAE_KW, numpy_params
from tests.test_torch_recon import RECON_UNET_KW, SmoothTower
from tests.test_torch_train import (TRAIN_TEXT_KW, _jax_sbg_state_dict, _keep_grads,
                                    build_step_pair, make_batch, make_png_dataset)
from tests.test_torch_trainer import port_stack

RTOL = 1e-5
GRAD_REL_L2 = 1e-4
HW = 16
REPO = pathlib.Path(__file__).resolve().parent.parent
# the comp tests' UNet: the recon tests' two levels, adapters at rank 4
COMP_UNET_KW = dict(RECON_UNET_KW, lora_rank=4, lora_alpha=2)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: its tensors are tiny, and
    under several test workers on one host a pool of threads per process
    turns each of the many small operations into a wait for descheduled
    threads (the Stage-2 fit took 1011 s so, 8 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)




def assert_rel(out, ref, rtol=RTOL, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: max error {err:.3e} of the largest |ref|"


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def lora_trees(cfg_j, seed: int):
    """Attention and FFN adapter trees in the JAX layout with every part
    live: A at the initialisers' scale, B at a third of it, magnitudes and
    scale factors off their start."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        a = np.asarray(rs.randn(*s.shape), np.float32)
        if name == "a":
            return jnp.asarray(a / np.sqrt(np.prod(s.shape[:-1])))
        if name == "b":
            return jnp.asarray(a * 0.3 / np.sqrt(s.shape[-2]))
        if name == "mag":
            return jnp.asarray(1.0 + 0.2 * a)
        return jnp.asarray(0.8 + 0.1 * a)  # scale_factor

    key = jax.random.PRNGKey(0)
    attn = jax.eval_shape(lambda k: junet.init_attn_lora_params(k, cfg_j), key)
    ffn = jax.eval_shape(lambda k: junet.init_ffn_lora_params(k, cfg_j,
                                                              lora_rank=cfg_j.lora_rank), key)
    return (jax.tree_util.tree_map_with_path(leaf, attn),
            jax.tree_util.tree_map_with_path(leaf, ffn))


@pytest.fixture(scope="module")
def unet_pair():
    """(JAX config, params, attn LoRA, FFN LoRA; the port's UNet, AttnLoRA,
    FFNLoRA) on one set of weights."""
    cfg_j, cfg_t = junet.UNetConfig(**COMP_UNET_KW), tunet.UNetConfig(**COMP_UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 110)
    attn, ffn = lora_trees(cfg_j, 111)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    return (cfg_j, params, attn, ffn,
            model, bridge.load_lora(tunet.AttnLoRA(cfg_t), attn),
            bridge.load_lora(tunet.FFNLoRA(cfg_t), ffn))


def unet_inputs(b: int, seed: int = 112):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 4, HW, HW).astype(np.float32)
    t = rs.randint(100, 900, (b,)).astype(np.int32)
    ctx = rs.randn(b, 12, D).astype(np.float32)
    subj = np.zeros((b, 12), np.float32)
    subj[:, 2:6] = 1.0
    subj[0] = 0.0  # a row without subject tokens, as the ss block of a comp step
    kv = np.ones((b, 12), np.float32)
    kv[-1, 9:] = 0.0
    return x, t, ctx, subj, kv


# (label, batch, runtime kwargs, adapters given, attn gate, ffn gate, kv mask)
UNET_CASES = [
    ("attn_lora_capture", 2, dict(capture=True, use_attn_lora=True), "attn", None, None, False),
    ("attn_gate_q2_query_kv_mask", 2,
     dict(capture=True, use_attn_lora=True, q_lora_updates_query=True), "attn", [1.0, 0.0],
     None, True),
    ("attn_lora_flash_path", 2, dict(use_attn_lora=True), "attn", [0.0, 1.0], None, False),
    ("ffn_comp_adapter_gate", 2, dict(use_ffn_lora=True, ffn_adapter="comp_distill"), "ffn",
     None, [1.0, 0.0], False),
    ("ffn_recon_adapter", 2, dict(capture=True, use_ffn_lora=True, ffn_adapter="recon_loss"),
     "both", None, None, False),
    ("normalize", 2, dict(capture=True, normalize_cross_attn=True, use_attn_lora=True), "attn",
     None, None, False),
    ("normalize_without_lora", 2, dict(normalize_cross_attn=True), None, None, None, False),
    ("mix", 2, dict(capture=True, mix_attn_mats_in_batch=True), None, None, None, False),
    # the two runtimes of a comp step (`comp_distill_denoise`): the conditional
    # call over [ss, sc, sc_rep, mc] and the unconditional one
    ("comp_cond", 4, dict(capture=True, use_attn_lora=True, use_ffn_lora=True,
                          ffn_adapter="comp_distill", normalize_cross_attn=True,
                          res_hidden_gradscale=0.5), "both", [1.0, 1.0, 1.0, 0.0],
     [1.0, 1.0, 1.0, 0.0], False),
    ("comp_uncond", 4, dict(use_ffn_lora=True, ffn_adapter="comp_distill"), "ffn", None,
     [1.0, 1.0, 1.0, 1.0], False),
]


def _case_args(case, attn, ffn, lib):
    label, b, rt_kw, adapters, agate, fgate, use_kv = case
    x, t, ctx, subj, kv = unet_inputs(b)
    kw = {}
    if adapters in ("attn", "both"):
        kw["attn_lora"] = attn
    if adapters in ("ffn", "both"):
        kw["ffn_lora"] = ffn
    arr = jnp.asarray if lib == "jax" else _t
    if agate is not None:
        kw["attn_lora_gate"] = arr(np.asarray(agate, np.float32))
    if fgate is not None:
        kw["ffn_lora_gate"] = arr(np.asarray(fgate, np.float32))
    if use_kv:
        kw["kv_mask"] = arr(kv)
    kw["subj_mask"] = arr(subj)
    return (x, t, ctx), rt_kw, kw


def _flat_capture(cap):
    return {f"{key}/{label}": v for key, layers in cap.items() for label, v in layers.items()}


@pytest.mark.parametrize("case", UNET_CASES, ids=[c[0] for c in UNET_CASES])
def test_unet_adapters_and_capture_match_jax(unet_pair, case):
    """The UNet with each adapter, gate and runtime flag against `unet_apply`:
    the noise prediction and every captured tensor."""
    cfg_j, params, attn, ffn, model, t_attn, t_ffn = unet_pair
    (x, t, ctx), rt_kw, jkw = _case_args(case, attn, ffn, "jax")
    _, _, tkw = _case_args(case, t_attn, t_ffn, "torch")
    rt_j = junet.AttnRuntime(**rt_kw)
    eps_j, cap_j = jax.jit(lambda x, t, c, kw: junet.unet_apply(params, x, t, c, cfg_j,
                                                                 rt=rt_j, **kw))(x, t, ctx, jkw)
    cap_t = {} if rt_kw.get("capture") else None
    with torch.no_grad():
        eps_t = model(_t(x), _t(t).long(), _t(ctx), capture=cap_t,
                      rt=tunet.AttnRuntime(**rt_kw), **tkw)
    assert_rel(eps_t.numpy(), eps_j, what="eps")
    if cap_t is None:
        assert not cap_j
        return
    fj, ft = _flat_capture(cap_j), _flat_capture(cap_t)
    assert set(ft) == set(fj) and len(fj) == 8 * 2  # 8 keys × the two captured layers
    for key, ref in fj.items():
        assert_rel(ft[key].numpy(), ref, what=key)


def test_comp_cond_gradients_match_jax(unet_pair):
    """Gradients through the comp step's conditional runtime (normalization
    with the scale factor's 10× gradient, both adapters gated, the skip
    features' gradient scale 0.5): of the latents, the context and every
    adapter tensor, for a loss on the output and on the captured tensors."""
    cfg_j, params, attn, ffn, model, t_attn, t_ffn = unet_pair
    case = next(c for c in UNET_CASES if c[0] == "comp_cond")
    (x, t, ctx), rt_kw, jkw = _case_args(case, attn, ffn, "jax")
    _, _, tkw = _case_args(case, t_attn, t_ffn, "torch")
    rs = np.random.RandomState(113)
    g_eps = rs.randn(*x.shape).astype(np.float32)
    rt_j = junet.AttnRuntime(**rt_kw)

    def loss_j(x, c, a, f):
        eps, cap = junet.unet_apply(params, x, t, c, cfg_j, rt=rt_j,
                                    **dict(jkw, attn_lora=a, ffn_lora=f))
        return ((eps * g_eps).sum() + (cap["attn"][23] ** 2).sum()
                + (cap["q2"][22] * cap["attn_out"][22]).sum() + (cap["outfeat"][23] ** 2).mean())

    gj = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(x, ctx, attn, ffn)
    xt, ct = _t(x).requires_grad_(), _t(ctx).requires_grad_()
    for p in (*t_attn.parameters(), *t_ffn.parameters()):
        p.grad = None
    cap = {}
    eps = model(xt, _t(t).long(), ct, capture=cap, rt=tunet.AttnRuntime(**rt_kw), **tkw)
    loss = ((eps * _t(g_eps)).sum() + (cap["attn"][23] ** 2).sum()
            + (cap["q2"][22] * cap["attn_out"][22]).sum() + (cap["outfeat"][23] ** 2).mean())
    loss.backward()
    assert rel_l2(xt.grad.numpy(), gj[0]) <= GRAD_REL_L2
    assert rel_l2(ct.grad.numpy(), gj[1]) <= GRAD_REL_L2
    for module, tree in ((t_attn, gj[2]), (t_ffn, gj[3])):
        ref = bridge.lora_state_dict(tree)
        names = sorted(n for n, _ in module.named_parameters())
        got = {n: p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
               for n, p in module.named_parameters()}
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
        assert rel_l2(flat(got), flat(ref)) <= GRAD_REL_L2
        for n in names:  # the unused adapters (the other FFN names, layer 24) stay 0
            assert (np.abs(ref[n].numpy()).max() == 0) == (np.abs(got[n]).max() == 0), n
    assert np.abs(t_attn["22"].scale_factor.grad.numpy()) > 0


def test_lora_bridge_round_trip(unet_pair):
    """JAX's adapter trees → the port's modules → back, bit for bit, and the
    initialisers' scales and shapes."""
    cfg_j, _, attn, ffn, _, t_attn, t_ffn = unet_pair
    for module, tree in ((t_attn, attn), (t_ffn, ffn)):
        back = bridge.lora_tree(module)
        flat_ref = dict(bridge._walk(jax.tree_util.tree_map(np.asarray, tree), ""))
        flat_back = dict(bridge._walk(back, ""))
        assert set(flat_back) == set(flat_ref)
        for k, v in flat_ref.items():
            np.testing.assert_array_equal(flat_back[k], v)
    cfg_t = tunet.UNetConfig(**COMP_UNET_KW)
    fresh = tunet.AttnLoRA(cfg_t), tunet.FFNLoRA(cfg_t)
    init_j = (junet.init_attn_lora_params(jax.random.PRNGKey(1), cfg_j),
              junet.init_ffn_lora_params(jax.random.PRNGKey(2), cfg_j, lora_rank=4))
    gen = torch.Generator().manual_seed(0)
    for module, tree in zip(fresh, init_j):
        tunet.init_lora_weights_(module, gen)
        ref = bridge.lora_state_dict(tree)
        sd = module.state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                               for k, v in ref.items()}
        for k, v in sd.items():
            if k.endswith(("lora_b", "magnitude", "scale_factor")):
                np.testing.assert_array_equal(v.numpy(), ref[k].numpy())
            else:  # A: the same scale, other draws
                assert abs(v.std().item() / ref[k].std().item() - 1) < 0.35, k


# ---------------------------------------------------------------------------
# train/comp_losses.py
# ---------------------------------------------------------------------------

def fake_capture(b: int = 2, c: int = 16, hw: int = 8, heads: int = 2, s: int = 12,
                 seed: int = 130, layers=(22, 23, 24)):
    """A capture dict of the 4-block batch, numpy: q2, attn_out, outfeat
    [4B, C, N] ([4B, C, H, W] for outfeat), attn and attnscore [4B, H, N, S],
    k and v [4B, C, S]."""
    rs = np.random.RandomState(seed)
    n, b4 = hw * hw, 4 * b
    cap = {}
    for layer in layers:
        logits = rs.randn(b4, heads, n, s).astype(np.float32)
        attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        for key, val in (("q2", rs.randn(b4, c, n)), ("attn_out", rs.randn(b4, c, n)),
                         ("outfeat", rs.randn(b4, c, hw, hw)), ("attn", attn),
                         ("attnscore", logits), ("k", rs.randn(b4, c, s)),
                         ("v", rs.randn(b4, c, s))):
            cap.setdefault(key, {})[layer] = np.asarray(val, np.float32)
    return cap


SS_BOXES = np.array([[1, 2, 6, 7], [0, 0, 8, 8]], np.float32)
SC_BOXES = np.array([[2, 1, 7, 5], [3, 3, 4, 4]], np.float32)


def _grads_of(fn_j, fn_t, arrays):
    """(value, gradients) of a scalar function of numpy arrays on both sides."""
    vj, gj = jax.value_and_grad(fn_j, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [_t(a).requires_grad_() for a in arrays]
    vt = fn_t(*ts)
    vt.backward()
    return ((float(vt.detach()), [t.grad.numpy() for t in ts]),
            (float(vj), [np.asarray(g) for g in gj]))


def test_crop_resize_and_recon_with_attn_match_jax():
    rs = np.random.RandomState(131)
    feat = rs.randn(2, 3, 8, 8).astype(np.float32)
    boxes = np.array([[1, 2, 6, 7], [5, 5, 5, 9]], np.float32)  # the second is empty
    assert_rel(tcl._crop_resize_feat(_t(feat), _t(boxes)).numpy(),
               jcl._crop_resize_feat(jnp.asarray(feat), jnp.asarray(boxes)))
    prob = rs.rand(2, 64, 64).astype(np.float32)
    f = rs.randn(2, 3, 64).astype(np.float32)
    assert_rel(tcl._recon_with_attn(_t(f), _t(prob)).numpy(),
               jcl._recon_with_attn(jnp.asarray(f), jnp.asarray(prob)))


@pytest.mark.parametrize("shrink", [1.0, 0.3])
def test_elastic_matching_loss_matches_jax(shrink):
    """Every loss of the elastic matching, and the gradients of the min losses'
    weighted sum with respect to q, attn_out and outfeat."""
    cap = fake_capture()
    q, ao, of = cap["q2"][22], cap["attn_out"][22], cap["outfeat"][22].reshape(8, 16, 64)
    kw = dict(h=8, w=8, sc_face_shrink_ratio=shrink)
    lj = jcl.calc_elastic_matching_loss(q, ao, of, ss_face_bboxes=jnp.asarray(SS_BOXES),
                                        sc_face_bboxes=jnp.asarray(SC_BOXES), **kw)
    lt = tcl.calc_elastic_matching_loss(_t(q), _t(ao), _t(of), ss_face_bboxes=_t(SS_BOXES),
                                        sc_face_bboxes=_t(SC_BOXES), **kw)
    assert set(lt) == set(lj)
    for k, v in lj.items():
        assert_rel(float(lt[k]), float(v), what=k)

    def total(mod, boxes):
        return lambda q_, a_, o_: (lambda l: l["sc_recon_ssfg_min"] + 2 * l["sc_recon_mc_min"]
                                   + l["sc_to_mc_sparse_attns_distill"])(
            mod.calc_elastic_matching_loss(q_, a_, o_, ss_face_bboxes=boxes[0],
                                           sc_face_bboxes=boxes[1], **kw))

    (vt, gt), (vj, gj) = _grads_of(total(jcl, (jnp.asarray(SS_BOXES), jnp.asarray(SC_BOXES))),
                                   total(tcl, (_t(SS_BOXES), _t(SC_BOXES))), [q, ao, of])
    assert_rel(vt, vj)
    for g, r in zip(gt, gj):
        assert np.abs(r).max() > 0 and rel_l2(g, r) <= GRAD_REL_L2


def test_elastic_matching_refuses_a_flow():
    """The flow candidate is ported (`tests/test_torch_comp_flow.py` holds it
    to JAX): a zero flow gives the no-flow losses exactly; what is not a
    [B, 2, h, w] flow is refused."""
    cap = fake_capture()
    args = (_t(cap["q2"][22]), _t(cap["attn_out"][22]),
            _t(cap["outfeat"][22].reshape(8, 16, 64)), 8, 8, _t(SS_BOXES), _t(SC_BOXES))
    ref = tcl.calc_elastic_matching_loss(*args)
    zero = tcl.calc_elastic_matching_loss(*args, flow_fn=lambda q, s, h, w, t: torch.zeros(
        q.shape[0], 2, h, w))
    assert set(zero) == set(ref)
    for k, v in ref.items():
        assert torch.equal(zero[k], v), k
    with pytest.raises((AttributeError, TypeError)):
        tcl.calc_elastic_matching_loss(*args, flow_fn=lambda *a: None)


@pytest.mark.parametrize("suppress", [0.0, 1.0])
def test_comp_subj_bg_preserve_loss_matches_jax(suppress):
    cap = fake_capture()
    kw = dict(do_sc_fg_faces_suppress=suppress, sc_face_shrink_ratio=0.3 if suppress else 1.0)
    lj, mj = jcl.calc_comp_subj_bg_preserve_loss(jax.tree_util.tree_map(jnp.asarray, cap),
                                                 jnp.asarray(SS_BOXES), jnp.asarray(SC_BOXES),
                                                 **kw)
    tcap = {k: {l: _t(v) for l, v in d.items()} for k, d in cap.items()}
    lt, mt = tcl.calc_comp_subj_bg_preserve_loss(tcap, _t(SS_BOXES), _t(SC_BOXES), **kw)
    assert_rel(float(lt), float(lj))
    assert set(mt) == set(mj)
    for k, v in mj.items():
        assert_rel(float(mt[k]), float(v), what=k)


@pytest.mark.parametrize("pct", [0.05, 0.22, 0.4])
def test_rep_distill_cross_t_and_dyn_scale_match_jax(pct):
    """`calc_sc_rep_attn_distill_loss` (its five losses and their gradients
    with respect to attn, k and v; 0 under the face-area threshold),
    `calc_subj_attn_cross_t_diff_loss` and `calc_dyn_loss_scale`."""
    cap, fut = fake_capture(), fake_capture(seed=132)
    rs = np.random.RandomState(133)
    subj = np.zeros((2, 12), np.float32)
    subj[:, 3:7] = 1.0
    emb = (rs.rand(8, 12, 1) > 0.3).astype(np.float32)
    pad = (rs.rand(8, 12, 1) > 0.7).astype(np.float32)
    lay = (23, 24)
    arrays = [cap[k][l] for k in ("attn", "k", "v") for l in lay]

    def rep(mod, arr, keys):
        def fn(*xs):
            c = {k: {l: xs[i * 2 + j] for j, l in enumerate(lay)}
                 for i, k in enumerate(("attn", "k", "v"))}
            out = mod.calc_sc_rep_attn_distill_loss(c, arr(subj), arr(emb), arr(pad), pct)
            return sum(out[k] * (i + 1) for i, k in enumerate(keys))
        return fn

    keys = ("subj_attn", "subj_k", "nonsubj_k", "subj_v", "nonsubj_v")
    (vt, gt), (vj, gj) = _grads_of(rep(jcl, jnp.asarray, keys), rep(tcl, _t, keys), arrays)
    assert_rel(vt, vj)
    if pct < 0.1:
        assert vj == 0 and vt == 0
    else:
        for g, r in zip(gt, gj):
            assert rel_l2(g, r) <= GRAD_REL_L2
    jc = jax.tree_util.tree_map(jnp.asarray, cap)
    tc = {k: {l: _t(v) for l, v in d.items()} for k, d in cap.items()}
    jf = jax.tree_util.tree_map(jnp.asarray, fut)
    tf = {k: {l: _t(v) for l, v in d.items()} for k, d in fut.items()}
    assert_rel(float(tcl.calc_subj_attn_cross_t_diff_loss(tc, tf, _t(subj))),
               float(jcl.calc_subj_attn_cross_t_diff_loss(jc, jf, jnp.asarray(subj))))
    for args in (((0.2, 0.5), (0.25, 2.0), (0.05, 2.0)), ((0.1, 1.0), (0.4, 0.0), (0.0, 100.0))):
        assert_rel(float(tcl.calc_dyn_loss_scale(pct, *args[:2], valid_scale_range=args[2])),
                   float(jcl.calc_dyn_loss_scale(pct, *args[:2], valid_scale_range=args[2])))


# ---------------------------------------------------------------------------
# train/comp_face_align.py pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", [False, True])
def test_paste_resized_crop_and_bbox_mask_match_jax(noise):
    rs = np.random.RandomState(140)
    dst, src = rs.randn(2, 4, 16, 16).astype(np.float32), rs.randn(2, 4, 16, 16).astype(np.float32)
    db = np.array([[2, 3, 10, 12], [0, 0, 16, 16]], np.float32)
    sb = np.array([[5, 1, 13, 6], [4, 4, 5, 5]], np.float32)
    rn = rs.randn(2, 4, 16, 16).astype(np.float32) if noise else None
    ref = jcfa.paste_resized_crop(jnp.asarray(dst), jnp.asarray(db), jnp.asarray(src),
                                  jnp.asarray(sb), (0.5, 0.25, 0.25),
                                  None if rn is None else jnp.asarray(rn))
    out = tcfa.paste_resized_crop(_t(dst), _t(db), _t(src), _t(sb), (0.5, 0.25, 0.25),
                                  None if rn is None else _t(rn))
    assert_rel(out.numpy(), ref)
    np.testing.assert_array_equal(tcfa._bbox_mask(_t(db), 16, 16).numpy(),
                                  np.asarray(jcfa._bbox_mask(jnp.asarray(db), 16, 16)))


# (sc_pct, mc_pct, overlap): one case a class, then the chain's boundaries
PROPORTIONS = [(0.0, 0.3, 0.5), (0.1, 0.0, 0.0), (0.05, 0.04, 0.1), (0.02, 0.1, 0.9),
               (0.4, 0.3, 0.9), (0.2, 0.01, 0.9), (0.2, 0.1, 0.9), (0.0576, 0.0, 0.0),
               (0.0225, 0.01, 0.16), (0.36, 0.2, 0.5)]


@pytest.mark.parametrize("sc,mc,ov", PROPORTIONS)
def test_proportion_classes_and_scales_match_jax(sc, mc, ov):
    """The proportion class (every class reached), then the align and
    suppression scales it sets, at a few kept fractions and fg-suppress
    losses (0 among them)."""
    f32 = np.float32
    pj = jcfa.classify_sc_face_proportion(f32(sc), f32(mc), f32(ov))
    pt = tcfa.classify_sc_face_proportion(torch.tensor(sc), torch.tensor(mc), torch.tensor(ov))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for frac, la, lfg in ((0.9, 0.5, 0.02), (0.1, 0.3, 0.0), (0.5, 0.0, 0.4)):
        sj = jcfa.compute_align_scales(pj, f32(frac), f32(la), f32(lfg))
        st = tcfa.compute_align_scales(pt, torch.tensor(frac), torch.tensor(la),
                                       torch.tensor(lfg))
        for a, r in zip(st, sj):
            assert_rel(float(a), float(r))


@pytest.mark.parametrize("thres,count", [(0.7, 3), (-1.0, 3), (0.7, 1)])
def test_align_gates_match_jax(thres, count):
    la = np.array([0.9, 0.2, 0.65, 0.3, 0.5], np.float32)
    g = np.array([1, 0, 1, 1, 1], np.float32)
    ref = jcfa.assemble_align_gates(jnp.asarray(la), jnp.asarray(g), thres, count)
    out = tcfa.assemble_align_gates(_t(la), _t(g), thres, count)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# train/recon_multistep.py var_of_laplacian, train/init_x.py
# ---------------------------------------------------------------------------

def test_var_of_laplacian_matches_jax():
    imgs = np.random.RandomState(150).uniform(-1, 1, (3, 3, 40, 32)).astype(np.float32)
    assert_rel(trm.var_of_laplacian(_t(imgs)).numpy(),
               np.asarray(jrm.var_of_laplacian(jnp.asarray(imgs))), 1e-6)


@pytest.mark.parametrize("pct,seed", [(0.1, 0), (0.45, 1), (0.9, 2)])
def test_init_x_matches_jax(pct, seed):
    """The host plan (scale, offsets) equal from the same RandomState, with
    and without the canvas size; the seeded start and its mask with the
    noises handed over."""
    for hw in (None, (16, 16)):
        assert tinit.plan_fg_init(pct, np.random.RandomState(seed), hw=hw) == \
            jinit.plan_fg_init(pct, np.random.RandomState(seed), hw=hw)
    scale, dh, dw = jinit.plan_fg_init(pct, np.random.RandomState(seed), hw=(16, 16))
    rs = np.random.RandomState(151 + seed)
    x = rs.randn(2, 4, 16, 16).astype(np.float32)
    fg = (rs.rand(2, 1, 16, 16) < pct).astype(np.float32)
    noises = [rs.randn(2, 4, 16, 16).astype(np.float32) for _ in range(3)]
    ref = jinit.init_x_with_fg_from_training_image(
        jnp.asarray(x), jnp.asarray(fg), scale=scale, dh=dh, dw=dw,
        bg_noise1=jnp.asarray(noises[0]), bg_noise2=jnp.asarray(noises[1]),
        blend_noise=jnp.asarray(noises[2]))
    out = tinit.init_x_with_fg_from_training_image(
        _t(x), _t(fg), Draws(handed=noises), scale=scale, dh=dh, dw=dw)
    for o, r in zip(out, ref):
        assert_rel(o.numpy(), r, 1e-6)


# ---------------------------------------------------------------------------
# one train step on both sides, the adapters trained
# ---------------------------------------------------------------------------

def fixed_faces(img):
    """A confident foreground face and a background one, whatever the pixels."""
    return [(np.array([8, 6, 52, 50], np.float32), 1.0),
            (np.array([0, 30, 24, 62], np.float32), 0.8)]


TRAINED = ("sbg", "attn_lora", "ffn_lora")
B = 2


def with_adapters(seed: int = 120):
    """`build_step_pair`'s stacks with both adapters trained (their trees
    from `lora_trees`) on the comp tests' UNet."""
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = build_step_pair(
        seed=seed, unet_kw=COMP_UNET_KW)
    cfg_t = tunet.UNetConfig(**COMP_UNET_KW)
    attn, ffn = lora_trees(junet.UNetConfig(**COMP_UNET_KW), seed + 1)
    jtrain = dict(jtrain, attn_lora=attn, ffn_lora=ffn)
    tparams = dict(tparams, attn_lora=bridge.load_lora(tunet.AttnLoRA(cfg_t), attn),
                   ffn_lora=bridge.load_lora(tunet.FFNLoRA(cfg_t), ffn))
    return (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm)


@pytest.fixture(scope="module")
def adapter_stacks():
    return with_adapters()


def jax_grads_state_dicts(g, jfrozen, tparams):
    """The JAX gradient tree as the port's state dicts, by trained part."""
    zeros = {k: jnp.zeros_like(v) if k in ("token_embedding", "position_embedding") else v
             for k, v in jfrozen["sbg_buffers"].items()}
    out = {"sbg": _jax_sbg_state_dict(g["sbg"], zeros, tparams["sbg"].state_dict())}
    for part in ("attn_lora", "ffn_lora", "unet"):
        if part in g:
            out[part] = (bridge.lora_state_dict(g[part]) if part != "unet" else
                         bridge.fuse_projections(bridge.state_dict(g[part]),
                                                 tparams["unet"].state_dict()))
    return out


def jax_step(loss_fn, jfrozen, jtrain, jcfg, batch):
    """One JAX step of `loss_fn` with zero updates → (metrics, gradients)."""
    opt = optax.chain(_keep_grads(), optax.set_to_zero())
    step = jstep.make_train_step(loss_fn, opt, jfrozen, jsched.DiffusionSchedule.create(), jcfg,
                                 donate=False)
    state, metrics = step(jstep.init_state(jtrain, opt), batch, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in metrics.items()}, state.opt_state[0]["g"]


def port_step(loss_fn, tfrozen, tparams, tcfg, batch):
    """One port step of `loss_fn` at lr 0 → (metrics, the gradients the
    optimizer is given, by trained part and name)."""
    opt = topt.make_optimizer("cadamw", tstep.trainable_parameters(tparams), 0.0,
                              warmup_steps=0, total_steps=10)
    grads, real_step = {}, opt.step

    def capture():
        for part in TRAINED + ("unet",):
            if part in tparams:
                grads[part] = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                               for n, p in tparams[part].named_parameters() if p.requires_grad}
        return real_step()

    opt.step = capture
    step = tstep.make_train_step(loss_fn, tfrozen, tsched.DiffusionSchedule.create(), tcfg)
    _, metrics = step(tstep.init_state(tparams, opt), batch)
    return metrics, grads


def assert_step_matches(metrics, grads, jmetrics, jgrads, parts):
    assert set(metrics) == set(jmetrics)
    for key, ref in jmetrics.items():
        assert_rel(metrics[key].item(), ref, GRAD_REL_L2 if key == "grad_norm" else 1e-5, key)
    for part in parts:
        names = sorted(grads[part])
        flat = lambda d: np.concatenate([np.asarray(d[n]).ravel() for n in names])  # noqa: E731
        got = flat({n: g.numpy() for n, g in grads[part].items()})
        ref = flat(jgrads[part])
        assert np.abs(got).max() > 0, part
        assert rel_l2(got, ref) <= GRAD_REL_L2, part
        for n in names:  # the parts no loss reaches are exactly 0 on both sides
            assert (np.abs(grads[part][n].numpy()).max() == 0) == (
                np.abs(np.asarray(jgrads[part][n])).max() == 0), (part, n)


# ---------------------------------------------------------------------------
# the recon and unet-distill losses with the adapters trained
# ---------------------------------------------------------------------------

def four_block_batch(jm, tm):
    """make_batch's 4-block prompts and latents, with the masks a recon batch
    carries and the attn-LoRA gate on."""
    jb, tb = make_batch(jm, tm, 0, seed=126)
    img_mask = np.ones((B, 1, HW, HW), np.float32)
    img_mask[1, :, :, -3:] = 0.0
    fg = np.ones((B, 1, HW, HW), np.float32)
    fg[:, :, :, HW // 2:] = 0.0
    extra = {"img_mask": img_mask, "fg_mask": fg, "face_detected": np.ones((B,), np.float32),
             "recon_attn_lora_gate": np.float32(1.0)}
    jb.update({k: jnp.asarray(v) for k, v in extra.items()})
    tb.update({k: torch.from_numpy(np.array(v)) for k, v in extra.items()})
    return jb, tb


# (label, the JAX loss, the port's, the parts the loss reaches)
ADAPTER_LOSSES = [
    ("recon_single_step", jstep.recon_loss_fn, tstep.recon_loss_fn, TRAINED),
    ("unet_distill", jstep.unet_distill_loss_fn, tstep.unet_distill_loss_fn,
     ("sbg", "ffn_lora")),
    ("recon_v2_images", jrecon.make_recon_loss_fn(jrecon.ReconStepConfig(
        compute_dtype="float32", num_priming_steps=2), None),
     trecon.make_recon_loss_fn(trecon.ReconStepConfig(compute_dtype="float32",
                                                      num_priming_steps=2), None),
     ("sbg", "attn_lora")),
]


@pytest.mark.parametrize("label,jfn,tfn,parts", ADAPTER_LOSSES,
                         ids=[c[0] for c in ADAPTER_LOSSES])
def test_adapters_in_recon_and_unet_distill_match_jax(adapter_stacks, label, jfn, tfn, parts):
    """The single-step recon loss with both adapters (FFN "recon_loss"), the
    unet-distill loss (FFN "unet_distill") and the recon iteration on images
    with the attention adapters gated on (no FFN adapter in recon), as
    `tests/test_train.py:test_recon_with_lora_adapters` trains them: the loss
    and its parts, the gradients of each trained part, and exactly 0 for the
    unused adapters (the other FFN names, k / v, the scale factors)."""
    (jfrozen, jtrain, jcfg, jm), (tfrozen, tparams, tcfg, tm) = adapter_stacks
    jcfg = dataclasses.replace(jcfg, training_perturb_prob=0.0)
    tcfg = dataclasses.replace(tcfg, training_perturb_prob=0.0)
    jb, tb = four_block_batch(jm, tm)
    if label.startswith("recon_v2"):
        from tests.test_torch_recon_step import handed_rand as recon_rand

        jr, tr = recon_rand(jb, jrecon.ReconStepConfig(num_priming_steps=2))
        jb, tb = dict(jb, recon_rand=jr), dict(tb, recon_rand=tr)
    jmetrics, g = jax_step(jfn, jfrozen, jtrain, jcfg, jb)
    jgrads = jax_grads_state_dicts(g, jfrozen, tparams)
    metrics, grads = port_step(tfn, tfrozen, tparams, tcfg, tb)
    assert_step_matches(metrics, grads, jmetrics, jgrads, parts)
    for part in set(TRAINED) - set(parts):  # an adapter the loss does not run
        assert all(not grads[part][n].any() for n in grads[part])
        assert all(not np.asarray(v).any() for v in jgrads[part].values())
    if "ffn_lora" in parts:
        used = "unet_distill" if label == "unet_distill" else "recon_loss"
        assert all(not grads["ffn_lora"][n].any() for n in grads["ffn_lora"]
                   if not n.startswith(used))


# ---------------------------------------------------------------------------
# the trainer and the CLI over Stage-2 plans
# ---------------------------------------------------------------------------

IMAGE_SIZE = 64  # latents 8x8
FIT_UNET_KW = dict(UNET_KW, lora_rank=4, lora_alpha=2)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    return make_png_dataset(tmp_path_factory.mktemp("pngs"), size=IMAGE_SIZE)


def stage2_trainer(log_dir, seed: int = 0):
    """`tests/test_torch_trainer.py`'s tiny stack with a VAE decoder, the
    smooth face tower for ArcFace and a detector of fixed faces, both adapters trained,
    comp-distill every 2nd iteration and unet-distill between: the plan
    comp (4 priming steps), recon, comp (3), unet-distill."""
    unet, text, vae, enc, tok = port_stack(seed)
    cfg_t = tunet.UNetConfig(**FIT_UNET_KW)
    fresh = tunet.UNet2DConditionModel(cfg_t).requires_grad_(False).eval()
    fresh.load_state_dict(unet.state_dict())
    gen = torch.Generator().manual_seed(seed + 1)
    cpu = torch.device("cpu")
    decoder = build(lambda: tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), cpu, torch.float32,
                    init_fan_in_, gen)
    lora = {"attn_lora": tunet.AttnLoRA(cfg_t), "ffn_lora": tunet.FFNLoRA(cfg_t)}
    for m in lora.values():
        tunet.init_lora_weights_(m, gen)
    cfg = TrainerConfig(log_dir=str(log_dir), batch_size=2, max_steps=4, accum_steps=2,
                        ckpt_every=4, optimizer="cadamw", lr=1e-3, warmup_steps=0,
                        image_size=IMAGE_SIZE, prefetch=0, echo_every=0,
                        comp_distill_iter_gap=2, unet_distill_iter_gap=2,
                        recon_cfg=trecon.ReconStepConfig(compute_dtype="float32"))
    tcfg = TrainConfig(unet=cfg_t, sbg=enc.sbg_cfg, clip_text=tclip.CLIPTextConfig(**TRAIN_TEXT_KW))
    return Trainer(cfg, tcfg, {"unet": fresh, "text_encoder": text},
                   {"sbg": enc.subj_basis_generator, **lora}, enc,
                   EmbeddingManager(tok, [PlaceholderSpec("z", 16)]), vae=vae,
                   vae_decoder=decoder, arcface=SmoothTower(),
                   host_detector=HostFaceDetector(detector_fn=fixed_faces),
                   comp_cfg=tcomp.CompDistillConfig(num_denoising_steps=2,
                                                    compute_dtype="float32"))


def adapter_state(trainer) -> dict:
    return {(k, n): t.detach().clone() for k in ("attn_lora", "ffn_lora")
            for n, t in trainer.state.params[k].state_dict().items()}


def test_stage2_fit_runs_comp_iterations_and_checkpoints_adapters(png_root, tmp_path):
    """`Trainer.fit` over 4 micro-steps of a Stage-2 plan: comp (keyed by its
    priming counts 4 and 3), recon and unet-distill steps with finite losses,
    the comp identity losses live and their face-kept window fed; the
    adapters and the SubjBasisGenerator move at each update; the checkpoint
    holds the adapters under `unet_lora_modules`, and a fresh trainer loads
    them equal."""
    trainer = stage2_trainer(tmp_path / "a")
    before = adapter_state(trainer)
    metrics, flags = [], []
    real = trainer._post_step

    def post(step, f, m):
        metrics.append({k: float(v) for k, v in m.items()})
        flags.append(f)
        return real(step, f, m)

    trainer._post_step = post
    trainer.fit(PersonalizedBase(png_root, num_vectors_per_subj_token=16, size=IMAGE_SIZE,
                                 seed=0), num_steps=4)
    assert [f.iter_type for f in flags] == ["comp_distill", "recon", "comp_distill",
                                            "unet_distill"]
    assert ("comp_distill", 4) in trainer._steps and ("comp_distill", 3) in trainer._steps
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[0]["comp_sc_face_detected"] == 1 and "loss_rep_distill" in metrics[2]
    assert len(trainer.face_stats.buffers["comp_sc_face_kept"]) == 2
    after = adapter_state(trainer)
    moved = {k[0] for k in before if not torch.equal(before[k], after[k])}
    assert moved == {"attn_lora", "ffn_lora"}
    ck = trainer.latest_ckpt(str(tmp_path / "a"))
    state, _ = load_adaface_ckpt(ck)
    lora = state["unet_lora_modules"]
    assert set(lora) == {"attn_lora", "ffn_lora"}
    for (k, n), t in after.items():
        assert torch.equal(lora[k][n], t)
    other = stage2_trainer(tmp_path / "b", seed=5)
    assert not all(torch.equal(t, after[k]) for k, t in adapter_state(other).items())
    other.load(ck)
    for k, t in adapter_state(other).items():
        assert torch.equal(t, after[k])


def tiny_stage2_stack(monkeypatch):
    """Patch the CLI's full-width modules to the tests' tiny ones: the UNet,
    the CLIP text tower, the VAE, a joint encoder with tiny Arc2Face and
    ConsistentID towers (the deterministic face backend), and `SmoothTower`
    for ArcFace."""
    import train_torch
    from adaface_tpu_torch.id2ada import face_id_to_ada_prompt as fid
    from adaface_tpu_torch.models import clip as clip_mod

    text_cfg = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    real = fid.create_id2ada_prompt_encoder
    vision = tclip.CLIPVisionConfig(hidden_size=D, num_layers=2, num_heads=2,
                                    intermediate_size=128, image_size=224, patch_size=32)

    def tiny_encoder(name, gen, tok, device, **kw):
        return real(name, gen, tok, device, **kw,
                    arc2face_kw=dict(text_cfg=text_cfg,
                                     sbg_cfg=SubjBasisConfig(clip=text_cfg)),
                    consistentid_kw=dict(vision_cfg=vision, proj_depth=1,
                                         sbg_cfg=SubjBasisConfig(num_id_vecs=4, clip=text_cfg)))

    monkeypatch.setattr(fid, "create_id2ada_prompt_encoder", tiny_encoder)
    monkeypatch.setattr(train_torch, "build_arcface", lambda *a: SmoothTower())
    monkeypatch.setattr(tunet, "UNet2DConditionModel",
                        lambda real=tunet.UNet2DConditionModel: real(tunet.UNetConfig(**UNET_KW)))
    monkeypatch.setattr(clip_mod, "CLIPTextModel",
                        lambda real=clip_mod.CLIPTextModel: real(text_cfg))
    for name in ("VAEEncoder", "VAEDecoder"):
        monkeypatch.setattr(tvae, name,
                            lambda real=getattr(tvae, name): real(tvae.VAEConfig(**VAE_KW)))


def test_cli_stage2_runs_every_iteration_type(monkeypatch, png_root, tmp_path):
    """`train_torch.py --base configs/stage2-comp-distill.yaml` on the CPU at
    tiny widths: the `comp_distill:` section read by field name (its
    `cls_comp_mix_ratio` dropped, as `train.py` drops it), no adapter trained
    (the `model:` LoRA keys are dropped the same way), and the micro-steps
    4-6 of the plan run comp, recon and unet-distill iterations (the planner
    first advanced over steps 0-3, as a run from step 0 advances it). The
    widths are cut by patching the modules; the images by
    `trainer.image_size` (64: 8x8 latents)."""
    import train_torch

    tiny_stage2_stack(monkeypatch)
    cfg, args = train_torch.parse_args([
        "trainer.image_size=64", "--base", str(REPO / "configs/stage2-comp-distill.yaml"),
        "--data_roots", png_root, "--log_dir", str(tmp_path), "--max_steps", "3",
        "--device", "cpu"])
    trainer, dataset, start = train_torch.build_trainer(cfg, args)
    assert set(trainer.state.params) == {"sbg"} and len(trainer.state.params["sbg"]) == 2
    yaml_comp = cfg["comp_distill"]
    assert trainer.comp_cfg.num_denoising_steps == yaml_comp["num_denoising_steps"] == 4
    assert trainer.comp_cfg.rep_distill_weight == yaml_comp["rep_distill_weight"]
    assert trainer.comp_cfg.cls_subj_mix_ratio == 0.6  # the default: cls_comp_mix_ratio dropped
    assert trainer.comp_cfg.compute_dtype == "float32"
    assert "arcface" in trainer.frozen and "vae" in trainer.frozen
    seen = []
    real = trainer._post_step

    def post(step, f, m):
        seen.append((f.iter_type, float(m["loss"])))
        return real(step, f, m)

    trainer._post_step = post
    assert [trainer.planner.plan(s).iter_type for s in range(4)] == [
        "comp_distill", "recon", "recon", "recon"]
    trainer.fit(dataset, num_steps=args.max_steps, start_step=start + 4)
    assert [t for t, _ in seen] == ["comp_distill", "recon", "unet_distill"]
    assert all(np.isfinite(loss) for _, loss in seen)


def test_yaml_sections_drop_the_keys_train_py_drops():
    """The Stage-2 configuration's `model:` and `comp_distill:` sections
    filtered into the port's configs keep and drop the same keys as
    `train.py` filters them into the JAX package's (`train.py:166-169`,
    `:193-196`): the LoRA keys and `cls_comp_mix_ratio` are read by nothing."""
    from adaface_tpu.train.train_step import TrainConfig as JTrainConfig
    from adaface_tpu_torch.utils import config as tconfig

    cfg = tconfig.load(str(REPO / "configs/stage2-comp-distill.yaml"))
    for port_cls, jax_cls, section in ((tcomp.CompDistillConfig, jcomp.CompDistillConfig,
                                        "comp_distill"), (TrainConfig, JTrainConfig, "model")):
        kept, dropped = tconfig.known_fields(port_cls, cfg[section])
        jax_fields = {f.name for f in dataclasses.fields(jax_cls)}
        assert set(kept) == {k for k in cfg[section] if k in jax_fields}
        assert set(dropped) == {k for k in cfg[section] if k not in jax_fields}
    assert tconfig.known_fields(tcomp.CompDistillConfig, cfg["comp_distill"])[1] == [
        "cls_comp_mix_ratio"]
    assert {"use_attn_lora", "use_ffn_lora", "lora_rank"} <= set(
        tconfig.known_fields(TrainConfig, cfg["model"])[1])
