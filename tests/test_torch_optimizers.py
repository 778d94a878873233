"""The port's optimizers (`adaface_tpu_torch/train/optimizers.py`) against
`adaface_tpu.train.optimizers` (optax), on the CPU in fp32.

Each optimizer by name through `make_optimizer` (the global-norm clip at
0.2 and `MultiSteps` accumulation) over 20 mini-steps of seeded gradients,
against `optax.MultiSteps(make_optimizer(...), k)` on the same parameters:
relative L2 <= 1e-6 per parameter. `cautious(adamw)` is the generic wrapper
around optax's `adamw`. Muon is held on a non-square Linear and a Conv2d,
each seen through `jax_layouts` as the JAX tree holds it ([in, out], HWIO);
adam8bit's int8 moments on a Linear over `min_8bit_size`, equal to JAX's
except for one-level ties, which are counted and bounded (at most 1e-3 of
the elements).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaface_tpu.train import optimizers as jopt
from adaface_tpu_torch.train import optimizers as topt
from tests.test_torch_models import one_torch_thread  # noqa: F401

REL_L2 = 1e-6
STEPS = 20
COMMON = dict(warmup_steps=3, total_steps=12, grad_clip=0.2)
LR = 1e-2


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def run(port_params, to_jax, from_jax, port_opt, jax_opt, grad_scale=1.0):
    """Both optimizers over STEPS mini-steps on the same start and gradients
    (the gradient of step i from RandomState(100 + i), drawn in the port's
    layout). → (port parameters, JAX parameters in the port's layout,
    mini-steps where the port moved, the JAX state)."""
    jp = [jnp.asarray(to_jax(i, p.detach().numpy())) for i, p in enumerate(port_params)]
    opt = port_opt(port_params)
    state = jax_opt.init(jp)
    update = jax.jit(jax_opt.update)
    moved = []
    for i in range(STEPS):
        rs = np.random.RandomState(100 + i)
        gs = [(rs.randn(*p.shape) * grad_scale).astype(np.float32) for p in port_params]
        for p, g in zip(port_params, gs):
            p.grad = torch.from_numpy(g)
        moved.append(opt.step())
        upd, state = update([jnp.asarray(to_jax(j, g)) for j, g in enumerate(gs)], state, jp)
        jp = optax.apply_updates(jp, upd)
    return ([p.detach().numpy() for p in port_params],
            [from_jax(i, np.asarray(p)) for i, p in enumerate(jp)], moved, state, opt)


def plain_params(seed=9):
    rs = np.random.RandomState(seed)
    return [torch.nn.Parameter(torch.from_numpy(rs.randn(*s).astype(np.float32)))
            for s in [(4, 3), (5,), (2, 2, 2), (3, 7)]]


def same(_, a):
    return a


def jax_reference(name, accum):
    if name == "cautious_adamw":
        sched = jopt.warmup_cosine(LR, COMMON["warmup_steps"], COMMON["total_steps"])
        ref = optax.chain(optax.clip_by_global_norm(COMMON["grad_clip"]),
                          jopt.cautious(optax.adamw(sched, weight_decay=0.005)))
    else:
        ref = jopt.make_optimizer(name, LR, **COMMON)
    return optax.MultiSteps(ref, accum) if accum > 1 else ref


def port_optimizer(name, accum, layouts=None):
    if name == "cautious_adamw":
        def make(ps):
            sched = topt.warmup_cosine(LR, COMMON["warmup_steps"], COMMON["total_steps"])
            core = topt.Cautious(topt.AdamW(ps, sched, weight_decay=0.005))
            return topt.MultiSteps(core, COMMON["grad_clip"], accum)
        return make
    return lambda ps: topt.make_optimizer(name, ps, LR, accum_steps=accum, layouts=layouts,
                                          **COMMON)


@pytest.mark.parametrize("name", ["adamw", "nadam", "muon", "adam8bit", "cautious_adamw"])
@pytest.mark.parametrize("accum,grad_scale", [(1, 1.0), (2, 0.01)])
def test_optimizer_matches_optax(name, accum, grad_scale):
    """Each optimizer behind the clip (acting at scale 1; the mean of two
    under it at 0.01) and the accumulation, 20 mini-steps."""
    params = plain_params()
    start = [p.detach().clone().numpy() for p in params]
    out, ref, moved, _, _ = run(params, same, same, port_optimizer(name, accum),
                                jax_reference(name, accum), grad_scale)
    for o, r, s in zip(out, ref, start):
        assert rel_l2(o, r) <= REL_L2, name
        assert np.abs(o - s).max() > 1e-4  # the parameters moved
    assert moved == [(i + 1) % accum == 0 for i in range(STEPS)]


def test_nadam_is_not_torch_nadam():
    """optax's `nadamw` has no momentum decay: torch's NAdam (ψ = 0.004) moves
    the parameters elsewhere, so the port does not use it."""
    params = plain_params()
    out, ref, _, _, _ = run(params, same, same, port_optimizer("nadam", 1),
                            jax_reference("nadam", 1))
    sched = topt.warmup_cosine(LR, COMMON["warmup_steps"], COMMON["total_steps"])
    tparams = plain_params()
    tn = torch.optim.NAdam(tparams, lr=LR, weight_decay=0.005, decoupled_weight_decay=True)
    for i in range(STEPS):
        rs = np.random.RandomState(100 + i)
        grads = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32)) for p in tparams]
        norm = float(topt.global_norm(grads))
        for p, g in zip(tparams, grads):
            p.grad = g if norm < 0.2 else g / norm * 0.2
        for group in tn.param_groups:
            group["lr"] = sched(i)
        tn.step()
    assert max(rel_l2(p.detach().numpy(), r) for p, r in zip(tparams, ref)) > 100 * REL_L2
    assert max(rel_l2(o, r) for o, r in zip(out, ref)) <= REL_L2


def layered_params(seed=3):
    """A non-square Linear (torch [3, 5], JAX [5, 3]) and a Conv2d (torch
    OIHW [4, 2, 3, 3], JAX HWIO [3, 3, 2, 4]), with their biases."""
    torch.manual_seed(seed)
    lin, conv = torch.nn.Linear(5, 3), torch.nn.Conv2d(2, 4, 3)
    params = [lin.weight, lin.bias, conv.weight, conv.bias]
    kinds = ["dense", None, "conv", None]
    return params, kinds, topt.jax_layouts(lin, conv)


def to_jax_by(kinds):
    def f(i, a):
        return {"dense": lambda x: x.T, "conv": lambda x: x.transpose(2, 3, 1, 0)}.get(
            kinds[i], lambda x: x)(a)
    return f


def from_jax_by(kinds):
    def f(i, a):
        return {"dense": lambda x: x.T, "conv": lambda x: x.transpose(3, 2, 0, 1)}.get(
            kinds[i], lambda x: x)(a)
    return f


def test_muon_sees_the_jax_layout():
    """Muon on a non-square Linear and a convolution: with `jax_layouts`
    equal to JAX's muon (the matrix view and its √max(1, rows/cols) scale of
    the [in, out] and HWIO leaves); without them (the torch layouts' views)
    not."""
    params, kinds, layouts = layered_params()
    out, ref, _, _, _ = run(params, to_jax_by(kinds), from_jax_by(kinds),
                            port_optimizer("muon", 2, layouts), jax_reference("muon", 2))
    for o, r in zip(out, ref):
        assert rel_l2(o, r) <= REL_L2
    params, kinds, _ = layered_params()
    out, ref, _, _, _ = run(params, to_jax_by(kinds), from_jax_by(kinds),
                            port_optimizer("muon", 2), jax_reference("muon", 2))
    assert rel_l2(out[0], ref[0]) > 1e-3 and rel_l2(out[2], ref[2]) > 1e-3


NS_REL_L2 = 1e-5  # five polynomial steps amplify the products' fp32 rounding


def test_newton_schulz_matches_jax():
    """The quintic iteration in fp32 on a tall and a wide matrix (its own
    output, O(1), at 1e-5: the optimizers' parameters above hold 1e-6), and
    its commuting with the transpose."""
    rs = np.random.RandomState(5)
    for shape in ((7, 3), (3, 7)):
        g = rs.randn(*shape).astype(np.float32)
        out = topt._newton_schulz(torch.from_numpy(g)).numpy()
        assert rel_l2(out, jopt._newton_schulz(jnp.asarray(g))) <= NS_REL_L2
        np.testing.assert_allclose(topt._newton_schulz(torch.from_numpy(g.T)).numpy(), out.T,
                                   atol=1e-6)


def test_adam8bit_int8_states_match_jax():
    """adam8bit on a [96, 64] Linear (6144 elements: int8 moments, 24 blocks
    of 256 over the JAX [in, out] order) and a small bias (fp32 moments): the
    parameters at 1e-6; the int8 moments equal, but for one-level ties
    (an fp32 moment on a rounding boundary), counted and at most 1e-3 of the
    elements; the scales at 1e-6."""
    torch.manual_seed(4)
    lin = torch.nn.Linear(96, 64)
    params, kinds = [lin.weight, lin.bias], ["dense", None]
    out, ref, _, state, opt = run(params, to_jax_by(kinds), from_jax_by(kinds),
                                  port_optimizer("adam8bit", 2, topt.jax_layouts(lin)),
                                  jax_reference("adam8bit", 2))
    for o, r in zip(out, ref):
        assert rel_l2(o, r) <= REL_L2
    jmoments = state.inner_opt_state[1].moments
    core = opt.optimizer
    (w_state,) = core.state[lin.weight]["leaves"]
    (b_state,) = core.state[lin.bias]["leaves"]
    ties = total = 0
    for key in ("qm", "qv"):
        got, want = w_state[key].numpy().astype(np.int32), np.asarray(jmoments[0][key], np.int32)
        assert got.shape == want.shape == (24, 256)
        diff = np.abs(got - want)
        assert diff.max() <= 1, key
        ties += int((diff == 1).sum())
        total += diff.size
    for key in ("sm", "sv"):
        assert rel_l2(w_state[key].numpy(), jmoments[0][key]) <= REL_L2
    for key in ("m", "v"):
        assert rel_l2(b_state[key].numpy(), jmoments[1][key]) <= REL_L2
    print(f"adam8bit one-level ties: {ties} of {total}")
    assert ties <= 1e-3 * total


def test_make_optimizer_names():
    """Every name JAX's `make_optimizer` takes builds; an unknown one raises
    as JAX's does."""
    for name in ("cadamw", "cautious_adamw", "adamw", "nadam", "adam8bit", "prodigy", "muon"):
        opt = topt.make_optimizer(name, [torch.nn.Parameter(torch.zeros(2))], 1e-3)
        assert isinstance(opt, topt.MultiSteps)
        jopt.make_optimizer(name, 1e-3)
    for make in (lambda: topt.make_optimizer("sgd", [torch.nn.Parameter(torch.zeros(2))], 1e-3),
                 lambda: jopt.make_optimizer("sgd", 1e-3)):
        with pytest.raises(ValueError, match="unknown optimizer 'sgd'"):
            make()
