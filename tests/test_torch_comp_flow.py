"""The GMA flow candidate of the Stage-2 elastic matching, the port against
the JAX package on the CPU in fp32.

`calc_elastic_matching_loss` with a flow function: a zero flow, a constant
sub-pixel shift (the same function on both sides) and the latent GMA flow
(`make_latent_flow_fn` over the synthetic checkpoint of
`tests/test_torch_gma.py`, converted by each package): every loss at 1e-5,
and the gradients of the min losses and the sparse-attention losses with
respect to q, attn_out and outfeat at 1e-4 relative L2 (the flows carry no
gradient, as JAX's `stop_gradient`). The comp step with the flow is in
`tests/test_torch_comp_flow_step.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import gma as jgma
from adaface_tpu.train import comp_losses as jcl
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import gma as tgma
from adaface_tpu_torch.train import comp_losses as tcl
from tests.test_torch_comp import (GRAD_REL_L2, SC_BOXES, SS_BOXES, _t, assert_rel,
                                   fake_capture, one_torch_thread, rel_l2)  # noqa: F401
from tests.test_torch_gma import torch_gma_state_dict


@pytest.fixture(scope="module")
def gma_pair():
    sd = torch_gma_state_dict(7)
    jtree = jax.tree_util.tree_map(
        jnp.asarray, jgma.convert_gma_state_dict({k: v.numpy() for k, v in sd.items()}))
    return jtree, bridge.load(tgma.GMA(), tgma.convert_gma_state_dict(sd))


def shift_flow(mod):
    """A constant (1.5, −0.75) flow on either side."""
    def fn(q, s, h, w, thres=0.0):
        base = mod.zeros((q.shape[0], 2, h, w))
        return base + mod.asarray([1.5, -0.75]).reshape(1, 2, 1, 1) if mod is jnp else \
            base + torch.tensor([1.5, -0.75]).reshape(1, 2, 1, 1)
    return fn


def flow_fns(kind, gma_pair):
    if kind == "zero":
        return (lambda q, s, h, w, t=0.0: jnp.zeros((q.shape[0], 2, h, w)),
                lambda q, s, h, w, t=0.0: torch.zeros((q.shape[0], 2, h, w)))
    if kind == "shift":
        return shift_flow(jnp), shift_flow(torch)
    jtree, model = gma_pair
    return jgma.make_latent_flow_fn(jtree), tgma.make_latent_flow_fn(model)


def total_loss(losses):
    """The min losses and both sparse-attention losses: every candidate and
    the flow's pick reach it."""
    return (losses["sc_recon_ssfg_min"] + 2 * losses["sc_recon_mc_min"]
            + losses["sc_to_mc_sparse_attns_distill"] + losses["sc_to_ssfg_sparse_attns_distill"])


@pytest.mark.parametrize("kind", ["zero", "shift", "gma"])
def test_elastic_matching_flow_candidate_matches_jax(kind, gma_pair):
    """Every loss, and the gradients of `total_loss` with respect to q,
    attn_out and outfeat (one JAX compile a case: the losses ride as the
    gradient's aux)."""
    cap = fake_capture()
    arrays = [cap["q2"][22], cap["attn_out"][22], cap["outfeat"][22].reshape(8, 16, 64)]
    jfn, tfn = flow_fns(kind, gma_pair)
    kw = dict(h=8, w=8, small_motion_ignore_thres=0.3)

    def jax_losses(q_, a_, o_):
        losses = jcl.calc_elastic_matching_loss(
            q_, a_, o_, ss_face_bboxes=jnp.asarray(SS_BOXES),
            sc_face_bboxes=jnp.asarray(SC_BOXES), flow_fn=jfn, **kw)
        return total_loss(losses), losses

    (_, lj), gj = jax.jit(jax.value_and_grad(jax_losses, argnums=(0, 1, 2), has_aux=True))(
        *[jnp.asarray(a) for a in arrays])
    ts = [_t(a).requires_grad_() for a in arrays]
    lt = tcl.calc_elastic_matching_loss(*ts, ss_face_bboxes=_t(SS_BOXES),
                                        sc_face_bboxes=_t(SC_BOXES), flow_fn=tfn, **kw)
    total_loss(lt).backward()
    assert set(lt) == set(lj)
    for k, v in lj.items():
        assert_rel(float(lt[k].detach()), float(v), what=k)
    if kind != "zero":  # the flow candidate differs from the same location
        assert float(lj["sc_recon_mc_flow"]) != float(lj["sc_recon_mc_sameloc"])
    for t, r in zip(ts, gj):
        assert np.abs(r).max() > 0 and rel_l2(t.grad.numpy(), r) <= GRAD_REL_L2
