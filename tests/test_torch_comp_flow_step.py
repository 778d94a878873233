"""One Stage-2 comp step with the GMA flow candidate, the port against the
JAX package on the CPU in fp32.

`comp_distill_loss_fn` through `make_train_step` at `use_face_flow=True`
(the GMA of `tests/test_torch_comp_flow.py` in `frozen["flow"]`, twelve
iterations a flow) on the tiny Stage-2 stack of
`tests/test_torch_comp_step.py` (no face towers: the fallback on the batch's
boxes; one denoising step: six flows), JAX's draws handed over: the loss and
every metric at 1e-5, the SubjBasisGenerator's and the attention adapters'
gradients at 1e-4 relative L2 (the step's draw leaves the comp FFN adapter
off: its gradients are 0 on both sides). Most of the time is JAX compiling
the step with its six inlined flows.
"""

import numpy as np

from adaface_tpu.models import vae as jvae
from adaface_tpu.train import comp_step as jcomp
from adaface_tpu_torch.train import comp_step as tcomp
from tests.test_torch_comp import (assert_step_matches, jax_grads_state_dicts, jax_step,
                                   one_torch_thread, port_step)  # noqa: F401
from tests.test_torch_comp_flow import gma_pair  # noqa: F401
from tests.test_torch_comp_step import COMP_KW, handed_rand, stacks  # noqa: F401
from tests.test_torch_models import VAE_KW

FLOW_COMP_KW = dict(COMP_KW, num_denoising_steps=1)


def test_comp_step_with_face_flow_matches_jax(stacks, gma_pair):  # noqa: F811
    (jfrozen, jtrain, jcfg, _), (tfrozen, tparams, tcfg, _), jb, tb = stacks
    jtree, model = gma_pair
    ccfg_j = jcomp.CompDistillConfig(vae_cfg=jvae.VAEConfig(**VAE_KW), use_face_flow=True,
                                     **FLOW_COMP_KW)
    hand_j, hand_t = handed_rand(jb, ccfg_j)
    frozen_j = {k: v for k, v in jfrozen.items() if k not in ("vae", "arcface")}
    frozen_j["flow"] = {"gma": jtree}
    jmetrics, g = jax_step(lambda *a: jcomp.comp_distill_loss_fn(*a, comp_cfg=ccfg_j),
                           frozen_j, jtrain, jcfg, dict(jb, **hand_j))
    jgrads = jax_grads_state_dicts(g, jfrozen, tparams)
    frozen_t = {k: v for k, v in tfrozen.items() if k not in ("vae", "arcface")}
    frozen_t["flow"] = model
    ccfg_t = tcomp.CompDistillConfig(use_face_flow=True, **FLOW_COMP_KW)
    metrics, grads = port_step(tcomp.make_comp_loss_fn(ccfg_t), frozen_t, tparams, tcfg,
                               dict(tb, **hand_t))
    # one step's draw leaves the comp FFN adapter off: zero on both sides
    for n, gr in grads["ffn_lora"].items():
        assert not gr.any() and not np.asarray(jgrads["ffn_lora"][n]).any(), n
    assert_step_matches(metrics, grads, jmetrics, jgrads, ("sbg", "attn_lora"))
