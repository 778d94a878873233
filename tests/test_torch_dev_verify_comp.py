"""`scripts/dev_verify_comp_torch.py` on the CPU: 4 optimizer steps of the
port's `Trainer` with a comp iteration every other step finish with a finite
loss and at least 2 comp iterations. The twin defines its tiny configs
itself (the JAX script imports them from `tests/`, which import JAX: the
card's machine has none): the JAX script's widths on the CPU, on the card
the smallest whose head dims the flash backward kernels take. It runs on
the card unless asked for the CPU."""

from __future__ import annotations

import dataclasses
import inspect
import math
import re
import sys

from tests.test_torch_eval_cli import REPO
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(REPO / "scripts"))
import dev_verify_comp_torch as twin  # noqa: E402


def test_dev_verify_comp_runs_on_cpu(capsys):
    out = twin.main("cpu")
    assert math.isfinite(out["metrics"]["loss"])
    assert out["comp_iters"] >= 2 and out["comp_iters"] + out["recon_iters"] == 4
    assert "OK: comp-distill trainer path ran" in capsys.readouterr().out


def test_configs_are_the_jax_scripts_own():
    text = (REPO / "scripts" / "dev_verify_comp_torch.py").read_text()
    assert not re.search(r"^\s*(?:import|from)\s+(tests|test_\w+)\b", text, re.MULTILINE)
    assert inspect.signature(twin.main).parameters["device"].default == "cuda"
    from tests.test_id2ada import SMALL_CLIP
    from tests.test_train import UNET_CFG

    for ours, theirs in ((twin.UNET_CFG, UNET_CFG), (twin.SMALL_CLIP, SMALL_CLIP)):
        fields = {f.name for f in dataclasses.fields(ours)} & {f.name for f in
                                                             dataclasses.fields(theirs)}
        assert len(fields) > 8
        for name in sorted(fields - {"fused_ln"}):
            assert getattr(ours, name) == getattr(theirs, name), name
    # the card's widths: every attention at a head dim the flash backward kernels take
    import torch

    clip, unet = twin.tiny_configs(torch.device("cuda"))
    dims = {clip.hidden_size // clip.num_heads} | {c // unet.num_heads
                                                  for c in unet.block_channels}
    assert dims <= {40, 48, 80, 160} and unet.cross_attn_dim == clip.hidden_size
    assert twin.tiny_configs(torch.device("cpu")) == (twin.SMALL_CLIP, twin.UNET_CFG)
