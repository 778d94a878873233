"""`Trainer.fit` with `overlap_recon_collect=True` in the port against the
JAX trainer's on the CPU (JAX's `backend_supports_callbacks` patched to
False, as `tests/test_trainer.py:373` forces its two-phase recon step): a
recon run broken by unet-distill iterations, on one set of tiny weights
(`tests/test_torch_trainer_recon.recon_pair`, the SubjBasisGenerator
trained), the port fed the JAX trainer's batches with its draws handed over.
Every step's row reaches `metrics.csv`, the losses agree at 1e-4 relative,
and each recon stream ran through the pipelined runner. The option is
refused by name under data parallelism.
"""

import argparse
import csv
import dataclasses
import pathlib

import jax
import numpy as np
import pytest

from adaface_tpu.data.personalized import PersonalizedBase as JDataset
from adaface_tpu.ops import schedules as jsched
from adaface_tpu.train import trainer as jtrainer
from adaface_tpu.train.recon_step import sample_recon_rand as JSampleRand
from adaface_tpu_torch.train import trainer as ttrainer
from tests.test_torch_train import make_png_dataset
from tests.test_torch_trainer import IMAGE_SIZE, _t
from tests.test_torch_trainer_recon import recon_pair
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

STEPS = 5
# the planner's types at unet_distill_iter_gap 3: two recon streams, each of two
TYPES = ["recon", "recon", "unet_distill", "recon", "recon"]


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    return make_png_dataset(tmp_path_factory.mktemp("pngs"), size=IMAGE_SIZE)


def handed_batches(seen, jtr):
    """The JAX trainer's batches as the port's, with the draws each JAX
    recon step took from its key (`recon_rand`)."""
    sched = jsched.DiffusionSchedule.create()
    for step, f, _, b in seen:
        tb = {k: (_t(v).long() if np.asarray(v).dtype.kind in "iu" else _t(v))
              for k, v in b.items()}
        if f.iter_type == "recon":
            rcfg = dataclasses.replace(jtr.cfg.recon_cfg, on_pure_noise=f.normal_recon_on_pure_noise,
                                       do_adv_attack=f.do_adv_attack)
            _, k_rand = jax.random.split(jax.random.PRNGKey(f.seed))
            jr = JSampleRand(k_rand, b["x_start"], sched, rcfg)
            tr = {k: _t(jr[k]) for k in ("noises", "rel_ts", "x_start0")}
            tr["t0"] = _t(jr["t0"]).long()
            tr["adv_uniform"] = float(jr["adv_uniform"])
            tr["adv_dropout_u"] = _t(jax.random.uniform(jr["adv_dropout_key"], (2, 512)))
            tb["recon_rand"] = tr
        yield step, f, tb


def test_overlap_fit_matches_jax(png_root, tmp_path, monkeypatch):
    """Five micro-steps (recon, recon, unet-distill, recon, recon) with the
    overlap on both sides: the port's losses against the JAX trainer's, a
    `metrics.csv` row for every step in order, two pipelined streams (the
    unet-distill step flushes the first, the end of `fit` the second), and
    the SubjBasisGenerator moved."""
    monkeypatch.setattr(jtrainer, "backend_supports_callbacks", lambda: False)
    jtr, ttr, _ = recon_pair(tmp_path, unfreeze_unet=False, accum_steps=1,
                             unet_distill_iter_gap=3, p_normal_recon_on_pure_noise=0.0,
                             overlap_recon_collect=True, max_steps=STEPS)
    for tr in (jtr, ttr):  # one denoising step: a decode a step, shorter JAX compiles
        tr.cfg.recon_cfg = dataclasses.replace(tr.cfg.recon_cfg, num_denoising_steps=1)
    seen = []
    real = jtr._post_step
    jtr._post_step = lambda step, f, m, b: seen.append((step, f, m, b)) or real(step, f, m, b)
    jtr.fit(JDataset(png_root, size=IMAGE_SIZE, seed=0, use_native=False), num_steps=STEPS)
    assert [f.iter_type for _, f, _, _ in seen] == TYPES
    assert [s for s, *_ in seen] == list(range(STEPS))

    runners = []
    real_runner = ttrainer.make_pipelined_recon_runner
    monkeypatch.setattr(ttrainer, "make_pipelined_recon_runner",
                        lambda fn: runners.append(real_runner(fn)) or runners[-1])
    ttr._batch_iterator = lambda *a, **kw: handed_batches(seen, jtr)
    losses, steps = [], []
    real_t = ttr._post_step

    def post(step, f, m):
        steps.append(step)
        losses.append(float(m["loss"]))
        return real_t(step, f, m)

    ttr._post_step = post
    sbg = next(ttr.state.params["sbg"].parameters())
    before = sbg.detach().clone()
    metrics = ttr.fit(None, num_steps=STEPS)
    assert steps == list(range(STEPS))
    np.testing.assert_allclose(losses, [float(m["loss"]) for _, _, m, _ in seen], rtol=1e-4)
    assert float(metrics["loss"]) == losses[-1]
    assert len(runners) == 2
    assert all(hasattr(fn, "collect") for key, fn in ttr._steps.items() if key[0] == "recon")
    assert not np.array_equal(before.numpy(), sbg.detach().numpy())
    with open(pathlib.Path(ttr.cfg.log_dir) / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == list(range(STEPS))
    assert [int(float(r["iter_type_id"])) for r in rows] == [
        ttrainer.ITER_TYPE_ID[t] for t in TYPES]


def test_overlap_refused_under_data_parallelism():
    """`overlap_recon_collect` with dp > 1 raises, naming the option, from
    the config and from the CLI's reading of a YAML; at dp 1 it is taken."""
    import train_torch

    with pytest.raises(ValueError, match="overlap_recon_collect"):
        ttrainer.TrainerConfig(overlap_recon_collect=True, dp=2)
    args = argparse.Namespace(data_roots=[], log_dir="unused")
    with pytest.raises(ValueError, match="overlap_recon_collect"):
        train_torch.trainer_config({"trainer": {"overlap_recon_collect": True, "dp": 2}}, args)
    cfg = train_torch.trainer_config({"trainer": {"overlap_recon_collect": True, "dp": 1}}, args)
    assert cfg.overlap_recon_collect and not ttrainer.TrainerConfig().overlap_recon_collect
