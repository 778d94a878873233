"""The port's `TrainerConfig` and its CLI against the JAX package's.

`TrainerConfig()`'s defaults field by field (the fields the port lacks by
design named in `adaface_tpu_torch/train/trainer.py`); the iteration plans
both trainers build from a YAML (the soak config, which pins the comp
priming count, and one without `unet_distill_iter_gap`) over 40 steps; the
previews of `sample_every` (the steps JAX's `_post_step` logs at, and the
grid of the same latents through the same tiny VAE decoder); the trainer
keys `train_torch.py` drops, each printed.
"""

import argparse
import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from adaface_tpu.models import vae as jvae
from adaface_tpu.train import recon_step as jrecon
from adaface_tpu.train import train_step as jstep
from adaface_tpu.train import trainer as jtrainer
from adaface_tpu.utils.monitor import RollingStats
from adaface_tpu.utils.sample_logger import SampleLogger as JSampleLogger
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.train import recon_step as trecon
from adaface_tpu_torch.train import train_step as tstep
from adaface_tpu_torch.train import trainer as ttrainer
from adaface_tpu_torch.utils import config as tconfig
from tests.test_torch_models import VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
# JAX's fields the port lacks by design (`train/trainer.py`'s docstring)
NOT_PORTED = {"use_wandb", "unet_lr_scale"}
# `ffn_adapter` is inert in JAX's recon (`recon_step.py:229`); the port's VAE
# module carries its config
RECON_NOT_PORTED = {"ffn_adapter", "vae_cfg"}
PLAN_STEPS = 40


def fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)}


def default(f):
    return f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default


def test_trainer_config_defaults_match_jax():
    """Every field of JAX's `TrainerConfig` but those named as not ported
    has the port's twin with the same default; the recon config's shared
    fields too; the port has no field JAX lacks."""
    jf, tf = fields(jtrainer.TrainerConfig), fields(ttrainer.TrainerConfig)
    assert set(tf) == set(jf) - NOT_PORTED
    for name in tf:
        if name == "recon_cfg":
            continue
        assert default(tf[name]) == default(jf[name]), name
    jr, tr = fields(jrecon.ReconStepConfig), fields(trecon.ReconStepConfig)
    assert set(tr) == set(jr) - RECON_NOT_PORTED
    for name in tr:
        assert default(tr[name]) == default(jr[name]), name
    assert isinstance(default(tf["recon_cfg"]), trecon.ReconStepConfig)


def stand_in_trainers(trainer_yaml: dict, tmp_path, **frozen_t):
    """A JAX and a port `Trainer` built from a YAML's `trainer:` section as
    `train.py` and `train_torch.py` build their configs, on stand-in
    towers: one trainable vector, no encoder."""
    import train_torch

    cfg = {"trainer": dict(trainer_yaml)}
    args = argparse.Namespace(data_roots=["unused"], log_dir=str(tmp_path / "t"))
    tcfg = train_torch.trainer_config(cfg, args)
    jf = fields(jtrainer.TrainerConfig)
    jcfg = jtrainer.TrainerConfig(data_roots=["unused"], log_dir=str(tmp_path / "j"),
                                  **{k: v for k, v in cfg["trainer"].items() if k in jf})
    jtr = jtrainer.Trainer(jcfg, jstep.TrainConfig(), {"unet": {}},
                           {"sbg": {"w": jnp.zeros(2)}}, None, None)
    ttr = ttrainer.Trainer(tcfg, tstep.TrainConfig(), {"unet": torch.nn.Linear(1, 1)},
                           {"sbg": torch.nn.Linear(2, 1)}, None, None, **frozen_t)
    return jtr, ttr


def load_yaml(name: str) -> dict:
    return yaml.safe_load((REPO / "configs" / name).read_text())


@pytest.mark.parametrize("source", ["soak", "no_gap"])
def test_planners_match_jax_from_yaml(source, tmp_path):
    """The soak config (`fixed_comp_priming_steps: 4`, gaps 4 and 5) and
    Stage 2's without its `unet_distill_iter_gap` (JAX's default: recon
    between the comp iterations) plan the same iterations, priming counts
    and flags in both trainers over 40 steps."""
    if source == "soak":
        section = load_yaml("soak-stage2-tpu.yaml")["trainer"]
    else:
        section = dict(load_yaml("stage2-comp-distill.yaml")["trainer"])
        del section["unet_distill_iter_gap"]
    jtr, ttr = stand_in_trainers(section, tmp_path)
    jplans = [jtr.planner.plan(s) for s in range(PLAN_STEPS)]
    tplans = [ttr.planner.plan(s) for s in range(PLAN_STEPS)]
    assert [dataclasses.asdict(p) for p in tplans] == [dataclasses.asdict(p) for p in jplans]
    kinds = {p.iter_type for p in tplans}
    comp_primes = {p.num_priming_steps for p in tplans if p.iter_type == "comp_distill"}
    if source == "soak":
        assert kinds == {"comp_distill", "recon", "unet_distill"} and comp_primes == {4}
    else:
        assert kinds == {"comp_distill", "recon"} and comp_primes == {3, 4}


def test_sample_every_writes_previews_as_jax(tmp_path):
    """`sample_every: 3` over 8 steps: the port's `fit` logs (through
    `_log_sample`, its worker decoding on its own thread) at the steps JAX's
    `_post_step` logs at, under the same names, and each grid equals the
    JAX logger's grid of the same latents through the same tiny VAE (one
    uint8 level for the rounding of the decoder's floats)."""
    vae_j = jvae.VAEConfig(**VAE_KW)
    vae_p = numpy_params(lambda k: jvae.init_vae_params(k, vae_j), 90)
    decoder = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                          bridge.vae_decoder_tree(vae_p))
    section = dict(load_yaml("stage1-distill-arc2face.yaml")["trainer"], sample_every=3,
                   ckpt_every=0, echo_every=0)
    jtr, ttr = stand_in_trainers(section, tmp_path, vae_decoder=decoder)
    rs = np.random.RandomState(91)
    batches = [{"x_start": rs.randn(2, 4, 8, 8).astype(np.float32)} for _ in range(8)]

    def fake_iterator(dataset, num_steps, start_step=0):
        for step in range(start_step, start_step + num_steps):
            yield step, ttr.planner.plan(step), {k: torch.from_numpy(v)
                                                  for k, v in batches[step].items()}

    ttr._batch_iterator = fake_iterator
    ttr._get_step = lambda flags: lambda state, batch, draws: (state, {"loss": torch.tensor(0.)})
    ttr.fit(None, num_steps=8)

    jdir = tmp_path / "jax_samples"
    stand_in = types.SimpleNamespace(
        cfg=jtr.cfg, _nan_streak=0, logger=types.SimpleNamespace(log_dict=lambda *a: None),
        face_stats=RollingStats(("face_detected",)), profiler=None,
        sample_logger=JSampleLogger(str(jdir)), vae_params=vae_p, _vae_cfg=vae_j,
        _sample_decode=jax.jit(lambda p, z: jvae.vae_decode(p, z, vae_j)))
    for step, batch in enumerate(batches):
        flags = jtr.planner.plan(step)
        jtrainer.Trainer._post_step(stand_in, step, flags, {"loss": 0.0},
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    stand_in.sample_logger.q.join()
    want = sorted(p.name for p in (jdir / "samples").iterdir())
    got = sorted(p.name for p in (tmp_path / "t" / "samples").iterdir())
    assert want == got == ["0000002_unet_distill.png", "0000005_unet_distill.png"]
    for name in want:
        a = np.asarray(Image.open(tmp_path / "t" / "samples" / name).convert("RGB"), np.int16)
        b = np.asarray(Image.open(jdir / "samples" / name).convert("RGB"), np.int16)
        assert a.shape == b.shape == (32 + 8, 2 * (32 + 8), 3)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3, name


def test_cli_prints_every_dropped_trainer_key(capsys):
    """A `trainer:` section with every JAX field and one no package has:
    each key the port drops is printed, the two JAX ignores as well on a
    line of their own, and no key the port takes (`overlap_recon_collect`
    among them: it is taken, set on or off)."""
    import train_torch

    jf = fields(jtrainer.TrainerConfig)
    section = {name: default(f) for name, f in jf.items()
               if name not in ("data_roots", "log_dir", "recon_cfg")}
    section["not_a_field"] = 1
    args = argparse.Namespace(data_roots=[], log_dir="unused")
    tcfg = train_torch.trainer_config({"trainer": section}, args)
    out = capsys.readouterr().out
    ignored = [line for line in out.splitlines() if "JAX ignores" in line]
    dropped = [line for line in out.splitlines() if "does not take" in line]
    assert len(ignored) == len(dropped) == 1
    assert all(k in ignored[0] for k in ("use_wandb", "unet_lr_scale"))
    assert "not_a_field" in dropped[0] and "overlap_recon_collect" not in dropped[0]
    for name in fields(ttrainer.TrainerConfig):
        assert f"'{name}'" not in out, name
    assert tcfg.overlap_recon_collect is False
    on = train_torch.trainer_config({"trainer": dict(section, overlap_recon_collect=True)}, args)
    assert on.overlap_recon_collect is True and "overlap" not in capsys.readouterr().out
    assert tcfg.fixed_comp_priming_steps is None and tcfg.sample_every == 0
    # the YAML reader the CLI uses gives the soak config's keys their types
    soak = tconfig.load(str(REPO / "configs" / "soak-stage2-tpu.yaml"))["trainer"]
    assert soak["fixed_comp_priming_steps"] == 4 and soak["sample_every"] == 25
