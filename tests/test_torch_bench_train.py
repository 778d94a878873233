"""`scripts/bench_train_torch.py`, the twin of `scripts/bench_train.py`, on
the CPU at tiny widths.

The JAX script is read, not run: its `_build` is full width. Its lines'
keys come from the dict literals of its four ported metrics (`ast`), its
`_timed_clean` is compiled from its source under a scripted clock, and its
prompt lists are run through the JAX package's prompt-batch builders. The
twin runs modes `all` and `legacy` once for the module (a 2-level UNet 32
channels wide, a 2-layer CLIP, a 3-level VAE decoder, 8² latents, ITERS 5,
`SmoothTower` in place of ArcFace, the comp step at 1 priming and 2
denoising steps) with `make_train_step` wrapped to count its steps and
keep their metrics. The steps' losses are held to JAX elsewhere
(`tests/test_torch_recon_step.py`, `test_torch_comp_step.py`,
`test_torch_train.py`).
"""

import ast
import collections
import contextlib
import hashlib
import importlib.util
import io
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from adaface_tpu.text import embedding_manager as jem
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu.train import prompt_batch as jpb
from adaface_tpu_torch.models.clip import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig
from adaface_tpu_torch.models.vae import VAEConfig
from adaface_tpu_torch.text import embedding_manager as tem
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.train import recon_step as trecon
from tests.test_torch_models import TEXT_KW, VAE_KW
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_recon import RECON_UNET_KW, SmoothTower

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / "scripts" / "bench_train.py"
TWIN = REPO / "scripts" / "bench_train_torch.py"
# the JAX script's five metrics that the twin prints
PORTED = ("recon_train_step_throughput", "recon_train_step_throughput_pipelined",
          "unet_distill_step_throughput", "comp_distill_step_throughput",
          "recon_train_step_throughput_legacy_single_step")
# what the twin's lines add to the JAX keys: the time between CUDA events of
# each timed step, the card's name and power limit, the detector's backend
ADDED = {"device_ms", "card", "detector"}
ITERS = 5
BATCH = 1
# the tiny run's chained and split steps (the twin's own counts, 8 and 3,
# are checked against the JAX script's chained k in `test_chained_k`)
CHAINED_K, SPLIT_STEPS = 2, 2


def load_twin():
    """The twin as a fresh module (its dataclasses need it in `sys.modules`)."""
    spec = importlib.util.spec_from_file_location("bench_train_torch", TWIN)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def jax_tree():
    return ast.parse(JAX_SCRIPT.read_text())


def jax_line_keys() -> dict:
    """{metric: the keys of the dict literal the JAX script prints for it}."""
    out = {}
    for node in ast.walk(jax_tree()):
        if not isinstance(node, ast.Dict):
            continue
        keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
        if "metric" in keys:
            metric = node.values[keys.index("metric")]
            if isinstance(metric, ast.Constant) and metric.value in PORTED:
                out[metric.value] = set(keys)
    return out


def jax_function(name: str, namespace: dict):
    """A top-level function of the JAX script compiled alone in `namespace`."""
    fn = next(n for n in jax_tree().body if isinstance(n, ast.FunctionDef) and n.name == name)
    code = compile(ast.Module(body=[fn], type_ignores=[]), str(JAX_SCRIPT), "exec")
    exec(code, namespace)
    return namespace[name]


def tiny_workload(bt):
    return bt.Workload(device="cpu", card="cpu (tests)", unet=UNetConfig(**RECON_UNET_KW),
                       clip=CLIPTextConfig(**TEXT_KW), vae=VAEConfig(**VAE_KW), latent_hw=8,
                       dtype=torch.float32, arcface=lambda gen: SmoothTower())


def docs_digest() -> str:
    h = hashlib.sha256()
    for f in sorted((REPO / "docs").rglob("*")):
        if f.is_file():
            h.update(f.relative_to(REPO).as_posix().encode())
            h.update(f.read_bytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Modes `all` and `legacy` of the twin, tiny, with `make_train_step`
    wrapped: (lines by metric, steps run by loss function, the metrics'
    keys of each step by loss function, the detectors handed to the recon
    loss, the `BENCH_TRAIN_OUT` record, docs/ before and after)."""
    bt = load_twin()
    calls = collections.Counter()
    keys = collections.defaultdict(list)
    detectors, runners = [], []
    real_step, real_recon = bt.make_train_step, trecon.make_recon_loss_fn
    real_runner = trecon.make_pipelined_recon_runner

    class CountingRunner(trecon.PipelinedReconRunner):
        def __init__(self, two):
            super().__init__(two)
            self.pushes = self.steps = 0
            runners.append(self)

        def push(self, *a):
            self.pushes += 1
            out = super().push(*a)
            self.steps += out is not None
            return out

    def counting_step(loss_fn, frozen, schedule, cfg, mesh=None):
        inner = real_step(loss_fn, frozen, schedule, cfg, mesh=mesh)
        name = loss_fn.__qualname__.split(".")[0]

        def step(state, batch, draws=None):
            calls[name] += 1
            state, metrics = inner(state, batch, draws)
            keys[name].append(set(metrics))
            return state, metrics

        return step

    def recording_recon(rcfg, detector):
        detectors.append(detector)
        return real_recon(rcfg, detector)

    out = tmp_path_factory.mktemp("bench") / "BENCH_train.json"
    before = docs_digest()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    buf = io.StringIO()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bt, "make_train_step", counting_step)
            mp.setattr(trecon, "make_recon_loss_fn", recording_recon)
            mp.setattr(trecon, "make_pipelined_recon_runner", CountingRunner)
            mp.setattr(bt, "ITERS", ITERS)
            mp.setattr(bt, "BATCH", BATCH)
            mp.setattr(bt, "CHAINED_K", CHAINED_K)
            mp.setattr(bt, "SPLIT_STEPS", SPLIT_STEPS)
            mp.setattr(bt, "COMP_BATCH", 1)
            mp.setenv("BENCH_TRAIN_COMP_STEPS", "1,2")
            mp.setenv("BENCH_TRAIN_OUT", str(out))
            mp.delenv("BENCH_TRAIN_NO_IDENTITY", raising=False)
            with contextlib.redirect_stdout(buf):
                bt.main(["all"], workload=tiny_workload(bt))
                bt.main(["legacy"], workload=tiny_workload(bt))
    finally:
        torch.set_num_threads(threads)
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]
    assert real_runner is trecon.make_pipelined_recon_runner
    return dict(bt=bt, lines={ln["metric"]: ln for ln in lines}, n_lines=len(lines),
                calls=calls, keys=keys, detectors=detectors, runners=runners,
                record=json.loads(out.read_text()), docs=(before, docs_digest()))


def finite_numbers(x) -> bool:
    if isinstance(x, dict):
        return all(finite_numbers(v) for v in x.values())
    if isinstance(x, list):
        return all(finite_numbers(v) for v in x)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return math.isfinite(x)
    return True


@pytest.mark.parametrize("metric", PORTED)
def test_line_has_the_jax_keys(run, metric):
    """Each metric's line has every key of the JAX script's line for it,
    and only the added ones besides, its numbers finite."""
    jax_keys = jax_line_keys()
    assert set(jax_keys) == set(PORTED)
    line = run["lines"][metric]
    assert set(line) == jax_keys[metric] | ADDED
    assert finite_numbers(line) and line["value"] > 0
    assert line["card"] == "cpu (tests)" and line["device_ms"] is None  # no card, no device time
    assert run["n_lines"] == len(PORTED)


def test_recon_split_adds_up(run):
    """train + collect + detect is the timed steps' median (the JAX total)."""
    line = run["lines"]["recon_train_step_throughput"]
    total = line["train_sec"] + line["collect_sec"] + line["detect_sec"]
    med = line["train_spread"]["median"]  # each of the four rounded to 1e-3 (detect 1e-4)
    assert abs(total - med) <= 2e-3
    assert abs(line["value"] - 1.0 / med) <= 0.6e-3 / med ** 2 + 1e-4
    assert line["collect_sec"] > 0 and line["train_sec"] > 0 and line["detect_sec"] >= 0


@pytest.mark.parametrize("kind", ["4-block", "comp"])
@pytest.mark.parametrize("bs", [1, 4])
def test_prompt_batches_equal_jax(kind, bs):
    """The twin's prompt batches against the JAX builders on the JAX
    script's prompts and the same tokenizer, integer for integer."""
    bt = load_twin()
    jm = jem.EmbeddingManager(JTokenizer.character_fallback(), [jem.PlaceholderSpec("z", 16)])
    tm = tem.EmbeddingManager(CLIPTokenizer.character_fallback(), [tem.PlaceholderSpec("z", 16)])
    ph = jm.expand_placeholder(jm.placeholders[0])
    ss, sc = [f"a photo of {ph}"] * bs, [f"a photo of {ph} riding a bike"] * bs
    cs, cc = ["a photo of person"] * bs, ["a photo of person riding a bike"] * bs
    if kind == "4-block":
        ref, got = jpb.build_4block_prompt_batch(jm, ss, sc, cs, cc), bt.prompt_batch(tm, bs)
        names = ("prompt_ids", "splice_map", "prompt_emb_mask", "uncond_ids")
    else:
        rep = jpb.make_comp_rep_prompts(sc, ["cinematic"] * bs, ["riding a bike"] * bs)
        ref = jpb.build_comp_prompt_batch(jm, ss, sc, rep, cs, cc)
        got = bt.comp_prompt_batch(tm, bs)
        names = ("prompt_ids", "splice_map", "prompt_emb_mask", "uncond_ids", "prompt_pad_mask")
    assert set(got) == set(ref)
    for name in names:
        a, b = np.asarray(got[name]), np.asarray(ref[name])
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, name
        np.testing.assert_array_equal(a, b, err_msg=name)


class ScriptedClock:
    """`time` with a `perf_counter` that the steps advance: step i takes
    durations[i] seconds."""

    def __init__(self, durations):
        self.now = 0.0
        self.durations = list(durations)
        self.ran = []

    def perf_counter(self):
        return self.now

    def step(self, i):
        self.ran.append(i)
        self.now += self.durations[i]


@pytest.mark.parametrize("durations", [
    [1.0, 1.1, 0.9, 1.2, 1.0],  # clean
    [2.0, 11.0, 1.0, 6.0, 1.5, 1.2, 9.0, 1.1],  # stalls, each past 5x the min so far
    [1.0, 6.0, 7.0, 8.0, 0.2, 1.0, 1.1, 1.2],  # resampling stops at n + 3
])
def test_timed_clean_equals_jax(durations, monkeypatch):
    bt = load_twin()
    jclock, tclock = ScriptedClock(durations), ScriptedClock(durations)
    jax_timed_clean = jax_function("_timed_clean", {"time": jclock, "ITERS": ITERS})
    monkeypatch.setattr(bt, "time", tclock)
    monkeypatch.setattr(bt, "ITERS", ITERS)
    assert bt._timed_clean(tclock.step) == jax_timed_clean(jclock.step)
    assert tclock.ran == jclock.ran


def test_timed_step_is_make_train_step(run):
    """Every step each phase runs is `make_train_step`'s: the warm-up, the
    timed ones (rewarms too), the chained ones and the recon split's."""
    lines, calls = run["lines"], run["calls"]

    def timed(metric):
        line = lines[metric]
        return line["train_spread"]["n"] + len(line["rewarms_excluded"])

    assert calls == {
        "make_recon_loss_fn": 1 + timed("recon_train_step_throughput") + CHAINED_K + SPLIT_STEPS,
        "unet_distill_loss_fn": 1 + timed("unet_distill_step_throughput") + CHAINED_K,
        "make_comp_loss_fn": 1 + timed("comp_distill_step_throughput"),
        "recon_loss_fn": 1 + ITERS}
    assert lines["recon_train_step_throughput"]["chained_k"] == CHAINED_K


def test_pipelined_pushes_through_the_runner(run):
    """The pipelined rate comes from one `make_pipelined_recon_runner`
    stream: two pushes to fill it and one to warm it, then a push a timed
    cycle (stalls resampled), each returning a trained step but the first;
    its detector is the recon phase's backend."""
    (runner,) = run["runners"]
    line = run["lines"]["recon_train_step_throughput_pipelined"]
    assert line["cycle_spread"]["n"] == ITERS
    assert runner.pushes >= 3 + ITERS and runner.steps == runner.pushes - 1
    assert runner._pending is None  # closed: the last collect left untrained
    assert line["detector"] == run["lines"]["recon_train_step_throughput"]["detector"]


def test_chained_k():
    """The twin chains as many steps as the JAX script's `_chained_rate`
    (its default k) and splits recon over a few more."""
    fn = next(n for n in jax_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == "_chained_rate")
    bt = load_twin()
    assert bt.CHAINED_K == ast.literal_eval(fn.args.defaults[-1]) == 8
    assert bt.SPLIT_STEPS == 3


def test_recon_keeps_the_identity_family(run):
    """The recon step runs with a host detector (never None), so its decode
    and ArcFace losses run: every step's metrics have them."""
    assert len(run["detectors"]) == 1 and run["detectors"][0] is not None
    recon = run["keys"]["make_recon_loss_fn"]
    assert recon and all({"loss_arcface_align_recon", "loss_bg_faces_suppress"} <= k
                         for k in recon)
    assert run["lines"]["recon_train_step_throughput"]["detector"] == \
        run["detectors"][0].backend
    comp = run["keys"]["make_comp_loss_fn"]
    assert comp and all("loss_arcface_align_comp" in k for k in comp)


def test_writes_only_where_asked(run):
    """No mode writes under docs/; BENCH_TRAIN_OUT gets the recon line's
    keys at the top and every other metric under its name."""
    before, after = run["docs"]
    assert before == after
    rec = run["record"]
    recon = run["lines"]["recon_train_step_throughput"]
    assert {k: rec[k] for k in recon} == recon
    for m in PORTED[1:]:
        assert rec[m] == run["lines"][m]


@pytest.mark.parametrize("mode", ["pipelined", "all"])
def test_exits_non_zero(mode):
    """Without a card every mode, `pipelined` among them, exits before
    building (no fallback to the CPU)."""
    before = docs_digest()
    r = subprocess.run([sys.executable, str(TWIN), mode], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not any(s.startswith("{") for s in r.stdout.splitlines())
    assert docs_digest() == before
