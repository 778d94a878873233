"""`scripts/bench_quality_torch.py` and `bench_torch.py`'s output knobs
against `scripts/bench_quality.py` and `bench.py`, on the CPU.

- `compare`'s ArcFace cosine against `bench_quality._arcface_cosine` on the
  same numpy batches at 512² (the centre crop's 256² → 128² downsample),
  JAX's `PRNGKey(0)` resnet_face18 carried across by `core/bridge.py`, to
  1e-4. `jax.image.resize(..., "linear")` antialiases that downsample: a
  plain bilinear interpolation moves the embeddings, and this test fails
  with it (`test_plain_bilinear_drifts` shows how far);
- the pixel MAE and correlation against `bench_quality.py`'s formulas, to
  1e-6;
- `bench_torch.py`'s knob parsing, its JSON line's keys with no knob set,
  the batch-1 latency skipped by `ADAFACE_BENCH_P50=0` and by the budget,
  and `ADAFACE_BENCH_SAVE_OUT`'s npz against the one `bench.py` writes
  (both run on stub pipelines that draw the same images from a seed).
"""

from __future__ import annotations

import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import arcface as jarc
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import arcface as tarc
from tests.test_torch_eval_cli import REPO, jax_script
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))
import bench_quality_torch as bq  # noqa: E402
import bench_torch  # noqa: E402

PR21_KEYS = ["metric", "value", "unit", "vs_baseline", "p50_latency_ms_bs1", "iter_sec_spread",
             "batch", "batches", "modes", "latency_sec_spread_bs1"]


def batches(seed: int, far: bool, b: int = 2, px: int = 512):
    """Two batches in [0, 1] with detail at every scale: smooth blobs plus
    pixel noise; `far` draws the second independently, else perturbs the
    first."""
    rs = np.random.RandomState(seed)

    def one():
        low = rs.rand(b, 3, px // 32, px // 32).repeat(32, 2).repeat(32, 3)
        return np.clip(0.6 * low + 0.4 * rs.rand(b, 3, px, px), 0, 1).astype(np.float32)

    a = one()
    other = one() if far else np.clip(a + 0.05 * rs.randn(*a.shape), 0, 1).astype(np.float32)
    return a, other


@pytest.fixture(scope="module")
def quality():
    mod = jax_script("bench_quality")
    arc = bridge.load(tarc.ArcFace(use_se=True), jarc.init_arcface_params(jax.random.PRNGKey(0)))
    return mod, arc


@pytest.mark.parametrize("far", [False, True])
def test_arcface_cosine_matches_jax(quality, far):
    mod, arc = quality
    a, b = batches(3, far)
    want = mod._arcface_cosine(a, b)
    got = bq.compare(a, b, arc)["arcface_cosine"]
    assert abs(got - want) <= 1e-4, (got, want)
    assert (want < 0.999) if far else (want > 0.9)


def test_plain_bilinear_drifts(quality, monkeypatch):
    """Without the antialias the embeddings move well past the tolerance."""
    mod, arc = quality
    a, b = batches(3, True)
    want = mod._arcface_cosine(a, b)
    real = torch.nn.functional.interpolate
    monkeypatch.setattr(bq.F, "interpolate",
                        lambda *args, **kw: real(*args, **{**kw, "antialias": False}))
    assert abs(bq.compare(a, b, arc)["arcface_cosine"] - want) > 1e-3


def test_pixel_metrics_match_bench_quality(quality):
    _, arc = quality
    a, b = batches(4, False, b=2, px=256)
    got = bq.compare(torch.from_numpy(a), torch.from_numpy(b).half(), arc)
    b = b.astype(np.float16).astype(np.float32)  # what the npz round trip keeps
    assert abs(got["pixel_mae"] - float(np.abs(a - b).mean())) <= 1e-6
    assert abs(got["pixel_corr"] - float(np.corrcoef(a.ravel(), b.ravel())[0, 1])) <= 1e-6
    with pytest.raises(ValueError, match="differ in shape"):
        bq.compare(a, b[:1], arc)


def test_random_arcface_is_seeded():
    one, two = bq.random_arcface("cpu", 0), bq.random_arcface("cpu", 0)
    for (k, v), w in zip(one.state_dict().items(), two.state_dict().values()):
        assert torch.equal(v, w), k
    x = torch.rand(1, 1, 128, 128) * 2 - 1
    assert torch.isfinite(one(x)).all()


def test_knobs_from_env():
    assert bench_torch.knobs_from_env({}) == {"save_out": None, "p50": True}
    assert bench_torch.knobs_from_env({"ADAFACE_BENCH_SAVE_OUT": "/x/out.npz",
                                       "ADAFACE_BENCH_P50": "0"}) == {
        "save_out": "/x/out.npz", "p50": False}
    assert bq.parse_env(bq.DEFAULT_TURBO_ENV) == {"ADAFACE_BENCH_INT8": "1",
                                                  "ADAFACE_BENCH_DEEPCACHE": "5"}


def stub_images(batch: int, seed: int) -> np.ndarray:
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (batch, 3, 8, 8)))


class PortStubPipeline:
    """`DiffusionPipeline`'s call on the CPU: the same images for the same
    seed as `JaxStubPipeline`."""

    def __init__(self):
        self.batches = []

    def __call__(self, prompts, negative_prompt, num_inference_steps, guidance_scale,
                 generator, deepcache_interval, tome_ratio):
        self.batches.append(len(prompts))
        return torch.from_numpy(stub_images(len(prompts), generator.initial_seed()).copy())


MODES = {"int8": False, "deepcache_interval": 0, "tome_ratio": 0.0}


@pytest.fixture
def card_calls_on_cpu(monkeypatch):
    """`bench_torch`'s calls that name the card, made on the CPU: its
    generators, the synchronize after each run and the cache release."""
    cpu_generator = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: cpu_generator("cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_bench_line_keys_without_knobs(card_calls_on_cpu):
    pipe = PortStubPipeline()
    line = bench_torch.run_bench(pipe, 2, MODES, bench_torch.knobs_from_env({}))
    assert list(line) == PR21_KEYS
    assert line["p50_latency_ms_bs1"] > 0 and line["latency_sec_spread_bs1"]["n"] == 2
    assert list(line["batches"]) == ["4", "8", "16", "32"] and line["modes"] == MODES
    assert pipe.batches == [4] * 3 + [8] * 3 + [16] * 3 + [32] * 3 + [1] * 3


# bench.py runs the latency only where ADAFACE_BENCH_P50 is "1"
@pytest.mark.parametrize("env", [{"ADAFACE_BENCH_P50": "0"}, {"ADAFACE_BENCH_P50": "false"}])
def test_bench_p50_skipped(env, card_calls_on_cpu):
    pipe = PortStubPipeline()
    line = bench_torch.run_bench(pipe, 1, MODES, bench_torch.knobs_from_env(env))
    assert list(line) == PR21_KEYS
    assert line["p50_latency_ms_bs1"] is None and line["latency_sec_spread_bs1"] is None
    assert 1 not in pipe.batches


class JaxStubPipeline:
    def __init__(self, modules, quantize_unet=False):
        pass

    def __call__(self, prompts, negative_prompt, num_inference_steps, guidance_scale, rng,
                 deepcache_interval, tome_ratio):
        return jax.random.uniform(rng, (len(prompts), 3, 8, 8))


class JaxStubModules:
    unet = vae = text_encoder = jnp.zeros((1,))

    @classmethod
    def random_init(cls, key):
        return cls()


def test_save_out_layout_equals_bench_py(tmp_path, monkeypatch, card_calls_on_cpu):
    from adaface_tpu.inference import pipeline as jpipe
    from adaface_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jpipe, "DiffusionPipeline", JaxStubPipeline)
    monkeypatch.setattr(jpipe, "PipelineModules", JaxStubModules)
    for k, v in {"ADAFACE_BENCH_ITERS": "2", "ADAFACE_BENCH_P50": "0",
                 "ADAFACE_BENCH_SAVE_OUT": str(tmp_path / "jax.npz")}.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    knobs = bench_torch.knobs_from_env({"ADAFACE_BENCH_P50": "0",
                                        "ADAFACE_BENCH_SAVE_OUT": str(tmp_path / "port.npz")})
    bench_torch.run_bench(PortStubPipeline(), 2, MODES, knobs)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert list(got.keys()) == list(want.keys()) == ["images"]
    assert got["images"].dtype == want["images"].dtype == np.float16
    assert got["images"].shape == want["images"].shape == (32, 3, 8, 8)
    np.testing.assert_array_equal(got["images"], want["images"])
