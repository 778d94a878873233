"""Throughput and latency of personalized 512x512 generation on one GPU,
through the PyTorch port's pipeline.

    python3 bench_torch.py

The counterpart of `bench.py` for `adaface_tpu_torch`: the full pipeline
(prompt encode → 25-step CFG DDIM UNet loop → VAE decode, guidance 6.0) with
random SD1.5-sized bf16 weights built on the card (weights do not change the
speed), at batches 4, 8, 16 and 32 in turn: one warm-up run discarded, then
the median of N runs (`ADAFACE_BENCH_ITERS`, default 5) with their least and
largest, every run ended by `torch.cuda.synchronize()`. Then the p50 latency
of a single request (batch 1) the same way. Prints ONE JSON line with
`bench.py`'s keys (`value` is the best batch's images per second), all four
batches, and the card's name and power limit.

`vs_baseline` compares with the repository's north star of 2,000
generations an hour and chip (0.5556 imgs/sec): a target, not a measurement.

The speed modes, as `bench.py` reads them (all off by default, so the
headline is the full-precision, full-computation loop; the JSON line names
them under `modes`): `ADAFACE_BENCH_INT8=1` serves int8 PTQ UNets,
`ADAFACE_BENCH_DEEPCACHE=N` (N > 1) runs the full UNet every Nth step,
`ADAFACE_BENCH_TOME=R` (0 < R < 1) merges that fraction of the 64² level's
tokens.
"""

from __future__ import annotations

import json
import os
import statistics
import time

import torch

from adaface_tpu_torch.core.device import require_card
from adaface_tpu_torch.inference.pipeline import DiffusionPipeline, PipelineModules

BASELINE_IMGS_PER_SEC = 2000.0 / 3600.0
BATCHES = (4, 8, 16, 32)
STEPS = 25
PROMPT = "portrait photo of z person at the beach, high quality"
NEGATIVE_PROMPT = "lowres, low quality"


def modes_from_env() -> dict:
    """The speed modes `bench.py` reads from the environment."""
    return {"int8": os.environ.get("ADAFACE_BENCH_INT8", "0") == "1",
            "deepcache_interval": int(os.environ.get("ADAFACE_BENCH_DEEPCACHE", "0")),
            "tome_ratio": float(os.environ.get("ADAFACE_BENCH_TOME", "0"))}


def timed_runs(pipe: DiffusionPipeline, batch: int, n_iters: int, deepcache_interval: int = 0,
               tome_ratio: float = 0.0) -> list[float]:
    """Seconds of `n_iters` runs at `batch`, after one discarded warm-up run."""
    def run(seed: int) -> float:
        t0 = time.perf_counter()
        pipe([PROMPT] * batch, negative_prompt=NEGATIVE_PROMPT, num_inference_steps=STEPS,
             guidance_scale=6.0, generator=torch.Generator("cuda").manual_seed(seed),
             deepcache_interval=deepcache_interval, tome_ratio=tome_ratio)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(0)
    return [run(i) for i in range(1, n_iters + 1)]


def spread(times: list[float]) -> dict:
    return {"median": round(statistics.median(times), 3), "min": round(min(times), 3),
            "max": round(max(times), 3), "n": len(times)}


def main() -> None:
    card = require_card()
    n_iters = int(os.environ.get("ADAFACE_BENCH_ITERS", "5"))
    modes = modes_from_env()
    gen = torch.Generator(device="cuda").manual_seed(0)
    pipe = DiffusionPipeline(PipelineModules.random_init(gen, "cuda", torch.bfloat16),
                             quantize_unet=modes["int8"])
    loop = {k: modes[k] for k in ("deepcache_interval", "tome_ratio")}

    batches = {}
    for batch in BATCHES:
        times = timed_runs(pipe, batch, n_iters, **loop)
        batches[batch] = {"imgs_per_sec": round(batch / statistics.median(times), 4),
                          "iter_sec_spread": spread(times)}
        torch.cuda.empty_cache()
    best = max(batches, key=lambda b: batches[b]["imgs_per_sec"])
    latencies = timed_runs(pipe, 1, n_iters, **loop)

    print(json.dumps({
        "metric": "personalized_gen_512_25step_throughput",
        "value": batches[best]["imgs_per_sec"],
        "unit": "imgs/sec/chip",
        "vs_baseline": round(batches[best]["imgs_per_sec"] / BASELINE_IMGS_PER_SEC, 3),
        "p50_latency_ms_bs1": round(statistics.median(latencies) * 1000.0, 1),
        "iter_sec_spread": batches[best]["iter_sec_spread"],
        "batch": best,
        "batches": {str(b): r for b, r in batches.items()},
        "modes": modes,
        "latency_sec_spread_bs1": spread(latencies),
        "card": card,
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
