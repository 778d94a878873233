"""Latency and throughput of the PyTorch port's serving path under
concurrent multi-subject load, on one GPU.

The counterpart of `scripts/bench_serving.py` for `adaface_tpu_torch`: drives
`inference/serving.py`'s ContinuousBatcher with M personalized requests
(distinct prompts and per-request ada embeddings of six subjects, sharing one
device batch) queued up front, at 512x512 with random SD1.5-sized bf16
weights built on the card, and records
  - steady imgs/sec over the drain,
  - per-request completion latency p50/p99 (queue wait included: the
    "loaded server" number),
  - the gap between completions p50/p99.
A request counts as complete when the device has finished its image (a
CUDA event recorded behind it; the drain itself never synchronises). Prints ONE JSON
line with the card's name and power limit.

  python3 scripts/bench_serving_torch.py                  # 16 slots, 48 reqs
  BENCH_SERVE_SLOTS=8 BENCH_SERVE_REQS=24 python3 scripts/bench_serving_torch.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from adaface_tpu_torch.core.device import require_card  # noqa: E402
from adaface_tpu_torch.inference.pipeline import PipelineModules  # noqa: E402
from adaface_tpu_torch.inference.serving import ContinuousBatcher, Request  # noqa: E402
from adaface_tpu_torch.models.clip import CLIP_L_TEXT  # noqa: E402

PROMPTS = [
    "a photo of {} at the beach",
    "a portrait of {} in a library, cinematic lighting",
    "{} riding a bike in paris",
    "a watercolor painting of {}",
    "{} as an astronaut on the moon",
    "a photo of {} cooking in a kitchen",
]
K_ID = 16  # ada token embeddings of a subject
SUBJECTS = 6


def main() -> None:
    slots = int(os.environ.get("BENCH_SERVE_SLOTS", "16"))
    n_reqs = int(os.environ.get("BENCH_SERVE_REQS", "48"))
    steps = int(os.environ.get("BENCH_SERVE_STEPS", "25"))
    card = require_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    modules = PipelineModules.random_init(gen, "cuda", torch.bfloat16)

    # placeholder rows for the ada splice: the last K_ID ids of the vocabulary;
    # the batcher splices by id, so a prompt only has to contain them
    ph_ids = list(range(CLIP_L_TEXT.vocab_size - K_ID, CLIP_L_TEXT.vocab_size))
    batcher = ContinuousBatcher(modules, num_slots=slots, num_inference_steps=steps,
                                placeholder_token_ids=ph_ids)
    subjects = [torch.randn((K_ID, CLIP_L_TEXT.hidden_size), generator=gen, device="cuda") * 0.02
                for _ in range(SUBJECTS)]
    reqs = [Request(prompt=PROMPTS[i % len(PROMPTS)].format("person"),
                    negative_prompt="blurry", ada_embs=subjects[i % SUBJECTS],
                    guidance_scale=6.0, seed=i) for i in range(n_reqs)]

    # warm-up: one drain of a single request (algorithms chosen, kernels built)
    t0 = time.perf_counter()
    for _, img in batcher.generate_all([reqs[0]]).items():
        if not torch.isfinite(img).all():
            raise RuntimeError("warm-up image is not finite")
    torch.cuda.synchronize()
    print(f"# warm-up done {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    for r in reqs:
        batcher.submit(r)
    # a CUDA event behind each image: the drain is never stalled by a
    # synchronisation, and the events give the device's completion times
    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    start.record()
    events = []
    for _ in batcher.run():
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    total = time.perf_counter() - t_start
    lat = [start.elapsed_time(e) / 1e3 for e in events]
    gaps = [b - a for a, b in zip(lat, lat[1:])]
    gaps = gaps or [0.0]
    print(json.dumps({
        "metric": "serving_throughput_loaded",
        "value": round(len(lat) / total, 4),
        "unit": f"imgs/sec ({slots} slots, {steps} steps, {n_reqs} queued "
                "multi-subject requests)",
        "total_sec": round(total, 1),
        "latency_p50_s": round(float(np.percentile(lat, 50)), 2),
        "latency_p99_s": round(float(np.percentile(lat, 99)), 2),
        "completion_gap_p50_s": round(float(np.percentile(gaps, 50)), 3),
        "completion_gap_p99_s": round(float(np.percentile(gaps, 99)), 3),
        "card": card,
        "device": torch.cuda.get_device_name(0),
    }))


if __name__ == "__main__":
    main()
