"""Quality gate for the serving speed modes, on the PyTorch port: the
counterpart of `scripts/bench_quality.py`.

Runs `bench_torch.py` twice in subprocesses with the same seeds: the
reference (every speed mode off) and a turbo configuration (`TURBO_ENV`,
default `ADAFACE_BENCH_INT8=1 ADAFACE_BENCH_DEEPCACHE=5`), each saving its
last timed batch (`ADAFACE_BENCH_SAVE_OUT`, batch 32) without the batch-1
latency (`ADAFACE_BENCH_P50=0`). Then it compares the two batches by:

- the ArcFace-embedding cosine (`models/arcface.py` on the centre crop of
  each image: grey, 128², [-1, 1]). The tower has random weights from a
  seeded `torch.Generator` until real resnet_face18 weights are converted,
  so the cosine is a random-CNN perceptual distance, not identity;
- the pixel MAE and correlation.

Prints one JSON line with `bench_quality.py`'s keys, the card's name and
power limit. `compare` is the measurement alone (`chip_smoke.py` runs it on
images it already has).

    python scripts/bench_quality_torch.py                 # bf16 vs int8 + DeepCache 5
    TURBO_ENV="ADAFACE_BENCH_TOME=0.5" python scripts/bench_quality_torch.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench_torch.py")
DEFAULT_TURBO_ENV = "ADAFACE_BENCH_INT8=1 ADAFACE_BENCH_DEEPCACHE=5"
RGB_TO_GRAY = (0.299, 0.587, 0.114)


def random_arcface(device="cuda", seed: int = 0):
    """resnet_face18 (with SE, as `init_arcface_params`' default) at the JAX
    init's scales, drawn from `torch.Generator().manual_seed(seed)`."""
    from adaface_tpu_torch.models.arcface import ArcFace, init_arcface_weights_

    model = ArcFace()
    init_arcface_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def arcface_embeddings(arcface, images) -> torch.Tensor:
    """images [B, 3, H, W] in [0, 1] → unit ArcFace embeddings [B, 512] of
    the centre crop (a quarter off each side), grey, resized to 128² by an
    antialiased triangle filter (as `jax.image.resize(..., "linear")`
    downsamples), mapped to [-1, 1]."""
    dev = next(arcface.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32)).to(dev)
    h, w = x.shape[2:4]
    ch, cw = h // 4, w // 4
    x = x[:, :, ch:h - ch, cw:w - cw]
    gray = (x * torch.tensor(RGB_TO_GRAY, device=dev)[None, :, None, None]).sum(1, keepdim=True)
    gray = F.interpolate(gray, size=(128, 128), mode="bilinear", align_corners=False,
                         antialias=True)
    with torch.no_grad():
        emb = arcface((gray - 0.5) / 0.5).float()
    return emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)


def compare(ref_images, turbo_images, arcface) -> dict:
    """Two batches of the same seeds, [B, 3, H, W] in [0, 1] (numpy or
    tensors) → the mean ArcFace cosine of matched images, the pixel MAE and
    the pixel correlation (fp32 images, sums in fp64)."""
    a = np.asarray(torch.as_tensor(ref_images).float().cpu(), np.float32)
    b = np.asarray(torch.as_tensor(turbo_images).float().cpu(), np.float32)
    if a.shape != b.shape:
        raise ValueError(f"the batches differ in shape: {a.shape} and {b.shape}")
    ea, eb = arcface_embeddings(arcface, a), arcface_embeddings(arcface, b)
    return {"arcface_cosine": float((ea * eb).sum(-1).mean()),
            "pixel_mae": float(np.abs(a - b).mean()),
            "pixel_corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1])}


def parse_env(spec: str) -> dict:
    out = {}
    for pair in spec.split():
        k, v = pair.split("=", 1)
        out[k] = v
    return out


def run_bench(out_path: str, extra_env: dict) -> dict | None:
    """One `bench_torch.py` subprocess saving its last batch to `out_path` →
    its JSON line (None if it failed)."""
    env = dict(os.environ)
    env.update(extra_env)
    env["ADAFACE_BENCH_SAVE_OUT"] = out_path
    env["ADAFACE_BENCH_P50"] = "0"
    r = subprocess.run([sys.executable, BENCH], capture_output=True, text=True, env=env)
    sys.stderr.write(r.stderr)
    result = None
    for line in r.stdout.splitlines():
        if line.strip().startswith("{"):
            result = json.loads(line)
    if r.returncode != 0 or result is None:
        print(f"# bench run failed rc={r.returncode}", file=sys.stderr)
        return None
    return result


def main() -> None:
    from adaface_tpu_torch.core.device import require_card

    card = require_card()
    turbo_env = parse_env(os.environ.get("TURBO_ENV", DEFAULT_TURBO_ENV))
    with tempfile.TemporaryDirectory(prefix="bench_quality_") as tmp:
        ref_npz, turbo_npz = os.path.join(tmp, "ref.npz"), os.path.join(tmp, "turbo.npz")
        ref = run_bench(ref_npz, {"ADAFACE_BENCH_INT8": "0", "ADAFACE_BENCH_DEEPCACHE": "0",
                                  "ADAFACE_BENCH_TOME": "0"})
        turbo = run_bench(turbo_npz, turbo_env)
        if ref is None or turbo is None:
            sys.exit(1)
        a = np.load(ref_npz)["images"].astype(np.float32)
        b = np.load(turbo_npz)["images"].astype(np.float32)
    scores = compare(a, b, random_arcface("cuda"))
    print(json.dumps({
        "metric": "turbo_quality_gate",
        "turbo_env": turbo_env,
        "ref_imgs_per_sec": ref["value"],
        "turbo_imgs_per_sec": turbo["value"],
        "speedup": round(turbo["value"] / ref["value"], 3),
        "arcface_cosine": round(scores["arcface_cosine"], 4),
        "pixel_mae": round(scores["pixel_mae"], 5),
        "pixel_corr": round(scores["pixel_corr"], 5),
        "ref_spread": ref.get("iter_sec_spread"),
        "turbo_spread": turbo.get("iter_sec_spread"),
        "images": list(a.shape),
        "card": card,
    }))


if __name__ == "__main__":
    main()
