"""The card a measurement ran on."""

from __future__ import annotations

import subprocess

import torch


def require_card() -> str:
    """→ "name, power limit" of GPU 0 as `nvidia-smi` gives them; exits
    where there is no CUDA device: a measurement never falls back to the
    CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures on a GPU only")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip()
