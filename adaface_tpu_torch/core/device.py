"""The card a measurement ran on, and fp32 convolutions on it."""

from __future__ import annotations

import subprocess
from contextlib import contextmanager

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


@contextmanager
def fp32_convolutions(matmuls: bool = False):
    """cuDNN convolutions in full fp32 inside the block (also as a
    decorator): PyTorch lets them use TF32 by default, which moves a face
    detector's boxes and so the face path off its fp32 reference. With
    `matmuls`, cuBLAS matmuls lose TF32 too (off by PyTorch's default, but a
    caller may have turned it on)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    if matmuls:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
