"""The card a measurement ran on, and fp32 convolutions on it."""

from __future__ import annotations

import subprocess
import threading
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
    caller may have turned it on).

    The flags are global to the process, and the trainer's prefetch thread
    opens blocks beside the main thread's: so each flag keeps a count of the
    blocks open on it, under one lock. The first block to open saves and
    clears the flag, the last to close restores it; a block without
    `matmuls` leaves cuBLAS's flag alone."""
    flags = ("cudnn", "matmul") if matmuls else ("cudnn",)
    with _TF32_LOCK:
        for flag in flags:
            if _TF32_OPEN[flag] == 0:
                _TF32_SAVED[flag] = _tf32(flag)
                _set_tf32(flag, False)
            _TF32_OPEN[flag] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            for flag in flags:
                _TF32_OPEN[flag] -= 1
                if _TF32_OPEN[flag] == 0:
                    _set_tf32(flag, _TF32_SAVED.pop(flag))


_TF32_LOCK = threading.Lock()
_TF32_OPEN = {"cudnn": 0, "matmul": 0}  # blocks open on each flag
_TF32_SAVED: dict[str, bool] = {}  # each flag's value before its first block


def _tf32(flag: str) -> bool:
    return (torch.backends.cudnn if flag == "cudnn" else torch.backends.cuda.matmul).allow_tf32


def _set_tf32(flag: str, value: bool) -> None:
    (torch.backends.cudnn if flag == "cudnn" else torch.backends.cuda.matmul).allow_tf32 = value
