"""Build and load the port's CUDA kernels; count their launches.

The kernel sources under `adaface_tpu_torch/csrc/` have a plain C interface.
They are compiled with `nvcc` into one shared library at first use and
loaded with `ctypes`: a build takes seconds, where an extension that includes
PyTorch's headers takes minutes. The library lands in
`adaface_tpu_torch/_build/`, named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. `nvcc`'s
output, register and shared-memory use per kernel included (`-Xptxas -v`),
is kept beside the library as `<name>.log`.

Nothing here runs on import: the CPU tests import every module of the port
on a machine with no `nvcc` and no card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attn_fwd.cu", "group_norm_silu.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel, counted by its wrapper where it launches it.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libadaface_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    srcs = [str(CSRC / name) for name in SOURCES]
    # build under a temporary name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                              capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them, once per process."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.flash_attn_fwd.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, i32,
                                   i32, f32, i32, p]
    lib.flash_attn_fwd.restype = i32
    lib.gn_stats.argtypes = [p, p, i64, i64, f32, i32, p]
    lib.gn_stats.restype = i32
    lib.gn_norm.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32, i32, p]
    lib.gn_norm.restype = i32
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
