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
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_attn_fwd.cu", "flash_attn_wgmma.cu", "flash_attn_wide.cu", "flash_attn_bwd.cu",
           "flash_attn_bwd_wg.cu", "group_norm_silu.cu", "batch_norm_act.cu", "layer_norm.cu",
           "int8_conv.cu", "launch_floor.cu")
# included by the sources: in the hash
HEADERS = ("flash_common.cuh", "flash_wgmma.cuh", "flash_bwd.cuh", "int8_wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each kernel, counted by its wrapper where it launches it
# (`count`). The trainer's prefetch thread launches kernels beside the main
# thread's, and `Counter[key] += 1` is a read, an add and a write: the lock
# keeps an update from being lost.
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


def count(key: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES.clear()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`: what the wrappers'
    plans size their grids by."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libadaface_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{name}.o") for name in SOURCES]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for name, obj in zip(SOURCES, objs)]
        logs = [f"== {name}\n{proc.communicate()[0]}" for name, proc in zip(SOURCES, procs)]
        failed = [name for name, proc in zip(SOURCES, procs) if proc.returncode != 0]
        if not failed:
            # link under a temporary name, then rename: a reader never sees half a file
            lib = os.path.join(tmp, "lib.so")
            link = subprocess.run([_nvcc(), "-shared", "-o", lib, *objs],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        log = "\n".join(logs)
        out.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the kernels if needed and load them, once per process."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    flash_args = [p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, f32]
    lib.flash_fwd_bf16_wg.argtypes = flash_args + [i32, p, p]  # block rows, stats, stream
    lib.flash_fwd_bf16_wg.restype = i32
    lib.flash_fwd_fp32.argtypes = flash_args + [p]
    lib.flash_fwd_fp32.restype = i32
    # nsplit, o_part, m_part, l_part, stats (or null), stream
    lib.flash_fwd_bf16_wide.argtypes = flash_args + [i32, p, p, p, p, p]
    lib.flash_fwd_bf16_wide.restype = i32
    lib.flash_tensor_map_stats.argtypes = [p, i32]
    lib.flash_tensor_map_stats.restype = None
    # o_part, m_part, l_part, out, strides, nsplit, B, H, Sq, D, bf16, stats (or null), stream
    lib.flash_combine.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, i32, p, p]
    lib.flash_combine.restype = i32
    # q, k, v, g, mask, stats, delta, (dk, dv | dq), strides, B, H, Sq, Sk, D, causal, scale,
    # keys (queries) a block (_wg only), stream
    for name, n in (("flash_bwd_dkdv", 10), ("flash_bwd_dq", 9)):
        getattr(lib, name + "_wg").argtypes = [p] * n + [i32] * 6 + [f32, i32, p]
        getattr(lib, name + "_cl").argtypes = [p] * n + [i32] * 6 + [f32, p]
        getattr(lib, name + "_wg").restype = getattr(lib, name + "_cl").restype = i32
    # out, g, delta, strides, B, H, Sq, D, stream
    lib.flash_bwd_delta.argtypes = [p] * 4 + [i32] * 4 + [p]
    lib.flash_bwd_delta.restype = i32
    gn_geometry = [i64, i32, i32, i32, i32, i32, i32]  # B, rows, C, G, slab, chunks, threads
    # x, scale, bias, y, stats (or null)
    lib.gn_fused.argtypes = [p] * 5 + gn_geometry + [f32, i32, i32, p]
    lib.gn_fused.restype = i32
    lib.gn_stats.argtypes = [p, p] + gn_geometry + [i32, p]
    lib.gn_stats.restype = i32
    # x, part, scale, bias, y, stats (or null)
    lib.gn_norm.argtypes = [p] * 6 + gn_geometry + [f32, i32, i32, p]
    lib.gn_norm.restype = i32
    # x, dy, stats, scale, bias, dx, channel sums (or null); stage rows, silu, bf16, stream
    lib.gn_bwd_fused.argtypes = [p] * 7 + gn_geometry + [i32, i32, i32, p]
    lib.gn_bwd_fused.restype = i32
    # cluster, threads, shared memory, bf16, out: clusters the card holds at once
    lib.gn_bwd_fused_clusters.argtypes = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.gn_bwd_fused_clusters.restype = i32
    # x, dy, stats, scale, bias, group sums, channel sums (or null)
    lib.gn_bwd_reduce.argtypes = [p] * 7 + gn_geometry + [i32, i32, p]
    lib.gn_bwd_reduce.restype = i32
    # x, dy, stats, group sums, scale, bias, dx; silu, bf16, stream
    lib.gn_bwd_dx.argtypes = [p] * 7 + gn_geometry + [i32, i32, p]
    lib.gn_bwd_dx.restype = i32
    # x, partial, stats, ticket, rows, C, chunks, chunk rows, threads, lanes, vec, eps, bf16,
    # stream
    # x, partial, stats, sums (or null), ticket, rows, c, chunks, chunk rows, threads, lanes,
    # vec, eps, bf16, stream
    lib.bn_stats.argtypes = [p, p, p, p, p, i64, i32, i32, i64, i32, i32, i32, f32, i32, p]
    lib.bn_stats.restype = i32
    lib.bn_norm_act.argtypes = [p, p, p, p, p, p, i64, i32, f32, i32, p]
    lib.bn_norm_act.restype = i32
    # x, w, b, y, rows, C, packs, lanes, warps, threads, eps, bf16, stream
    lib.layer_norm.argtypes = [p, p, p, p, i64, i32, i32, i32, i32, i32, f32, i32, p]
    lib.layer_norm.restype = i32
    # x, elements, scale words (max |x|, then the blocks' maxima), x_q, stream
    lib.int8_quantize.argtypes = [p, i64, p, p, p]
    lib.int8_quantize.restype = i32
    # w_q, w_scale, bias, N, H, W, I, O, k, stride, pad, Ho, Wo, tile N, stages, split
    lib.int8_igemm_prepare.argtypes = [p] * 3 + [i32] * 13
    lib.int8_igemm_prepare.restype = i64
    # the launch's handle, x_q, scale words, y, stream
    lib.int8_conv_igemm.argtypes = [i64, p, p, p, p]
    lib.int8_conv_igemm.restype = i32
    # tile N, stages, split, out: blocks of `int8_conv_igemm` an SM holds
    lib.int8_igemm_occupancy.argtypes = [i32] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.int8_igemm_occupancy.restype = i32
    lib.launch_floor.argtypes = [p]
    lib.launch_floor.restype = i32
    return lib


def launch_floor(stream: int) -> None:
    """Launch the empty kernel of `csrc/launch_floor.cu` on `stream`: the
    yardstick for what one launch costs on the device. Not counted."""
    check(load_library().launch_floor(stream), "launch_floor")


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
