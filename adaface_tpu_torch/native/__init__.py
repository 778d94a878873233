"""The port's host library: image decoding and the training item pipeline.

Two C++ sources, built together with `g++ -O3 -shared -fPIC` at first use
into `adaface_tpu_torch/_build/`, the library named by a hash of the sources
and flags (as `ops/_build.py` names the CUDA one), and loaded with ctypes:

- `decode.cpp`: JPEG (8-bit Huffman sequential and progressive, grey and
  YCbCr at 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0) and BMP (24-, 32-bit and 8-bit
  paletted) to the pixels Pillow with libjpeg-turbo gives, bit for bit; any
  other variant is refused with a message. Entropy decoding in Python loops
  would cost seconds a photo and hold the trainer's prefetch thread back.
- `imgops.cpp`: `prepare_item`, the dataset's resize → flip → shrink into
  the canvas → roll → normalize chain, the same bits as
  `data.personalized.augment_numpy`; `resize_bilinear_pil`, Pillow's
  BILINEAR resize, the same bits as `utils.image.resize_bilinear_pil` (the
  face parser's items: numpy took ~80% of an item's host time).

A build or load failure raises: these readers have no other path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from adaface_tpu_torch.utils.image import _pil_bilinear_coeffs

SRC = pathlib.Path(__file__).resolve().parent
BUILD_DIR = SRC.parent / "_build"
SOURCES = ("decode.cpp", "imgops.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libhostops_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, "lib.so")
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", lib, *(str(SRC / n) for n in SOURCES)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"the host library could not be built ({CXX}: {e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"the host library could not be built:\n{proc.stdout}")
        os.replace(lib, out)  # a reader never sees half a file


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build the library if needed and load it, once per process."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    p, i32, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    lib.image_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i32]
    lib.image_info.restype = i32
    lib.image_decode.argtypes = [p, sz, p, ctypes.c_char_p, i32]
    lib.image_decode.restype = i32
    lib.prepare_item.argtypes = [p, i32, i32, p, i32, i32, i32, i32, i32, i32, p, p, p, p]
    lib.prepare_item.restype = i32
    lib.resample_pass_u8.argtypes = [p, i32, i32, i32, i32, p, p, i32, i32, p]
    lib.resample_pass_u8.restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_image(data: bytes, path="<bytes>") -> np.ndarray:
    """A JPEG or BMP file's bytes → uint8 [H, W] (grey JPEG) or [H, W, 3]
    (RGB). Raises ValueError naming `path` and what it found for a variant
    the decoder does not take."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.image_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                      err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    out = np.empty((h.value, w.value) + ((c.value,) if c.value > 1 else ()), np.uint8)
    if lib.image_decode(_ptr(buf), buf.size, _ptr(out), err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def prepare_item(image: np.ndarray, fg_mask: np.ndarray | None, out_size: int, do_flip: bool,
                 scale: float, dy: int, dx: int):
    """The item pipeline on image [S, S, 3] uint8 and fg_mask [S, S] float
    {0, 1} or None, with the dataset's drawn decisions → (image [S, S, 3] in
    [-1, 1], fg_mask [S, S], aug_mask [S, S]) float32, the bits of
    `data.personalized.augment_numpy`: the shrink is to max(int(S·scale), 8)
    pixels where scale < 0.999."""
    lib = load_library()
    s = out_size
    image = np.ascontiguousarray(image, np.uint8)
    fg = None if fg_mask is None else np.ascontiguousarray(
        (np.asarray(fg_mask) * 255).astype(np.uint8))
    out_img = np.empty((s, s, 3), np.float32)
    out_fg = np.empty((s, s), np.float32)
    out_aug = np.empty((s, s), np.float32)
    scratch = np.empty(3 * s * s * 3, np.uint8)
    # the canvas side as num / den of S: the numpy path's max(int(S·scale), 8)
    num, den = (max(int(s * scale), 8), s) if scale < 0.999 else (1, 1)
    if num == den:
        num, den = 1, 1
    rc = lib.prepare_item(_ptr(image), image.shape[0], image.shape[1],
                          None if fg is None else _ptr(fg), s, int(do_flip), num, den, int(dy),
                          int(dx), _ptr(out_img), _ptr(out_fg), _ptr(out_aug), _ptr(scratch))
    if rc != 0:
        raise RuntimeError(f"prepare_item returned {rc}")
    return out_img, out_fg, out_aug


def _resample_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    first, w = _pil_bilinear_coeffs(img.shape[axis], n_out)
    first = np.ascontiguousarray(first, np.int32)
    w = np.ascontiguousarray(w, np.int32)
    h, wd = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((h, n_out) + img.shape[2:] if axis == 1 else (n_out, wd) + img.shape[2:],
                   np.uint8)
    load_library().resample_pass_u8(_ptr(img), h, wd, c, axis, _ptr(first), _ptr(w),
                                    w.shape[1], n_out, _ptr(out))
    return out


def resize_bilinear_pil(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`Image.resize((w, h), Image.BILINEAR)` on uint8 [H, W] or [H, W, 3]
    through the library: the bits of `utils.image.resize_bilinear_pil` (a
    horizontal pass rounded to uint8, then a vertical one; an axis of
    unchanged size is not resampled)."""
    out_w, out_h = size
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if out_w != w:
        img = _resample_pass(img, out_w, 1)
    if out_h != h:
        img = _resample_pass(img, out_h, 0)
    return img.copy() if (out_w, out_h) == (w, h) else img
