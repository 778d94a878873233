"""Face-similarity metrics.

Counterpart of `adaface_tpu/evaluation/face_sim.py` (the reference's
`deepface_embed_images` / `insightface_embed_images`,
`calc_faces_similarities`, `compare_face_folders`): each image's largest
face is embedded by a face backend, and two sets are scored by the mean of
their all-pairs cosines.

The backend is always named. JAX's `default_backend()`
(`adaface_tpu/id2ada/face_backends.py:135-139`) takes insightface where it
is installed and otherwise, silently, `DeterministicBackend`, which scores a
face by a hash of its bytes; the card's machine has no insightface, so
here `backend=None` raises, and `make_face_backend` builds one of
`FACE_BACKENDS` by name: the repository's own RetinaFace + ArcFace stack
(random weights from the generator) or the hash backend for tests.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from adaface_tpu_torch.id2ada.face_backends import (DeterministicBackend, FaceBackend,
                                                    RetinaFaceArcFaceBackend)
from adaface_tpu_torch.utils.image import read_image, to_rgb

IMG_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}
FACE_BACKENDS = ("retinaface_arcface", "deterministic")


def make_face_backend(name: str, device="cuda",
                      generator: torch.Generator | None = None) -> FaceBackend:
    """The face backend `name` of FACE_BACKENDS: "retinaface_arcface" builds
    RetinaFace and ArcFace in fp32 on `device`, random from `generator`
    (seeded 0 on `device` when None); "deterministic" hashes the pixels."""
    if name == "deterministic":
        return DeterministicBackend()
    if name == "retinaface_arcface":
        gen = generator if generator is not None else torch.Generator(device).manual_seed(0)
        return RetinaFaceArcFaceBackend.random_init(gen, torch.device(device))
    raise ValueError(f"face backend {name!r}: the port has {', '.join(FACE_BACKENDS)}")


def _require(backend: FaceBackend | None) -> FaceBackend:
    if backend is None:
        raise ValueError("a face backend is required: make_face_backend("
                         f"{' | '.join(repr(n) for n in FACE_BACKENDS)}); the port does not fall "
                         "back to scoring faces by a hash of their bytes")
    return backend


def image_paths(folder: str, limit: int | None = None) -> list[str]:
    """The folder's images by extension, sorted, the first `limit`."""
    paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if os.path.splitext(f)[1].lower() in IMG_EXTS)
    return paths[:limit] if limit else paths


def load_folder_images(folder: str, limit: int | None = None) -> list[np.ndarray]:
    """RGB uint8 [H, W, 3] arrays of `image_paths(folder, limit)`, read by
    `utils.image.read_image` (PNG, JPEG, BMP, WebP, GIF)."""
    return [to_rgb(read_image(p)) for p in image_paths(folder, limit)]


def embed_images(images: Sequence[np.ndarray], backend: FaceBackend | None) -> np.ndarray:
    """→ [N_detected, 512] normalized embeddings (undetected skipped)."""
    backend = _require(backend)
    embs = [e for e in (backend.detect_and_embed(im) for im in images) if e is not None]
    return np.stack(embs) if embs else np.zeros((0, 512), np.float32)


def calc_faces_similarities(embs_a: np.ndarray, embs_b: np.ndarray) -> float:
    """All-pairs mean cosine; NaN where a set has no face."""
    if len(embs_a) == 0 or len(embs_b) == 0:
        return float("nan")
    a = embs_a / (np.linalg.norm(embs_a, axis=-1, keepdims=True) + 1e-8)
    b = embs_b / (np.linalg.norm(embs_b, axis=-1, keepdims=True) + 1e-8)
    return float((a @ b.T).mean())


def compare_face_images(images_a: Sequence[np.ndarray], images_b: Sequence[np.ndarray],
                        backend: FaceBackend | None) -> dict:
    backend = _require(backend)
    ea = embed_images(images_a, backend)
    eb = embed_images(images_b, backend)
    return {"face_sim": calc_faces_similarities(ea, eb), "n_faces_a": len(ea),
            "n_faces_b": len(eb)}
