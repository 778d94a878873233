"""Host-side face backends: image → 512-d L2-normalised ID embedding.

The deterministic backend of `adaface_tpu/id2ada/face_backends.py:95-107`,
copied: the `adaface_tpu.id2ada` package imports JAX on import, and the port
must run where JAX is not installed. The insightface and ArcFace backends
are later work.
"""

from __future__ import annotations

import hashlib

import numpy as np


class FaceBackend:
    embedding_dim = 512

    def detect_and_embed(self, image_np: np.ndarray) -> np.ndarray | None:
        """image_np: HWC uint8 RGB → [512] normalized embedding or None."""
        raise NotImplementedError


class DeterministicBackend(FaceBackend):
    """Offline backend: embedding = seeded hash of the image bytes."""

    def __init__(self, always_detect: bool = True):
        self.always_detect = always_detect

    def detect_and_embed(self, image_np: np.ndarray) -> np.ndarray | None:
        if not self.always_detect and image_np.mean() < 1.0:
            return None  # "no face" in a black image
        digest = hashlib.sha256(np.ascontiguousarray(image_np)).digest()
        rs = np.random.RandomState(int.from_bytes(digest[:4], "little"))
        emb = rs.randn(512).astype(np.float32)
        return emb / np.linalg.norm(emb)
