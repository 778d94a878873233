"""Face backends: image → 512-d L2-normalised ID embedding, or None.

Counterparts of `adaface_tpu/id2ada/face_backends.py:57-132`, copied
because the `adaface_tpu.id2ada` package imports JAX on import:
- `DeterministicBackend`: a seeded hash of the image bytes (offline tests,
  the default);
- `ArcFaceBackend`: ArcFace resnet_face18 on the centre square of a face
  crop, grey and resized to 128² as OpenCV does it (`utils/image.py`);
- `RetinaFaceArcFaceBackend`: RetinaFace's largest face, then ArcFace on
  that crop: the repository's own detection and embedding stack.
Both networks run on the device of their modules. The insightface backend
(ONNX runtime) and the JAX ArcFace backend's `detector` argument, which no
caller passes, are not ported; no backend falls back to another.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from adaface_tpu_torch.core.params import build
from adaface_tpu_torch.models.arcface import ArcFace, init_arcface_weights_
from adaface_tpu_torch.models.retinaface import (RetinaFace, RetinaFaceClient,
                                                 init_retinaface_weights_)
from adaface_tpu_torch.utils.image import resize_linear, rgb_to_gray


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


class ArcFaceBackend(FaceBackend):
    """ArcFace on the centre square of the image (a face crop already)."""

    def __init__(self, arcface: ArcFace):
        self.arcface = arcface
        self.device = next(arcface.parameters()).device

    @torch.inference_mode()
    def detect_and_embed(self, image_np: np.ndarray) -> np.ndarray | None:
        h, w = image_np.shape[:2]
        s = min(h, w)
        crop = image_np[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
        gray = resize_linear(rgb_to_gray(crop), (128, 128)).astype(np.float32)
        x = torch.from_numpy((gray - 127.5) / 127.5)[None, None].to(self.device)
        emb = self.arcface(x)[0].float().cpu().numpy()
        return emb / (np.linalg.norm(emb) + 1e-8)


class RetinaFaceArcFaceBackend(FaceBackend):
    """RetinaFace's largest face, cropped, then `ArcFaceBackend` on it."""

    def __init__(self, retinaface: RetinaFace, arcface: ArcFace):
        self.client = RetinaFaceClient(retinaface)
        self.arc = ArcFaceBackend(arcface)

    @classmethod
    def random_init(cls, gen: torch.Generator, device):
        """Both networks in float32 on `device`, random at the JAX scales."""
        retinaface = build(RetinaFace, device, torch.float32, init_retinaface_weights_, gen)
        return cls(retinaface, build(ArcFace, device, torch.float32, init_arcface_weights_, gen))

    def detect_and_embed(self, image_np: np.ndarray) -> np.ndarray | None:
        faces = self.client.detect_faces(image_np)
        if not faces:
            return None
        x0, y0, x1, y1 = (int(v) for v in faces[0]["bbox"])
        crop = image_np[max(y0, 0):y1, max(x0, 0):x1]
        if crop.size == 0:
            return None
        return self.arc.detect_and_embed(crop)
