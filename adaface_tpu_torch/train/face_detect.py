"""Host face detection on the recon iteration's decoded images.

Counterpart of `adaface_tpu/train/face_detect.py`. The recon loss detects
faces on its decoded reconstructions (`ldm/models/diffusion/ddpm.py:
2511-2534`); the JAX package hops to the host from inside its jitted graph
through `jax.pure_callback` (`detect_faces_in_graph`). Eager PyTorch needs no
callback: the loss calls the detector inline on a detached copy of the
decoded image (`detect_faces`), which reads the image back to the host once
per active denoising step; the boxes come back as tensors on the image's
device and are data (no gradient) to the crops that follow.

`HostFaceDetector` never raises: a detector that fails, or finds nothing,
gives "no face, full-image box", as `RetinaFaceClient.crop_faces` does
(`evaluation/retinaface_pytorch.py`). Its backend chain is the JAX
package's: an injected `detector_fn`, then insightface, then OpenCV's Haar
cascade, each imported lazily at first use; where none is installed it ends
in "none" and every image is "no face".
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class FaceDetections:
    """Host detection results for a batch of images (numpy arrays).

    fg_bboxes [B, 4] (x0, y0, x1, y1) pixel coords of the largest face
    (full-image box when undetected); detected [B] ∈ {0, 1};
    confidences [B] (1.0 where the backend gives no score);
    bg_bboxes [B, MAX_BG, 4] non-largest faces; bg_valid [B, MAX_BG].
    """

    fg_bboxes: np.ndarray
    detected: np.ndarray
    confidences: np.ndarray
    bg_bboxes: np.ndarray
    bg_valid: np.ndarray


MAX_BG_FACES = 2


def to_uint8_nhwc(images) -> np.ndarray:
    """[B, 3, H, W] float in [-1, 1] → [B, H, W, 3] uint8, truncating as
    `astype` does (the JAX detector's own conversion); a [B, H, W, 3] array
    is only cast."""
    imgs = np.asarray(images)
    if imgs.ndim == 4 and imgs.shape[1] == 3:
        return np.clip((imgs.transpose(0, 2, 3, 1) + 1) * 127.5, 0, 255).astype(np.uint8)
    return imgs.astype(np.uint8)


class HostFaceDetector:
    """Pluggable host-side detector chain.

    Backends (first available wins): an injected `detector_fn`
    (tests, a custom detector), insightface FaceAnalysis, the OpenCV Haar
    cascade. `detector_fn(img_uint8_rgb) -> list[(bbox(4,), score)]`
    sorted any way; faces are ranked by area.
    """

    def __init__(self, detector_fn: Callable | None = None, min_size: int = 20,
                 max_bg: int = MAX_BG_FACES):
        self.detector_fn = detector_fn
        self.min_size = min_size
        self.max_bg = max_bg
        self._insight = None
        self._cascade = None
        self._backend = None

    @property
    def backend(self) -> str:
        """The backend in use: "detector_fn", "insightface", "cascade" or
        "none" (picked at the first call that needs it)."""
        if self.detector_fn is not None:
            return "detector_fn"
        if self._backend is None:
            self._backend = self._pick_backend()
        return self._backend

    def _detect_one(self, img: np.ndarray) -> list[tuple[np.ndarray, float]]:
        """img uint8 RGB [H, W, 3] → [(bbox, score)]."""
        if self.detector_fn is not None:
            return list(self.detector_fn(img) or [])
        backend = self.backend
        if backend == "insightface":
            return [(np.asarray(f.bbox, np.float32), float(f.det_score))
                    for f in self._insight.get(img)]
        if backend == "cascade":
            import cv2

            gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            faces = self._cascade.detectMultiScale(gray, 1.1, 4,
                                                   minSize=(self.min_size, self.min_size))
            return [(np.asarray((x, y, x + w, y + h), np.float32), 1.0)
                    for (x, y, w, h) in faces]
        return []

    def _pick_backend(self) -> str:
        try:
            from insightface.app import FaceAnalysis  # type: ignore

            app = FaceAnalysis(allowed_modules=["detection"])
            app.prepare(ctx_id=-1, det_size=(512, 512))
            self._insight = app
            return "insightface"
        except Exception:
            pass
        try:
            from adaface_tpu_torch.train.face_losses import _load_cascade

            cascade = _load_cascade()
            if cascade is not None:
                self._cascade = cascade
                return "cascade"
        except Exception:
            pass
        return "none"

    def __call__(self, images) -> FaceDetections:
        """images [B, 3, H, W] float in [-1, 1] (or [B, H, W, 3] uint8)."""
        imgs = to_uint8_nhwc(images)
        b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
        fg = np.zeros((b, 4), np.float32)
        det = np.zeros((b,), np.float32)
        conf = np.zeros((b,), np.float32)
        bg = np.zeros((b, self.max_bg, 4), np.float32)
        bgv = np.zeros((b, self.max_bg), np.float32)
        for i in range(b):
            try:
                faces = [(f, s) for (f, s) in self._detect_one(imgs[i])
                         if (f[2] - f[0]) >= self.min_size and (f[3] - f[1]) >= self.min_size]
            except Exception:
                faces = []
            if faces:
                faces.sort(key=lambda fs: -((fs[0][2] - fs[0][0]) * (fs[0][3] - fs[0][1])))
                bb, sc = faces[0]
                fg[i] = np.clip(bb, 0, (w, h, w, h))
                det[i] = 1.0
                conf[i] = sc
                for j, (bb2, _) in enumerate(faces[1:1 + self.max_bg]):
                    bg[i, j] = np.clip(bb2, 0, (w, h, w, h))
                    bgv[i, j] = 1.0
            else:
                fg[i] = (0, 0, w, h)
        return FaceDetections(fg, det, conf, bg, bgv)


def detect_faces(images: torch.Tensor, detector: HostFaceDetector,
                 max_bg: int = MAX_BG_FACES):
    """Host detection on a detached fp32 copy of `images` [B, 3, H, W] in
    [-1, 1] → (fg_bboxes [B, 4], detected [B], confidences [B],
    bg_bboxes [B, max_bg, 4], bg_valid [B, max_bg]), fp32 tensors on the
    images' device: the outputs of the JAX package's `detect_faces_in_graph`."""
    d = detector(images.detach().float().cpu().numpy())
    dev = images.device
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                 for a in (d.fg_bboxes, d.detected, d.confidences,
                           d.bg_bboxes[:, :max_bg], d.bg_valid[:, :max_bg]))


def bbox_latent_mask(bboxes: torch.Tensor, detected: torch.Tensor, hw: tuple[int, int]):
    """[B, 4] latent-coord boxes → [B, 1, h, w] {0, 1} mask; undetected rows
    become all-ones (the reference's full-image fallback keeps the recon loss
    on the whole image, `ddpm.py:2741-2749`)."""
    h, w = hw
    ys = torch.arange(h, device=bboxes.device)[None, :, None]
    xs = torch.arange(w, device=bboxes.device)[None, None, :]
    x0, y0, x1, y1 = (bboxes[:, i, None, None] for i in range(4))
    m = ((xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)).float()
    d = detected.float()[:, None, None]
    return (m * d + (1.0 - d))[:, None]


def map_bboxes_to_latent(bboxes: torch.Tensor, pixel_size: int, latent_size: int):
    """Pixel-space boxes → latent coords (`map_bboxes_coords`, `ldm/util.py`:
    integer downscale by the VAE's stride)."""
    return torch.floor(bboxes * (latent_size / pixel_size))
