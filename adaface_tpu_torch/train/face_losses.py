"""ArcFace identity losses with gradient-masked face crops.

Counterpart of `adaface_tpu/train/face_losses.py` (a rebuild of
`ldm/modules/arcface_wrapper.py`): the generated images are decoded, faces
located on the host (`face_detect.HostFaceDetector`), cropped
differentiably (`bilinear_crop`), converted to grayscale 128×128 and
embedded with the frozen ArcFace (`models/arcface.py`; its weights frozen,
its BatchNorms in inference mode, its convolutions in full fp32). Two
gradient masks shape the training signal (`embed_image_tensor:89-166`):

- center mask (ratio 1 ⇒ off by default): align-loss gradients reach only
  the face's center, so the face is not pushed to grow;
- border mask (ratio 0.3): suppress-loss gradients reach only the border,
  so the face shrinks from the outside without losing identity.

`gradient_mask` is the JAX package's `custom_vjp` as an autograd Function.
Under data parallelism the means over detected faces divide by the global
count (`parallel.collectives`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from adaface_tpu_torch.parallel.collectives import gmean, gsum
from adaface_tpu_torch.utils.tensor import device_constant

RGB_TO_GRAY = (0.299, 0.587, 0.114)


class _GradientMask(torch.autograd.Function):
    """Identity forward; the cotangent multiplied by the mask
    (`MaskedGrad:9-47`)."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask, None


def gradient_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _GradientMask.apply(x, mask)


def bilinear_crop(images: torch.Tensor, bboxes: torch.Tensor, out_size: int = 128):
    """Differentiable per-instance crop and resize by bilinear gathers:
    images [B, C, H, W], bboxes [B, 4] (x0, y0, x1, y1) pixels (float ok) →
    [B, C, out, out]. The sample points run from (x0, y0) to (x1 - 1, y1 - 1)
    inclusive, clipped to the image."""
    b, c, h, w = images.shape
    dev = images.device
    x0, y0, x1, y1 = (bboxes[:, i].float() for i in range(4))
    # i / (n - 1) in fp32 and a last point of exactly 1, as `jnp.linspace`
    # computes them (torch.linspace differs by an ulp at some points, which
    # moves a sample by ~1e-6 px)
    tt = torch.cat([torch.arange(out_size - 1, dtype=torch.float32, device=dev)
                    / (out_size - 1), torch.ones(1, device=dev)])
    ys = (y0[:, None] + tt[None, :] * (y1 - y0 - 1)[:, None]).clamp(0, h - 1)  # [B, out]
    xs = (x0[:, None] + tt[None, :] * (x1 - x0 - 1)[:, None]).clamp(0, w - 1)
    y0i, x0i = ys.floor().long(), xs.floor().long()
    y1i, x1i = (y0i + 1).clamp(max=h - 1), (x0i + 1).clamp(max=w - 1)
    wy = (ys - y0i)[:, None, :, None]  # [B, 1, out, 1]
    wx = (xs - x0i)[:, None, None, :]  # [B, 1, 1, out]

    def gather(yi, xi):
        # rows yi of each image, then columns xi: [B, C, out, out]
        rows = torch.gather(images, 2, yi[:, None, :, None].expand(b, c, out_size, w))
        return torch.gather(rows, 3, xi[:, None, None, :].expand(b, c, out_size, out_size))

    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x1i) * wx
    bot = gather(y1i, x0i) * (1 - wx) + gather(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def _central_mask(out_size: int, ratio: float, device=None) -> torch.Tensor:
    """[1, 1, S, S] with the central `ratio` square set to 1."""
    m = torch.zeros((out_size, out_size), device=device)
    ml = int(out_size * (1 - ratio) / 2)
    m[ml:out_size - ml, ml:out_size - ml] = 1.0
    return m[None, None]


def embed_face_crops(arcface, images: torch.Tensor, bboxes: torch.Tensor,
                     fg_faces_grad_mask_ratios: tuple[float, float] = (1.0, 0.3)):
    """images [B, 3, H, W] in [-1, 1], bboxes [B, 4] → (emb_center [B, 512],
    emb_border [B, 512]); ArcFace runs in its weights' dtype (fp32)."""
    crops = bilinear_crop(images, bboxes, 128)
    gray_w = device_constant(RGB_TO_GRAY, images.device)[None, :, None, None]
    gray = (crops * gray_w).sum(dim=1, keepdim=True)
    dt = next(arcface.parameters()).dtype
    center_ratio, border_ratio = fg_faces_grad_mask_ratios
    gray_center = gray
    if 0 < center_ratio < 1:
        gray_center = gradient_mask(gray, _central_mask(128, center_ratio, images.device))
    emb_center = arcface(gray_center.to(dt))
    if 0 < border_ratio < 1:
        border = 1.0 - _central_mask(128, border_ratio, images.device)
        emb_border = arcface(gradient_mask(gray, border).to(dt))
    else:
        emb_border = emb_center
    return emb_center, emb_border


def _cos(a, b):
    return (a * b).sum(-1) / (torch.sqrt((a * a).sum(-1) + 1e-8)
                              * torch.sqrt((b * b).sum(-1) + 1e-8))


def calc_arcface_align_loss(arcface, ref_images, aligned_images, ref_bboxes, aligned_bboxes,
                            face_detected_mask, bg_bboxes=None, bg_image_idx=None,
                            fg_faces_grad_mask_ratios=(1.0, 0.3)):
    """(`:171-230`) ref_images [B, 3, H, W], aligned_images (generated, the
    gradient flows) [B, 3, H, W], host-detected boxes [B, 4] each,
    face_detected_mask [B]; optional background boxes [Nbg, 4] with the index
    of their image [Nbg] → (loss_align, loss_fg_suppress, loss_bg)."""
    with torch.no_grad():
        ref_emb, _ = embed_face_crops(arcface, ref_images.detach(), ref_bboxes, (-1.0, -1.0))
    emb_center, emb_border = embed_face_crops(arcface, aligned_images, aligned_bboxes,
                                              fg_faces_grad_mask_ratios)
    if ref_emb.shape[0] < emb_center.shape[0]:
        ref_emb = ref_emb.repeat(emb_center.shape[0] // ref_emb.shape[0], 1)
    m = face_detected_mask.float()
    denom = gsum(m.sum()) + 1e-6
    loss_align = gsum(((1.0 - _cos(ref_emb, emb_center)) * m).sum()) / denom
    loss_fg_suppress = gsum(((emb_border ** 2).mean(-1) * m).sum()) / denom
    loss_bg = torch.zeros((), device=aligned_images.device)
    if bg_bboxes is not None and bg_image_idx is not None and len(bg_bboxes):
        bg_emb, _ = embed_face_crops(arcface, aligned_images[bg_image_idx], bg_bboxes,
                                     (-1.0, -1.0))
        loss_bg = gmean(bg_emb ** 2)
    return loss_align, loss_fg_suppress, loss_bg


def calc_bg_faces_suppress_loss(arcface, images, bg_bboxes, bg_valid):
    """Mean-L2 suppression of background-face embeddings over a fixed number
    of slots (images [B, 3, H, W], bg_bboxes [B, Nbg, 4] pixels, bg_valid
    [B, Nbg] ∈ {0, 1}); invalid slots are masked out → (loss, any_valid)."""
    b, nbg = bg_valid.shape
    imgs_rep = images.repeat_interleave(nbg, dim=0)  # [B·Nbg, 3, H, W]
    emb, _ = embed_face_crops(arcface, imgs_rep, bg_bboxes.reshape(b * nbg, 4), (-1.0, -1.0))
    per_face = (emb.float() ** 2).mean(-1)
    v = bg_valid.reshape(-1).float()
    n_valid = gsum(v.sum())
    any_valid = (n_valid > 0).float()
    loss = gsum((per_face * v).sum()) / (n_valid + 1e-6)
    return loss * any_valid, any_valid


# ---------------------------------------------------------------------------
# host-side detection without an injected detector
# ---------------------------------------------------------------------------

_CASCADE = None


def _load_cascade():
    """OpenCV's frontal-face Haar cascade, or None (no cv2, a build without
    objdetect, or no XML). Raises ImportError where cv2 is absent."""
    import cv2

    candidates = []
    if hasattr(cv2, "data") and hasattr(cv2.data, "haarcascades"):
        candidates.append(os.path.join(cv2.data.haarcascades,
                                       "haarcascade_frontalface_default.xml"))
    candidates.append("/usr/share/opencv4/haarcascades/haarcascade_frontalface_default.xml")
    if not hasattr(cv2, "CascadeClassifier"):
        return None
    for path in candidates:
        if os.path.exists(path):
            c = cv2.CascadeClassifier(path)
            if not c.empty():
                return c
    return None


def detect_face_bboxes(images_np: np.ndarray, min_size: int = 20,
                       heuristic_center: bool = False,
                       retinaface_client=None) -> tuple[np.ndarray, np.ndarray]:
    """Host face detection → (bboxes [B, 4], detected [B]); images
    [B, 3, H, W] in [-1, 1] or [B, H, W, 3] uint8.

    A `retinaface_client` (`detect_faces(img, T=min_size)`) first, else the
    OpenCV cascade where cv2 has one, else none. Undetected instances get a
    full-image box and detected 0; with `heuristic_center` and no detection a
    central 60% box with detected 1 (synthetic data only)."""
    global _CASCADE
    if images_np.ndim == 4 and images_np.shape[1] == 3:
        imgs = np.clip((images_np.transpose(0, 2, 3, 1) + 1) * 127.5, 0, 255).astype(np.uint8)
    else:
        imgs = images_np.astype(np.uint8)
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    bboxes = np.zeros((b, 4), np.float32)
    detected = np.zeros((b,), np.float32)
    if retinaface_client is not None:
        for i in range(b):
            faces = retinaface_client.detect_faces(imgs[i], T=min_size)
            if faces:
                bboxes[i] = faces[0]["bbox"]
                detected[i] = 1.0
            else:
                bboxes[i] = (0, 0, w, h)
        return bboxes, detected
    if _CASCADE is None:
        try:
            _CASCADE = _load_cascade() or "unavailable"
        except ImportError:
            _CASCADE = "unavailable"
    for i in range(b):
        faces = ()
        if _CASCADE != "unavailable":
            import cv2

            gray = cv2.cvtColor(imgs[i], cv2.COLOR_RGB2GRAY)
            faces = _CASCADE.detectMultiScale(gray, 1.1, 4, minSize=(min_size, min_size))
        if len(faces):
            x, y, fw, fh = max(faces, key=lambda f: f[2] * f[3])  # the largest face
            bboxes[i] = (x, y, x + fw, y + fh)
            detected[i] = 1.0
        elif heuristic_center:
            bboxes[i] = (0.2 * w, 0.2 * h, 0.8 * w, 0.8 * h)
            detected[i] = 1.0
        else:
            bboxes[i] = (0, 0, w, h)
    return bboxes, detected
