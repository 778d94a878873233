"""DINO ViT-S/16 image similarity.

Counterpart of `adaface_tpu/evaluation/dino_eval.py`: the class token of
`models.vit.ViT`, normalized, and the mean pairwise cosine of two image
sets. `dino_preprocess` resizes with `utils.image.resize_cubic`, the
port's OpenCV bicubic, where JAX calls `cv2.resize(INTER_CUBIC)`
(`dino_eval.py:22`), then ImageNet's mean and std. fp32 with TF32 off, as
`clip_eval`.
"""

from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import build
from adaface_tpu_torch.evaluation.clip_eval import normalized
from adaface_tpu_torch.models.vit import DINO_VITS16, ViT, ViTConfig, init_vit_weights_
from adaface_tpu_torch.utils.image import resize_cubic

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def dino_preprocess(images: Sequence[np.ndarray], size: int = 224) -> np.ndarray:
    """HWC uint8 RGB images → [B, 3, size, size] float32."""
    out = []
    for im in images:
        im = resize_cubic(np.asarray(im), (size, size)).astype(np.float32) / 255.0
        out.append(((im - IMAGENET_MEAN) / IMAGENET_STD).transpose(2, 0, 1))
    return np.stack(out)


class DINOEvaluator:
    """The ViT in fp32 on `device`: `model` as given (a tree of
    `convert_dino_state_dict` lands in one by `bridge.load(ViT(cfg),
    bridge.vit_tree(tree))`), else random from `generator` (seeded 0 on
    `device` when None)."""

    def __init__(self, device="cuda", generator: torch.Generator | None = None,
                 cfg: ViTConfig = DINO_VITS16, model: ViT | None = None):
        self.device = torch.device(device)
        if model is None:
            gen = generator if generator is not None else torch.Generator(
                self.device).manual_seed(0)
            model = build(lambda: ViT(cfg), self.device, torch.float32, init_vit_weights_, gen)
        self.model = model.to(self.device, torch.float32).eval()
        self.cfg = self.model.cfg

    def to(self, device) -> "DINOEvaluator":
        """The same evaluator, its weights copied to `device`."""
        return DINOEvaluator(device, model=copy.deepcopy(self.model))

    @torch.inference_mode()
    def image_features(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        px = torch.from_numpy(dino_preprocess(images, self.cfg.image_size)).to(self.device)
        with fp32_convolutions(matmuls=True):
            return normalized(self.model(px)["cls"])

    def img_to_img_similarity(self, images_a, images_b) -> float:
        with fp32_convolutions(matmuls=True):
            return float((self.image_features(images_a) @ self.image_features(images_b).T).mean())
