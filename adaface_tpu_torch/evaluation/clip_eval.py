"""CLIP-T and CLIP-I on CLIP ViT-B/32.

Counterpart of `adaface_tpu/evaluation/clip_eval.py` (the reference's
`CLIPEvaluator`, HF CLIPModel ViT-B/32): CLIP-T, the mean cosine between
prompts and images, and CLIP-I, between two image sets, on the port's CLIP
towers: the text tower's pooled eos state through the evaluator's own
`text_projection` matrix (`clip_eval.py:49-52`, applied at `:58-59`), the
vision tower's `image_embeds` through its `visual_projection`. Images are
resized by the OpenCV-exact bicubic of `clip_preprocess`.

Everything runs in fp32 with TF32 off for convolutions and matmuls, so a
score on the card is the score on the CPU. Random weights come from an
explicit generator; `to(device)` gives the same evaluator elsewhere.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import numpy as np
import torch

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.core.params import build
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import clip_preprocess
from adaface_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                                           CLIPVisionModel, init_text_weights_,
                                           init_vision_weights_)
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer

# ViT-B/32 (the reference evaluator's backbone)
CLIP_B32_TEXT = CLIPTextConfig(hidden_size=512, num_layers=12, num_heads=8,
                               intermediate_size=2048)
CLIP_B32_VISION = CLIPVisionConfig(hidden_size=768, num_layers=12, num_heads=12,
                                   intermediate_size=3072, patch_size=32, projection_dim=512)


def normalized(f: torch.Tensor) -> torch.Tensor:
    return f / (f.norm(dim=-1, keepdim=True) + 1e-8)


class CLIPEvaluator:
    """The towers in fp32 on `device`: `text` / `vision` as given (a loaded
    tower is moved there), else random at the JAX init's scales from
    `generator` (seeded 0 on `device` when None), which then also draws
    `text_projection` N(0, 1/D) [D_text, D_proj] unless it is given."""

    def __init__(self, device="cuda", generator: torch.Generator | None = None,
                 text_cfg: CLIPTextConfig = CLIP_B32_TEXT,
                 vision_cfg: CLIPVisionConfig = CLIP_B32_VISION,
                 text: CLIPTextModel | None = None, vision: CLIPVisionModel | None = None,
                 text_projection=None, tokenizer: CLIPTokenizer | None = None):
        self.device = torch.device(device)
        gen = generator if generator is not None else torch.Generator(self.device).manual_seed(0)
        f32 = torch.float32
        self.text = (text.to(self.device, f32) if text is not None else
                     build(lambda: CLIPTextModel(text_cfg), self.device, f32, init_text_weights_,
                           gen))
        self.vision = (vision.to(self.device, f32) if vision is not None else
                       build(lambda: CLIPVisionModel(vision_cfg), self.device, f32,
                             init_vision_weights_, gen))
        if text_projection is None:
            d = self.text.cfg.hidden_size
            proj_dim = self.vision.cfg.projection_dim or self.vision.cfg.hidden_size
            text_projection = torch.randn((d, proj_dim), generator=gen,
                                          device=gen.device) / math.sqrt(d)
        if not isinstance(text_projection, torch.Tensor):
            text_projection = torch.from_numpy(np.array(text_projection, np.float32))
        self.text_projection = text_projection.to(self.device, f32)
        self.tokenizer = tokenizer or default_tokenizer()

    def to(self, device) -> "CLIPEvaluator":
        """The same evaluator, its weights copied to `device`."""
        return CLIPEvaluator(device, text=copy.deepcopy(self.text),
                             vision=copy.deepcopy(self.vision),
                             text_projection=self.text_projection.clone(),
                             tokenizer=self.tokenizer)

    @torch.inference_mode()
    def text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(self.tokenizer(list(prompts)), np.int64))
        with fp32_convolutions(matmuls=True):
            pooled = self.text(ids.to(self.device), return_pooled=True)["pooled"]
            return normalized(pooled @ self.text_projection)

    @torch.inference_mode()
    def image_features(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        px = torch.from_numpy(clip_preprocess(images)).to(self.device)
        with fp32_convolutions(matmuls=True):
            out = self.vision(px)
            return normalized(out.get("image_embeds", out["pooled"]))

    def txt_to_img_similarity(self, prompts, images) -> float:
        """CLIP-T: mean cosine between each prompt and each image."""
        with fp32_convolutions(matmuls=True):
            return float((self.text_features(prompts) @ self.image_features(images).T).mean())

    def img_to_img_similarity(self, images_a, images_b) -> float:
        """CLIP-I: mean pairwise cosine between two image sets."""
        with fp32_convolutions(matmuls=True):
            return float((self.image_features(images_a) @ self.image_features(images_b).T).mean())
