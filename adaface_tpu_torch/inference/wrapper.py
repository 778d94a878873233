"""AdaFaceWrapper — the user entry point, personalized text→image.

Counterpart of the "text2img" path of `adaface_tpu/inference/wrapper.py`:
placeholder tokens `z_0_0 … z_0_15` extend the tokenizer and the CLIP-L
token table (`:116-131`), a subject's ada embeddings are written into those
rows (`:133-144`), prompts get the placeholder string appended
(`:146-152`), and `forward` runs the CFG DDIM pipeline (`:233-299`).

The other pipelines (img2img, video, SDXL, SD3), the continuous batcher,
LoRA loading and int8 serving are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from adaface_tpu_torch.inference.pipeline import DiffusionPipeline, PipelineModules
from adaface_tpu_torch.models.clip import extend_position_embedding
from adaface_tpu_torch.text.embedding_manager import extend_token_embedding

DEFAULT_NEGATIVE_PROMPT = ("flaws in the eyes, flaws in the face, lowres, "
                           "non-HDRi, low quality")


class AdaFaceWrapper:
    def __init__(self, pipeline_name: str, modules: PipelineModules,
                 id2ada_prompt_encoder, guidance_scale: float = 6.0,
                 num_inference_steps: int = 50,
                 out_id_embs_cfg_scale: float | None = None,
                 dtype=torch.bfloat16, max_prompt_length: int = 77):
        if pipeline_name != "text2img":
            raise NotImplementedError(
                f"pipeline {pipeline_name!r} is not ported; the PyTorch port "
                "serves 'text2img'")
        self.pipeline = DiffusionPipeline(modules, dtype=dtype)
        self.id2ada_prompt_encoder = id2ada_prompt_encoder
        self.guidance_scale = guidance_scale
        self.num_inference_steps = num_inference_steps
        if out_id_embs_cfg_scale is not None:
            id2ada_prompt_encoder.out_id_embs_cfg_scale = out_id_embs_cfg_scale
        if max_prompt_length > 77:
            # 97/147-token prompts reuse the trailing position embeddings
            extend_position_embedding(modules.text_encoder, max_prompt_length)
        self.placeholder_tokens: list[list[str]] = []
        self.placeholder_token_ids: list[list[int]] = []
        self.extend_tokenizer_and_text_encoder()

    def extend_tokenizer_and_text_encoder(self):
        """Add `z_{i}_{j}` placeholder tokens per encoder (one, Arc2Face, in
        the port) and grow the token table to the tokenizer's vocabulary."""
        tok = self.pipeline.m.tokenizer
        for i, enc in enumerate([self.id2ada_prompt_encoder]):
            names = [f"z_{i}_{j}" for j in range(enc.num_id_vecs)]
            self.placeholder_tokens.append(names)
            self.placeholder_token_ids.append(tok.add_tokens(names))
        te = self.pipeline.m.text_encoder
        need = tok.vocab_size - te.token_embedding.shape[0]
        if need > 0:
            with torch.no_grad():
                grown = extend_token_embedding(te.token_embedding, need)
            te.token_embedding = nn.Parameter(grown, requires_grad=False)

    def update_text_encoder_subj_embeddings(self, ada_embs: torch.Tensor):
        """Write ada embeddings [sum_K, D] into the placeholder rows, in place."""
        table = self.pipeline.m.text_encoder.token_embedding
        offset = 0
        with torch.no_grad():
            for ids in self.placeholder_token_ids:
                rows = torch.as_tensor(ids, dtype=torch.long, device=table.device)
                table[rows] = ada_embs[offset:offset + len(ids)].to(table.device, table.dtype)
                offset += len(ids)

    def update_prompt(self, prompt: str) -> str:
        """Append the placeholder strings unless already present."""
        ph = " ".join(" ".join(names) for names in self.placeholder_tokens)
        if ph and ph not in prompt:
            prompt = f"{prompt} {ph}" if prompt else ph
        return prompt

    def prepare_adaface_embeddings(self, images: Sequence[np.ndarray] | None = None,
                                   face_id_embs=None, avg_at_stage: str = "id_emb"):
        """Face images (or ID embeddings) → ada embeddings [N_ID, D], written
        into the text encoder's placeholder rows; None without a face."""
        ada, _, _ = self.id2ada_prompt_encoder.generate_adaface_embeddings(
            images=images, face_id_embs=face_id_embs, avg_at_stage=avg_at_stage)
        if ada is not None:
            self.update_text_encoder_subj_embeddings(ada)
        return ada

    def __call__(self, *a, **kw):
        return self.forward(*a, **kw)

    def forward(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
                num_images: int = 1, guidance_scale: float | None = None,
                num_inference_steps: int | None = None,
                generator: torch.Generator | None = None,
                height: int = 512, width: int = 512):
        """→ images [N, 3, H, W] float32 in [0, 1]; the placeholder string is
        appended to the prompt."""
        return self.pipeline(
            [self.update_prompt(prompt)] * num_images, negative_prompt=negative_prompt,
            num_inference_steps=(num_inference_steps if num_inference_steps is not None
                                 else self.num_inference_steps),
            guidance_scale=guidance_scale if guidance_scale is not None else self.guidance_scale,
            generator=generator, height=height, width=width)
