"""SubjBasisGenerator, face branch: image-prompt embeddings → ada embeddings.

Counterpart of the face path of `adaface_tpu/id2ada/subj_basis_generator.py`
(`inverse_img_prompt_embs` and `subj_basis_forward`, `:179-315`): the
N_ID image-prompt embeddings are spliced into the tokenised template
"photo of a , , …" at its filler positions, the prompt2token_proj CLIP-L
tower runs over it with learnable last-3-hidden-state weights, and the
N_ID output positions are the ada embeddings, optionally mixed toward the
all-pad prompt's embeddings (`out_id_embs_cfg_scale`). At inference the
gradient scaler on the layer weights is the identity.

The background (CLIP-feature) branch, the non-face DINO branch, static
image-suffix embeddings and the layerwise projection are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from adaface_tpu_torch.models.clip import (CLIP_L_TEXT, CLIPTextConfig, CLIPTextModel,
                                           init_text_weights_)
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer


@dataclasses.dataclass(frozen=True)
class SubjBasisConfig:
    num_id_vecs: int = 16  # arc2face 16
    max_prompt_length: int = 77
    clip: CLIPTextConfig = CLIP_L_TEXT


def _build_template(tokenizer: CLIPTokenizer, n_fillers: int,
                    max_length: int) -> tuple[np.ndarray, int]:
    """Tokenize 'photo of a ' + ', '*N; return (ids [S], first filler pos)."""
    ids = tokenizer(["photo of a " + ", " * n_fillers], max_length=max_length)[0]
    comma_id = tokenizer.encode_text(",")[0]
    first = int(np.argmax(ids == comma_id))
    if ids[first] != comma_id:
        raise ValueError("template tokenization has no filler token")
    return ids, first


class SubjBasisGenerator(nn.Module):
    """`clip` is the prompt2token_proj tower; its token and position tables
    are the frozen buffers of the JAX version."""

    def __init__(self, cfg: SubjBasisConfig, tokenizer: CLIPTokenizer):
        super().__init__()
        self.cfg = cfg
        self.clip = CLIPTextModel(cfg.clip)
        self.hidden_state_layer_weights = nn.Parameter(
            torch.tensor([[1.0], [2.0], [4.0]]))
        self.template_ids, self.id_start = _build_template(
            tokenizer, cfg.num_id_vecs + 2, cfg.max_prompt_length)
        self.pad_token_id = tokenizer.pad_token_id

    def pad_embeddings(self):
        """Token + position embeddings of an all-pad prompt [L, D]."""
        n = self.cfg.max_prompt_length
        return self.clip.token_embedding[self.pad_token_id] + self.clip.position_embedding[:n]

    def forward(self, face_prompt_embs, out_id_embs_cfg_scale: float = 1.0):
        """[B, N_ID, D] image-prompt embeddings → [B, N_ID, D] ada embeddings."""
        b = face_prompt_embs.shape[0]
        start, end = self.id_start, self.id_start + self.cfg.num_id_vecs
        ids = torch.as_tensor(self.template_ids, dtype=torch.long,
                              device=face_prompt_embs.device).expand(b, -1)
        token_embs = self.clip.token_embedding[ids]
        token_embs[:, start:end] = face_prompt_embs.to(token_embs.dtype)
        out = self.clip(ids, input_embs=token_embs,
                        skip_weights=self.hidden_state_layer_weights)
        ada = out[:, start:end]
        if out_id_embs_cfg_scale != 1.0:
            pad = self.pad_embeddings()[start:end].to(ada.dtype)
            ada = ada * out_id_embs_cfg_scale + pad[None] * (1.0 - out_id_embs_cfg_scale)
        return ada


def init_sbg_weights_(sbg: SubjBasisGenerator, gen: torch.Generator) -> None:
    """`init_subj_basis_generator` scales: a random CLIP-L tower and the
    hidden-state layer weights at their [1, 2, 4] start."""
    init_text_weights_(sbg.clip, gen)
    with torch.no_grad():
        sbg.hidden_state_layer_weights.copy_(torch.tensor([[1.0], [2.0], [4.0]]))
