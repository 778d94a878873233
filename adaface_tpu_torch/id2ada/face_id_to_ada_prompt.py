"""Face images or ID embeddings → ada text-token embeddings (Arc2Face).

Counterpart of `FaceID2AdaPrompt` and `Arc2FaceID2AdaPrompt` in
`adaface_tpu/id2ada/face_id_to_ada_prompt.py`:
1. a host face backend turns each image into a 512-d ID embedding
   (averaged over a subject's images, `avg_at_stage="id_emb"`);
2. Arc2Face's CLIP-L text encoder maps it to 16 image-prompt embeddings:
   the zero-padded ID embedding replaces the `id` token of "photo of a id
   person", and the 16 outputs from that position on are kept (`:356-375`);
3. the SubjBasisGenerator turns those into the ada embeddings.

Arc2Face's JAX version also computes CLIP-vision fg/bg features of the
images, but its mapping never reads them (`:176-179`, `:356-375`), so the
port leaves the vision tower out; the ada embeddings are the same. Not
ported: perturbation, the random-ID path, ConsistentID and the joint
encoder.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch.core.params import build
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend, FaceBackend
from adaface_tpu_torch.id2ada.subj_basis_generator import (SubjBasisConfig,
                                                           SubjBasisGenerator,
                                                           init_sbg_weights_)
from adaface_tpu_torch.models.clip import (CLIP_L_TEXT, CLIPTextConfig, CLIPTextModel,
                                           init_text_weights_, token_embeddings)
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer


class FaceID2AdaPrompt:
    """Shared pipeline; subclasses map ID embeddings to image prompts.

    Works in float32 on the device of its modules, whatever the dtype of the
    diffusion pipeline, as the JAX encoders do.
    """

    num_id_vecs = 16

    def __init__(self, subj_basis_generator: SubjBasisGenerator,
                 face_backend: FaceBackend | None = None,
                 out_id_embs_cfg_scale: float = -1.0):
        self.subj_basis_generator = subj_basis_generator
        self.face_backend = face_backend or DeterministicBackend()
        self.out_id_embs_cfg_scale = out_id_embs_cfg_scale
        self.device = subj_basis_generator.clip.token_embedding.device

    def map_init_id_to_img_prompt_embs(self, faceid_embs):
        raise NotImplementedError

    def extract_init_id_embeds_from_images(self, images: Sequence[np.ndarray],
                                           calc_avg: bool = False):
        """→ (faceless_count, id_embs [B, 512] | None); images without a
        detected face are skipped."""
        embs, faceless = [], 0
        for im in images:
            e = self.face_backend.detect_and_embed(im)
            if e is None:
                faceless += 1
                continue
            embs.append(e)
        if not embs:
            return faceless, None
        id_embs = torch.as_tensor(np.stack(embs), device=self.device)
        if calc_avg:
            id_embs = id_embs.mean(dim=0, keepdim=True)
            id_embs = id_embs / (id_embs.norm(dim=-1, keepdim=True) + 1e-8)
        return faceless, id_embs

    def get_img_prompt_embs(self, init_id_embs=None, images=None,
                            avg_at_stage: str | None = None):
        """→ image-prompt embeddings [B, N_ID, D], or None without a face."""
        if init_id_embs is None:
            if images is None:
                raise ValueError("pass images or face_id_embs: the random-ID "
                                 "path is not ported")
            _, faceid = self.extract_init_id_embeds_from_images(
                images, calc_avg=avg_at_stage == "id_emb")
            if faceid is None:
                return None
        else:
            faceid = torch.as_tensor(init_id_embs, dtype=torch.float32, device=self.device)
        faceid = faceid / (faceid.norm(dim=-1, keepdim=True) + 1e-8)
        pos = self.map_init_id_to_img_prompt_embs(faceid)
        if avg_at_stage == "img_prompt_emb":
            pos = pos.mean(dim=0, keepdim=True)
        return pos

    @torch.inference_mode()
    def generate_adaface_embeddings(self, images: Sequence[np.ndarray] | None = None,
                                    face_id_embs=None,
                                    avg_at_stage: str | None = "id_emb"):
        """→ (ada_embs, img_prompt_embs, lens_subj_emb_segments); ada_embs is
        [N_ID, D] when averaging, [B, N_ID, D] otherwise, None without a face."""
        lens = [self.num_id_vecs]
        if avg_at_stage is not None and avg_at_stage.lower() == "none":
            avg_at_stage = None
        pos = self.get_img_prompt_embs(face_id_embs, images, avg_at_stage)
        if pos is None:
            return None, None, lens
        ada = self.subj_basis_generator(pos, out_id_embs_cfg_scale=self.out_id_embs_cfg_scale)
        if avg_at_stage is not None:
            ada = ada[0]
        return ada, pos, lens


class Arc2FaceID2AdaPrompt(FaceID2AdaPrompt):
    id_img_prompt_max_length = 22

    def __init__(self, text_encoder: CLIPTextModel, subj_basis_generator: SubjBasisGenerator,
                 tokenizer: CLIPTokenizer, face_backend: FaceBackend | None = None,
                 out_id_embs_cfg_scale: float = -1.0):
        super().__init__(subj_basis_generator, face_backend, out_id_embs_cfg_scale)
        if self.out_id_embs_cfg_scale == -1:
            self.out_id_embs_cfg_scale = 1.0
        self.text_encoder = text_encoder  # Arc2Face-finetuned CLIP-L text tower
        # "photo of a id person" padded to 22 tokens with the real vocab; a
        # fallback vocab puts `id` later, so leave room for the 16 slices
        probe = tokenizer(["photo of a id person"], max_length=77)[0]
        self._id_pos = int(np.where(probe == tokenizer.encode_text("id")[0])[0][0])
        max_len = max(self.id_img_prompt_max_length, self._id_pos + 16 + 2)
        self._template_ids = tokenizer(["photo of a id person"], max_length=max_len)[0]

    @classmethod
    def random_init(cls, gen: torch.Generator, tokenizer: CLIPTokenizer, device,
                    text_cfg: CLIPTextConfig = CLIP_L_TEXT,
                    sbg_cfg: SubjBasisConfig = SubjBasisConfig(), **kw):
        """Random float32 towers from `gen`, built on `device`."""
        te = build(lambda: CLIPTextModel(text_cfg), device, torch.float32,
                   init_text_weights_, gen)
        sbg = build(lambda: SubjBasisGenerator(sbg_cfg, tokenizer), device, torch.float32,
                    init_sbg_weights_, gen)
        return cls(te, sbg, tokenizer, **kw)

    def map_init_id_to_img_prompt_embs(self, faceid_embs):
        b = faceid_embs.shape[0]
        d = self.text_encoder.cfg.hidden_size
        ids = torch.as_tensor(self._template_ids, dtype=torch.long,
                              device=faceid_embs.device).expand(b, -1)
        if d >= faceid_embs.shape[-1]:
            face_padded = F.pad(faceid_embs, (0, d - faceid_embs.shape[-1]))
        else:  # toy configs with hidden < 512
            face_padded = faceid_embs[:, :d]
        token_embs = token_embeddings(self.text_encoder, ids)
        token_embs[:, self._id_pos] = face_padded.to(token_embs.dtype)
        out = self.text_encoder(ids, input_embs=token_embs)
        return out[:, self._id_pos:self._id_pos + 16]
