"""Face images or ID embeddings → ada text-token embeddings.

Counterpart of `adaface_tpu/id2ada/face_id_to_ada_prompt.py`:
1. `extract_init_id_embeds_from_images`: a face backend turns each image
   into a 512-d ID embedding (an image without a face is skipped, or given
   a seeded random one); encoders that read CLIP features also get the
   masked fg and bg CLIP-vision features of the images, token-wise
   [B, 2·257, D_clip];
2. `map_init_id_to_img_prompt_embs`, per encoder:
   - Arc2Face: the zero-padded ID embedding replaces the `id` token of
     "photo of a id person" in Arc2Face's CLIP-L text tower, and the 16
     outputs from that position on are kept (`:356-375`);
   - ConsistentID: the fg half of the CLIP-H features are the queries of
     `ProjPlus` with the ID embedding; 4 tokens, and negative image prompts
     from a zero ID and the black image's features (`:378-419`);
3. `generate_adaface_embeddings`: averaging (`id_emb`, `img_prompt_emb` or
   none), perturbation, the random-ID path, and the SubjBasisGenerator with
   the encoder's `out_id_embs_cfg_scale`.
`JointFaceID2AdaPrompt` concatenates Arc2Face's and ConsistentID's ada
embeddings (16 + 4 = 20), with per-encoder dropout in training and zeros
for a dropped encoder (`:422-556`).

Arc2Face's JAX version also computes CLIP-L vision features, but its
mapping never reads them (`:176-179`, `:356-375`), so the port leaves that
pass out; the ada embeddings are the same. Random draws go through
`utils.tensor.Draws`: a torch.Generator, or JAX's draws handed in.
Encoders work in float32 on the device of their modules, whatever the dtype
of the diffusion pipeline, as the JAX encoders do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend, FaceBackend
from adaface_tpu_torch.id2ada.layers import ProjPlus
from adaface_tpu_torch.id2ada.subj_basis_generator import (SubjBasisConfig,
                                                           SubjBasisGenerator,
                                                           init_sbg_weights_)
from adaface_tpu_torch.models.clip import (CLIP_H_VISION, CLIP_L_TEXT, CLIPTextConfig,
                                           CLIPTextModel, CLIPVisionConfig, CLIPVisionModel,
                                           init_text_weights_, init_vision_weights_,
                                           token_embeddings)
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer, default_tokenizer
from adaface_tpu_torch.utils.image import resize_cubic
from adaface_tpu_torch.utils.tensor import as_draws, perturb_tensor

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# fg ‖ bg tokens of a 224² image at patch 14: the random-ID path's CLIP
# features have this many, as in the JAX package, whatever the tower
RANDOM_CLIP_TOKENS = 514


def clip_preprocess(images: Sequence[np.ndarray], size: int = 224) -> np.ndarray:
    """HWC uint8 RGB images → [B, 3, size, size] normalized float32: an
    OpenCV-exact bicubic resize to uint8 (`utils/image.py`), then CLIP's
    mean and std."""
    out = []
    for im in images:
        im = resize_cubic(np.asarray(im), (size, size)).astype(np.float32) / 255.0
        out.append(((im - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1))
    return np.stack(out)


class FaceID2AdaPrompt:
    """Shared pipeline; subclasses map ID embeddings (and CLIP features) to
    image prompts. `clip_vision` is the encoder's CLIP-vision tower, None
    where its mapping reads no CLIP features."""

    num_id_vecs = 16
    gen_neg_img_prompt = False
    use_clip_embs = False
    default_enable_static_img_suffix_embs = False

    def __init__(self, subj_basis_generator: SubjBasisGenerator,
                 face_backend: FaceBackend | None = None,
                 out_id_embs_cfg_scale: float = -1.0,
                 clip_vision: CLIPVisionModel | None = None):
        self.subj_basis_generator = subj_basis_generator
        self.sbg_cfg = subj_basis_generator.cfg
        self.num_static_img_suffix_embs = self.sbg_cfg.num_static_img_suffix_embs
        self.face_backend = face_backend or DeterministicBackend()
        self.out_id_embs_cfg_scale = out_id_embs_cfg_scale
        self.clip_vision = clip_vision
        self.clip_embedding_dim = None if clip_vision is None else clip_vision.cfg.hidden_size
        self.device = next(subj_basis_generator.parameters()).device
        self._neg_clip_features = None

    def map_init_id_to_img_prompt_embs(self, faceid_embs, clip_features=None,
                                       called_for_neg_img_prompt: bool = False):
        raise NotImplementedError

    def _clip_fgbg_features(self, images: Sequence[np.ndarray], fg_masks=None):
        """Masked fg and inverse-masked bg CLIP features, token-wise
        [B, 2·S, D_clip]; the two passes as one batch of 2B."""
        px = torch.from_numpy(clip_preprocess(images)).to(self.device)
        if fg_masks is not None:
            fg = torch.as_tensor(np.stack(fg_masks), dtype=torch.float32,
                                 device=self.device)[:, None]
        else:
            fg = torch.ones((px.shape[0], 1, 224, 224), device=self.device)
        out = self.clip_vision(torch.cat([px, px]), image_mask=torch.cat([fg, 1.0 - fg]))
        fg_out, bg_out = out["last_hidden_state"].chunk(2)
        return torch.cat([fg_out, bg_out], dim=1)

    def get_clip_neg_features(self, batch_size: int):
        """The black image's CLIP features, computed once, [B, S, D_clip]."""
        if self._neg_clip_features is None:
            px = torch.from_numpy(clip_preprocess([np.zeros((224, 224, 3), np.uint8)]))
            self._neg_clip_features = self.clip_vision(px.to(self.device))["last_hidden_state"]
        f = self._neg_clip_features
        return f.expand(batch_size, *f.shape[1:])

    def extract_init_id_embeds_from_images(self, images: Sequence[np.ndarray], fg_masks=None,
                                           calc_avg: bool = False,
                                           skip_non_faces: bool = True,
                                           return_clip_embs: bool | None = None):
        """→ (faceless_count, id_embs [B, 512] | None, CLIP features | None);
        without `skip_non_faces` an image with no face gets a random unit
        embedding from numpy's RandomState(0), as the JAX package does."""
        if return_clip_embs is None:
            return_clip_embs = self.use_clip_embs
        embs, kept, faceless = [], [], 0
        rs = np.random.RandomState(0)
        for i, im in enumerate(images):
            e = self.face_backend.detect_and_embed(im)
            if e is None:
                faceless += 1
                if skip_non_faces:
                    continue
                e = rs.randn(512).astype(np.float32)
                e /= np.linalg.norm(e)
            embs.append(e)
            kept.append(i)
        if not embs:
            return faceless, None, None
        id_embs = torch.as_tensor(np.stack(embs), device=self.device)
        clip_feats = None
        if return_clip_embs:
            clip_feats = self._clip_fgbg_features(
                [images[i] for i in kept],
                None if fg_masks is None else [fg_masks[i] for i in kept])
        if calc_avg:
            id_embs = id_embs.mean(dim=0, keepdim=True)
            id_embs = id_embs / (id_embs.norm(dim=-1, keepdim=True) + 1e-8)
            if clip_feats is not None:
                clip_feats = clip_feats.mean(dim=0, keepdim=True)
        return faceless, id_embs, clip_feats

    def get_img_prompt_embs(self, init_id_embs=None, pre_clip_features=None, images=None,
                            fg_masks=None, id_batch_size: int = 1,
                            skip_non_faces: bool = True, avg_at_stage: str | None = None,
                            perturb_at_stage: str | None = None, perturb_std: float = 0.0,
                            rng=None):
        """→ (face_image_count, faceid_embs, pos_prompt_embs, neg_prompt_embs),
        all None but the count without a face. Draws, in order: the
        random-ID path's ID embeddings [B, 512] and CLIP features
        [B, 514, D_clip]; the perturbation of the ID embeddings, of the CLIP
        features, then of the image prompts."""
        draws = as_draws(rng, self.device)
        face_image_count = 0
        if init_id_embs is None:
            if images is None:  # the random-ID path
                faceid = draws.normal((id_batch_size, 512), self.device)
                clip_feats = (draws.normal((id_batch_size, RANDOM_CLIP_TOKENS,
                                            self.clip_embedding_dim), self.device)
                              if self.use_clip_embs else None)
            else:
                faceless, faceid, clip_feats = self.extract_init_id_embeds_from_images(
                    images, fg_masks=fg_masks, calc_avg=avg_at_stage == "id_emb",
                    skip_non_faces=skip_non_faces)
                face_image_count = len(images) - faceless
                if faceid is None:
                    return 0, None, None, None
        else:
            faceid = torch.as_tensor(init_id_embs, dtype=torch.float32, device=self.device)
            clip_feats = (None if pre_clip_features is None else
                          torch.as_tensor(pre_clip_features, dtype=torch.float32,
                                          device=self.device))
            if faceid.shape[0] == 1 and id_batch_size > 1:
                faceid = faceid.repeat_interleave(id_batch_size, dim=0)
                if clip_feats is not None:
                    clip_feats = clip_feats.repeat_interleave(id_batch_size, dim=0)

        if perturb_at_stage == "id_emb" and perturb_std > 0:
            faceid = perturb_tensor(faceid, perturb_std, draws.normal(faceid.shape, self.device),
                                    keep_norm=True)
            if clip_feats is not None and self.use_clip_embs:
                clip_feats = perturb_tensor(clip_feats, perturb_std,
                                            draws.normal(clip_feats.shape, self.device),
                                            keep_norm=True)

        faceid = faceid / (faceid.norm(dim=-1, keepdim=True) + 1e-8)
        pos = self.map_init_id_to_img_prompt_embs(faceid, clip_feats)
        if avg_at_stage == "img_prompt_emb":
            pos = pos.mean(dim=0, keepdim=True)
            faceid = faceid.mean(dim=0, keepdim=True)
        if perturb_at_stage == "img_prompt_emb" and perturb_std > 0:
            pos = perturb_tensor(pos, perturb_std, draws.normal(pos.shape, self.device),
                                 keep_norm=True)
        if images is not None and avg_at_stage is not None:
            faceid = faceid.repeat_interleave(id_batch_size, dim=0)
            pos = pos.repeat_interleave(id_batch_size, dim=0)

        neg = None
        if self.gen_neg_img_prompt:
            neg = self.map_init_id_to_img_prompt_embs(
                torch.zeros_like(faceid), self.get_clip_neg_features(pos.shape[0]),
                called_for_neg_img_prompt=True)
        return face_image_count, faceid, pos, neg

    def get_batched_img_prompt_embs(self, batch_size: int, init_id_embs, pre_clip_features,
                                    rng=None):
        return self.get_img_prompt_embs(
            init_id_embs=init_id_embs, pre_clip_features=pre_clip_features,
            id_batch_size=batch_size, skip_non_faces=False, avg_at_stage=None, rng=rng)

    @torch.inference_mode()
    def generate_adaface_embeddings(self, images: Sequence[np.ndarray] | None = None,
                                    face_id_embs=None, img_prompt_embs=None, fg_masks=None,
                                    avg_at_stage: str | None = "id_emb",
                                    perturb_at_stage: str | None = None,
                                    perturb_std: float = 0.0,
                                    enable_static_img_suffix_embs: bool | None = None,
                                    rng=None):
        """→ (ada_embs, img_prompt_embs, lens_subj_emb_segments); ada_embs is
        [N, D] when averaging, [B, N, D] otherwise, None without a face."""
        if enable_static_img_suffix_embs is None:
            enable_static_img_suffix_embs = self.default_enable_static_img_suffix_embs
        lens = [self.num_id_vecs
                + int(enable_static_img_suffix_embs) * self.num_static_img_suffix_embs]
        if avg_at_stage is not None and avg_at_stage.lower() == "none":
            avg_at_stage = None
        if img_prompt_embs is None:
            bs = 1 if avg_at_stage is not None else (
                len(face_id_embs) if face_id_embs is not None
                else (len(images) if images is not None else 1))
            _, _, img_prompt_embs, _ = self.get_img_prompt_embs(
                init_id_embs=face_id_embs, images=images, fg_masks=fg_masks,
                id_batch_size=bs, avg_at_stage=avg_at_stage,
                perturb_at_stage=perturb_at_stage, perturb_std=perturb_std, rng=rng)
            if img_prompt_embs is None:
                return None, None, lens
        else:
            img_prompt_embs = torch.as_tensor(img_prompt_embs, dtype=torch.float32,
                                              device=self.device)
            if avg_at_stage is not None:
                img_prompt_embs = img_prompt_embs.mean(dim=0, keepdim=True)
        ada = self.subj_basis_generator(
            img_prompt_embs, out_id_embs_cfg_scale=self.out_id_embs_cfg_scale,
            enable_static_img_suffix_embs=enable_static_img_suffix_embs)
        if avg_at_stage is not None:
            ada = ada[0]
        return ada, img_prompt_embs, lens


class Arc2FaceID2AdaPrompt(FaceID2AdaPrompt):
    name = "arc2face"
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

    def map_init_id_to_img_prompt_embs(self, faceid_embs, clip_features=None,
                                       called_for_neg_img_prompt: bool = False):
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


class ConsistentIDID2AdaPrompt(FaceID2AdaPrompt):
    name = "consistentID"
    num_id_vecs = 4
    use_clip_embs = True
    gen_neg_img_prompt = True

    def __init__(self, clip_vision: CLIPVisionModel, image_proj: ProjPlus,
                 subj_basis_generator: SubjBasisGenerator,
                 face_backend: FaceBackend | None = None,
                 out_id_embs_cfg_scale: float = -1.0):
        super().__init__(subj_basis_generator, face_backend, out_id_embs_cfg_scale,
                         clip_vision=clip_vision)
        if self.out_id_embs_cfg_scale == -1:
            self.out_id_embs_cfg_scale = 6.0
        self.image_proj = image_proj

    @classmethod
    def random_init(cls, gen: torch.Generator, tokenizer: CLIPTokenizer, device,
                    vision_cfg: CLIPVisionConfig = CLIP_H_VISION,
                    sbg_cfg: SubjBasisConfig = SubjBasisConfig(num_id_vecs=4),
                    proj_depth: int = 4, **kw):
        """Random float32 towers from `gen`, built on `device`: CLIP-H/14
        vision, ProjPlus (depth 4, 12 heads of 64 at 768), the generator."""
        vision = build(lambda: CLIPVisionModel(vision_cfg), device, torch.float32,
                       init_vision_weights_, gen)
        proj = build(lambda: ProjPlus(clip_dim=vision_cfg.hidden_size, out_dim=sbg_cfg.out_dim,
                                      num_tokens=cls.num_id_vecs, depth=proj_depth),
                     device, torch.float32, init_fan_in_, gen)
        sbg = build(lambda: SubjBasisGenerator(sbg_cfg, tokenizer), device, torch.float32,
                    init_sbg_weights_, gen)
        return cls(vision, proj, sbg, **kw)

    def map_init_id_to_img_prompt_embs(self, faceid_embs, clip_features=None,
                                       called_for_neg_img_prompt: bool = False):
        if clip_features is None:
            raise ValueError("ConsistentID maps an ID embedding with CLIP features")
        if called_for_neg_img_prompt:
            clip_embs, faceid_embs = clip_features, torch.zeros_like(faceid_embs)
        else:  # [B, 2·S, D] = fg ‖ bg token-wise; only fg is read
            clip_embs = clip_features[:, :clip_features.shape[1] // 2]
        return self.image_proj(faceid_embs, clip_embs)


class JointFaceID2AdaPrompt:
    """Arc2Face's and ConsistentID's ada embeddings concatenated (16 + 4 =
    20), per-encoder dropout in training, zeros for a dropped encoder."""

    name = "jointIDs"

    def __init__(self, encoders: Sequence[FaceID2AdaPrompt], p_dropout=(0.1, 0.1),
                 is_training: bool = False):
        self.encoders = list(encoders)
        self.p_dropout = p_dropout
        self.is_training = is_training
        self.num_id_vecs = sum(e.num_id_vecs for e in self.encoders)
        self.num_static_img_suffix_embs = sum(e.num_static_img_suffix_embs
                                              for e in self.encoders)
        self.device = self.encoders[0].device

    @classmethod
    def random_init(cls, gen: torch.Generator, tokenizer: CLIPTokenizer, device,
                    face_backend: FaceBackend | None = None,
                    out_id_embs_cfg_scales=(1.0, 6.0), p_dropout=(0.1, 0.1),
                    is_training: bool = False, arc2face_kw=None, consistentid_kw=None):
        """Arc2Face, then ConsistentID, from `gen` on `device`, one face
        backend for both."""
        a = Arc2FaceID2AdaPrompt.random_init(
            gen, tokenizer, device, face_backend=face_backend,
            out_id_embs_cfg_scale=out_id_embs_cfg_scales[0], **(arc2face_kw or {}))
        c = ConsistentIDID2AdaPrompt.random_init(
            gen, tokenizer, device, face_backend=face_backend,
            out_id_embs_cfg_scale=out_id_embs_cfg_scales[1], **(consistentid_kw or {}))
        return cls([a, c], p_dropout=p_dropout, is_training=is_training)

    def extract_init_id_embeds_from_images(self, images, fg_masks=None, calc_avg=False,
                                           skip_non_faces=True):
        """Each encoder's (id_embs, CLIP features), as lists."""
        results = [e.extract_init_id_embeds_from_images(
            images, fg_masks=fg_masks, calc_avg=calc_avg, skip_non_faces=skip_non_faces)
            for e in self.encoders]
        faceless = max(r[0] for r in results)
        id_embs, clip_feats = [r[1] for r in results], [r[2] for r in results]
        if any(e is None for e in id_embs):
            return faceless, None, None
        return faceless, id_embs, clip_feats

    def get_img_prompt_embs(self, init_id_embs=None, pre_clip_features=None, images=None,
                            fg_masks=None, id_batch_size: int = 1, skip_non_faces: bool = True,
                            avg_at_stage=None, perturb_at_stage=None, perturb_std=0.0,
                            rng=None):
        """Each encoder's image prompts concatenated along the tokens,
        [B, 16 + 4, D]; init_id_embs / pre_clip_features are per-encoder
        lists, or one value for both. A missing negative prompt is zeros."""
        draws = as_draws(rng, self.device)
        pos, neg, count = [], [], 0
        for i, enc in enumerate(self.encoders):
            pick = lambda v: v[i] if isinstance(v, (list, tuple)) else v
            c, _, p, n = enc.get_img_prompt_embs(
                init_id_embs=pick(init_id_embs), pre_clip_features=pick(pre_clip_features),
                images=images, fg_masks=fg_masks, id_batch_size=id_batch_size,
                skip_non_faces=skip_non_faces, avg_at_stage=avg_at_stage,
                perturb_at_stage=perturb_at_stage, perturb_std=perturb_std, rng=draws)
            if p is None:
                return 0, None, None, None
            count = max(count, c)
            pos.append(p)
            neg.append(n if n is not None else torch.zeros_like(p))
        return count, init_id_embs, torch.cat(pos, dim=1), torch.cat(neg, dim=1)

    def get_batched_img_prompt_embs(self, batch_size: int, init_id_embs, pre_clip_features,
                                    rng=None):
        return self.get_img_prompt_embs(
            init_id_embs=init_id_embs, pre_clip_features=pre_clip_features,
            id_batch_size=batch_size, skip_non_faces=False, avg_at_stage=None, rng=rng)

    @torch.inference_mode()
    def generate_adaface_embeddings(self, images=None, face_id_embs=None, img_prompt_embs=None,
                                    fg_masks=None, p_dropout: float | None = None,
                                    return_zero_embs_for_dropped_encoders: bool = True,
                                    avg_at_stage="id_emb", perturb_at_stage=None,
                                    perturb_std=0.0, enable_static_img_suffix_embs=None,
                                    rng=None):
        """→ (ada [20, D] or [B, N, D], each encoder's image prompts, lens).
        Draws, in order: one uniform per encoder whose dropout is above 0,
        one more if all were dropped (which one comes back), then each kept
        encoder's own."""
        draws = as_draws(rng, self.device)
        drop = []
        for i in range(len(self.encoders)):
            p = (p_dropout if p_dropout is not None
                 else (self.p_dropout[i] if self.is_training else 0.0))
            drop.append(p > 0 and draws.uniform() < p)
        if all(drop):  # never drop every encoder
            drop[int(draws.uniform() < 0.5)] = False

        ada_list, img_list, lens = [], [], []
        for i, enc in enumerate(self.encoders):
            if drop[i]:
                if return_zero_embs_for_dropped_encoders:
                    n = enc.num_id_vecs
                    ada_list.append(torch.zeros((n, enc.sbg_cfg.out_dim), device=self.device)
                                    if avg_at_stage is not None else None)
                    lens.append(n)
                continue
            pick = lambda v: v[i] if isinstance(v, (list, tuple)) else None
            ada, imgp, n = enc.generate_adaface_embeddings(
                images=images,
                face_id_embs=(face_id_embs[i] if isinstance(face_id_embs, (list, tuple))
                              else face_id_embs),
                img_prompt_embs=pick(img_prompt_embs), fg_masks=fg_masks,
                avg_at_stage=avg_at_stage, perturb_at_stage=perturb_at_stage,
                perturb_std=perturb_std,
                enable_static_img_suffix_embs=enable_static_img_suffix_embs, rng=draws)
            if ada is None:
                return None, None, lens
            ada_list.append(ada)
            img_list.append(imgp)
            lens.extend(n)
        ada = torch.cat([a for a in ada_list if a is not None],
                        dim=0 if avg_at_stage is not None else 1)
        return ada, img_list, lens


def create_id2ada_prompt_encoder(name: str, gen: torch.Generator | None = None,
                                 tokenizer: CLIPTokenizer | None = None, device="cuda", **kw):
    """An encoder by name (`arc2face`, `consistentID`, `jointIDs` / `joint`)
    with random float32 weights from `gen` (seed 0 if None) on `device`."""
    classes = {"arc2face": Arc2FaceID2AdaPrompt, "consistentID": ConsistentIDID2AdaPrompt,
               "jointIDs": JointFaceID2AdaPrompt, "joint": JointFaceID2AdaPrompt}
    if name not in classes:
        raise ValueError(f"unknown id2ada encoder '{name}'")
    gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
    return classes[name].random_init(gen, tokenizer or default_tokenizer(), device, **kw)
