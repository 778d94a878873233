"""AdaFaceWrapper — the user entry point, personalized text→image and
image→image on SD1.5.

Counterpart of the "text2img" and "img2img" paths of
`adaface_tpu/inference/wrapper.py`: placeholder tokens `z_{i}_{j}`, one
run for each encoder (`z_0_0 … z_0_15` for Arc2Face; then `z_1_0 … z_1_3`
for ConsistentID under the joint encoder), extend the tokenizer and the
CLIP-L token table (`:112-131`), a subject's ada embeddings are written into
those rows, split by encoder (`:133-144`), or carried by a request of the
continuous batcher (`make_batcher`, `make_request`, `:176-201`), prompts get
the placeholder string appended (`:146-152`), and `forward` runs the
pipeline with the chosen scheduler (`:233-299`), for "img2img" from the
noised latents of an initial image (`:301-313`). `load_adaface_ckpt` reads
a trained checkpoint's SubjBasisGenerators (MKV-extended ones too);
`load_unet_lora_weights`
(`:203-221`) reads the UNet's trained DoRA adapters from a checkpoint of the
port's trainer; the pipeline and the batcher run with them.
`quantize_unet=True` serves int8 PTQ UNets (`:56`, `:92`): the pipeline and
every batcher `make_batcher` builds run the quantized UNet.

The other pipelines (video, SDXL, SD3) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from adaface_tpu_torch.inference.pipeline import DiffusionPipeline, PipelineModules
from adaface_tpu_torch.inference.serving import ContinuousBatcher, Request
from adaface_tpu_torch.models.clip import extend_position_embedding
from adaface_tpu_torch.models.unet import AttnLoRA, FFNLoRA
from adaface_tpu_torch.models.vae import vae_encode
from adaface_tpu_torch.text.embedding_manager import extend_token_embedding

SUPPORTED_PIPELINES = ("text2img", "img2img")
DEFAULT_NEGATIVE_PROMPT = ("flaws in the eyes, flaws in the face, lowres, "
                           "non-HDRi, low quality")


class AdaFaceWrapper:
    def __init__(self, pipeline_name: str, modules: PipelineModules,
                 id2ada_prompt_encoder, guidance_scale: float = 6.0,
                 num_inference_steps: int = 50,
                 out_id_embs_cfg_scale: float | None = None,
                 dtype=torch.bfloat16, max_prompt_length: int = 77,
                 quantize_unet: bool = False):
        if pipeline_name not in SUPPORTED_PIPELINES:
            raise NotImplementedError(
                f"pipeline {pipeline_name!r} is not ported; the PyTorch port serves "
                f"{' and '.join(repr(p) for p in SUPPORTED_PIPELINES)}")
        if pipeline_name == "img2img" and modules.vae_encoder is None:
            raise ValueError("the img2img pipeline needs PipelineModules.vae_encoder")
        self.pipeline_name = pipeline_name
        self.pipeline = DiffusionPipeline(modules, dtype=dtype, quantize_unet=quantize_unet)
        self.dtype = dtype
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

    def _encoder_list(self):
        enc = self.id2ada_prompt_encoder
        return getattr(enc, "encoders", [enc])

    def extend_tokenizer_and_text_encoder(self):
        """Add `z_{i}_{j}` placeholder tokens per encoder and grow the token
        table to the tokenizer's vocabulary."""
        tok = self.pipeline.m.tokenizer
        for i, enc in enumerate(self._encoder_list()):
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
        """Write ada embeddings [sum_K, D] into the placeholder rows, in place,
        each encoder's K rows into its own tokens."""
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
                                   face_id_embs=None, update_text_encoder: bool = True,
                                   avg_at_stage: str = "id_emb", perturb_std: float = 0.0,
                                   perturb_at_stage: str | None = None, rng=None):
        """Face images (or ID embeddings) → ada embeddings [sum N_ID, D];
        None without a face. Written into the text encoder's placeholder rows
        unless `update_text_encoder` is False (a batcher's request carries
        them instead). `perturb_std` perturbs at `perturb_at_stage`
        (`id_emb` or `img_prompt_emb`); with no stage, as the JAX wrapper
        passes none, it does nothing. `rng`: a torch.Generator or handed
        draws (`utils.tensor.Draws`)."""
        ada, _, _ = self.id2ada_prompt_encoder.generate_adaface_embeddings(
            images=images, face_id_embs=face_id_embs, avg_at_stage=avg_at_stage,
            perturb_std=perturb_std, perturb_at_stage=perturb_at_stage, rng=rng)
        if ada is not None and update_text_encoder:
            self.update_text_encoder_subj_embeddings(ada)
        return ada

    def make_batcher(self, num_slots: int = 8, num_inference_steps: int | None = None,
                     **kw) -> ContinuousBatcher:
        """Continuous-batching server over this wrapper's modules: requests
        for different subjects share one device batch (per-sample ada
        injection instead of the shared-table write), and slots refill per
        denoise step. Build requests with `make_request`."""
        all_ids = [i for ids in self.placeholder_token_ids for i in ids]
        return ContinuousBatcher(
            self.pipeline.m, num_slots=num_slots,
            num_inference_steps=num_inference_steps or self.num_inference_steps,
            placeholder_token_ids=all_ids, dtype=self.dtype, **kw)

    def make_request(self, prompt: str, ada_embs=None, negative_prompt: str = "",
                     **kw) -> Request:
        """Request for `make_batcher`: the placeholder strings appended to
        the prompt, and the subject's ada embeddings (from
        `prepare_adaface_embeddings(update_text_encoder=False)`)."""
        gs = kw.pop("guidance_scale", self.guidance_scale)
        return Request(prompt=self.update_prompt(prompt), negative_prompt=negative_prompt,
                       ada_embs=ada_embs, guidance_scale=gs, **kw)

    def load_adaface_ckpt(self, ckpt_dir: str) -> None:
        """The trained SubjBasisGenerator(s) of a checkpoint the port's
        trainer wrote into the encoder, at the prompt2token_proj widths the
        checkpoint holds (an MKV-extended one included)."""
        from adaface_tpu_torch.train.checkpoint import load_subj_basis_generators

        load_subj_basis_generators(self.id2ada_prompt_encoder, ckpt_dir)

    def load_unet_lora_weights(self, ckpt_dir: str, ffn_adapter: str = "comp_distill"):
        """The UNet's trained attention and FFN DoRA adapters from a
        checkpoint the port's trainer wrote (`unet_lora_modules`), into the
        pipeline (and so into `make_batcher`'s batchers): fp32 on the
        pipeline's device, cast at each product as JAX's `dora_dense` /
        `dora_conv` compute. The FFN adapters are taken only where the
        checkpoint has the adapter `ffn_adapter`."""
        from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt

        state, _ = load_adaface_ckpt(ckpt_dir)
        lora = state.get("unet_lora_modules")
        if lora is None:
            raise ValueError(f"no unet_lora_modules in {ckpt_dir}")
        m = self.pipeline.m
        attn = lora.get("attn_lora")
        m.attn_lora = None if attn is None else self._adapter(AttnLoRA, attn)
        ffn = lora.get("ffn_lora")
        if ffn is not None and any(k.startswith(f"{ffn_adapter}.") for k in ffn):
            m.ffn_lora = self._adapter(FFNLoRA, ffn)
            m.ffn_adapter = ffn_adapter
        n = sum(len(sd) for sd in lora.values() if sd is not None)
        print(f"loaded {n} UNet LoRA tensors from {ckpt_dir}")

    def _adapter(self, cls, sd: dict):
        """`cls` (AttnLoRA or FFNLoRA) at the rank of the state dict `sd`,
        loaded (strict), fp32 and frozen on the pipeline's device."""
        m = self.pipeline.m
        rank = next(v.shape[0] for k, v in sd.items() if k.endswith("lora_a"))
        cfg = dataclasses.replace(m.unets[0].cfg, lora_rank=rank)
        module = cls(cfg)
        module.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
        return module.to(m.device).requires_grad_(False).eval()

    def mix_ada_embs_with_other_embs(self, ada_embs, other_embs, mix_scale: float):
        """Ablation mixing of ada embeddings with others of their shape."""
        return ada_embs * mix_scale + other_embs * (1.0 - mix_scale)

    def __call__(self, *a, **kw):
        return self.forward(*a, **kw)

    def forward(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE_PROMPT,
                num_images: int = 1, guidance_scale: float | None = None,
                num_inference_steps: int | None = None,
                init_image: np.ndarray | None = None, strength: float = 0.8,
                generator: torch.Generator | None = None, update_prompt: bool = True,
                height: int = 512, width: int = 512, scheduler: str = "ddim",
                img2img_noise: tuple | None = None):
        """→ images [N, 3, H, W] float32 in [0, 1]; the placeholder string is
        appended to the prompt unless `update_prompt` is False. `scheduler`:
        ddim, dpm++, pndm or lcm. "img2img" starts from `init_image`
        ([H, W, 3] or [B, H, W, 3], 0..255) noised to `strength` of the
        schedule and runs `strength` of the steps; its two draws (the
        posterior's sample, the noise) come from `generator`, or are handed
        in as `img2img_noise`."""
        if update_prompt:
            prompt = self.update_prompt(prompt)
        steps = (num_inference_steps if num_inference_steps is not None
                 else self.num_inference_steps)
        latents = None
        if self.pipeline_name == "img2img":
            if init_image is None:
                raise ValueError("the img2img pipeline needs init_image")
            latents = self._img2img_latents(init_image, strength, generator, num_images,
                                            img2img_noise)
            steps = max(int(steps * strength), 1)
        return self.pipeline(
            [prompt] * num_images, negative_prompt=negative_prompt,
            num_inference_steps=steps,
            guidance_scale=guidance_scale if guidance_scale is not None else self.guidance_scale,
            generator=generator, latents=latents, height=height, width=width,
            scheduler=scheduler)

    @torch.inference_mode()
    def _img2img_latents(self, init_image, strength: float, generator, num_images: int,
                         noise: tuple | None = None):
        """The initial image's latents (a sample of the encoder's posterior),
        repeated per image and diffused to timestep T · strength - 1. `noise`:
        (the posterior's draw [B, 4, h, w], the diffusion's [B · N, 4, h, w])."""
        m = self.pipeline.m
        device = m.device
        img = torch.as_tensor(np.asarray(init_image), dtype=torch.float32, device=device)
        if img.dim() == 3:
            img = img[None]
        img = img.permute(0, 3, 1, 2) / 127.5 - 1.0
        if noise is None:
            if generator is None:  # a fixed default, as the JAX wrapper's PRNGKey(0)
                generator = torch.Generator(device).manual_seed(0)
            z = vae_encode(m.vae_encoder, img.to(self.dtype), generator=generator)
            eps = torch.randn((z.shape[0] * num_images, *z.shape[1:]), generator=generator,
                              device=device).to(z.dtype)
        else:
            z = vae_encode(m.vae_encoder, img.to(self.dtype),
                           noise=noise[0].to(device, self.dtype))
            eps = noise[1].to(device, z.dtype)
        z = z.repeat_interleave(num_images, dim=0)
        t0 = int(m.schedule.num_timesteps * strength)
        t = torch.full((z.shape[0],), t0 - 1, dtype=torch.long, device=device)
        return m.schedule.q_sample(z, t, eps).to(self.dtype)
