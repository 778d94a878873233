"""Teacher sanity-check CLI on the PyTorch port: the counterpart of
`scripts/test_img_prompt_model.py`.

Runs the raw teacher pipeline, face ID → image-prompt embeddings → the
"simple_unet" teacher's denoising chain from pure noise at t 999 → VAE
decode, WITHOUT the ada mapping, to check the teacher stack end to end.
The SD1.5 UNet and VAE are random bf16 weights on the card (seeds 0 and
1), the encoder random fp32 weights (seed 2); `--seed` seeds the draws.

    python scripts/test_img_prompt_model_torch.py --randface --out_dir out_teacher/
    python scripts/test_img_prompt_model_torch.py --subject subj/ --out_dir out_teacher/
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from _common_torch import add_model_args, load_subject_images, save_images


@torch.no_grad()
def teacher_images(encoder, unet, vae, schedule, draws, num_images: int = 2,
                   num_steps: int = 8, size: int = 512, images=None):
    """The teacher chain of `num_images` samples on latents of size / 8 →
    (image prompts [N, K, D], decoded images [N, 3, H, W] fp32 in [0, 1]). `images` (RGB
    uint8 photos of one subject) gives the identity, averaged over the
    photos' ID embeddings; without it the random-ID path draws one. Draws
    from `draws` (a `Draws`) in the JAX script's order: the identity's,
    x_start, the noise, then the teacher's. None where no face was found."""
    from adaface_tpu_torch.id2ada.teachers import create_unet_teacher

    if images is None:
        _, _, embs, _ = encoder.get_img_prompt_embs(id_batch_size=num_images, rng=draws)
    else:
        _, _, embs, _ = encoder.get_img_prompt_embs(images=images, id_batch_size=num_images,
                                                    avg_at_stage="id_emb", rng=draws)
    if embs is None:
        return None, None
    dev = next(unet.parameters()).device
    dt = next(unet.parameters()).dtype
    s = size // 8  # SD's VAE scale, as the JAX script takes it
    x_start = draws.normal((num_images, 4, s, s), dev).to(dt)
    noise = draws.normal(x_start.shape, dev).to(dt)
    t = torch.full((num_images,), 999, dtype=torch.long, device=dev)
    teacher = create_unet_teacher("simple_unet", unet=unet)
    _, x_starts, _, _ = teacher(schedule, x_start, noise, t, embs.to(dev, dt), draws,
                                num_denoising_steps=num_steps)
    img = vae(x_starts[-1].to(next(vae.parameters()).dtype)).float()
    return embs, ((img + 1.0) / 2.0).clamp(0.0, 1.0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--subject", default=None)
    ap.add_argument("--randface", action="store_true")
    ap.add_argument("--num_images", type=int, default=2)
    ap.add_argument("--num_steps", type=int, default=8)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="out_teacher")
    args = ap.parse_args(argv)
    if not (args.subject or args.randface):
        ap.error("give --subject or --randface")

    from adaface_tpu_torch.core.params import build, init_fan_in_
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import create_id2ada_prompt_encoder
    from adaface_tpu_torch.models.unet import (SD15_UNET, UNet2DConditionModel,
                                               init_unet_weights_)
    from adaface_tpu_torch.models.vae import SD_VAE, VAEDecoder
    from adaface_tpu_torch.ops.schedules import DiffusionSchedule
    from adaface_tpu_torch.utils.tensor import Draws

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    unet = build(lambda: UNet2DConditionModel(SD15_UNET), device, dtype, init_unet_weights_,
                 torch.Generator(device).manual_seed(0))
    vae = build(lambda: VAEDecoder(SD_VAE), device, dtype, init_fan_in_,
                torch.Generator(device).manual_seed(1))
    encoder = create_id2ada_prompt_encoder(args.encoder, torch.Generator(device).manual_seed(2),
                                           device=device)
    images = None if args.randface else load_subject_images(args.subject)
    embs, img = teacher_images(encoder, unet, vae, DiffusionSchedule.create(),
                               Draws(torch.Generator(device).manual_seed(args.seed)),
                               args.num_images, args.num_steps, args.size, images)
    if embs is None:
        raise SystemExit("no identity could be prepared")
    print(f"img prompt embs: {tuple(embs.shape)}")
    paths = save_images(img, args.out_dir, prefix="teacher")
    print(f"wrote {len(paths)} teacher samples to {args.out_dir}")


if __name__ == "__main__":
    main()
