"""Shared helpers of the port's CLIs (`adaface_infer_torch.py`,
`adaface_translate_torch.py`), the counterparts of `scripts/_common.py`:
build the port's `AdaFaceWrapper` from weight files (or random weights for a
smoke run) on a device, load subject images and write images. Images are
PNGs read and written by `adaface_tpu_torch.utils.image` (no PIL needed).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from adaface_tpu_torch.inference.wrapper import SUPPORTED_PIPELINES
from adaface_tpu_torch.models.clip import CLIP_L_TEXT
from adaface_tpu_torch.models.unet import SD15_UNET
from adaface_tpu_torch.models.vae import SD_VAE

# the configurations of the random towers and their weight files: SD1.5 and
# CLIP-L; `ENCODER_KW` goes to `create_id2ada_prompt_encoder`
MODEL_CFGS = dict(unet_cfg=SD15_UNET, vae_cfg=SD_VAE, text_cfg=CLIP_L_TEXT)
ENCODER_KW: dict = {}


def add_model_args(ap):
    ap.add_argument("--base_model", default=None,
                    help="SD1.5 checkpoint (.safetensors / .ckpt); random weights if omitted")
    ap.add_argument("--adaface_ckpt", default=None,
                    help="a checkpoint directory of the port's trainer")
    ap.add_argument("--encoder", default="arc2face",
                    choices=["arc2face", "consistentID", "jointIDs"])
    ap.add_argument("--guidance_scale", type=float, default=6.0)
    ap.add_argument("--num_inference_steps", type=int, default=50)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--pipeline", default=None,
                    choices=["text2img", "img2img", "text2imgxl", "text2img3"],
                    help="pipeline family; the CLI's own default when omitted")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build_wrapper(args, pipeline_name: str = "text2img"):
    """The port's AdaFaceWrapper on `args.device`: SD1.5 towers from
    `--base_model` (random ones for any tower the file lacks, or all without
    it), the encoder `--encoder` (random), its SubjBasisGenerator(s) from
    `--adaface_ckpt`."""
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import create_id2ada_prompt_encoder
    from adaface_tpu_torch.inference.pipeline import PipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper

    pipeline_name = getattr(args, "pipeline", None) or pipeline_name
    if pipeline_name not in SUPPORTED_PIPELINES:
        raise SystemExit(f"pipeline {pipeline_name!r} is not ported; the PyTorch port serves "
                         f"{' and '.join(repr(p) for p in SUPPORTED_PIPELINES)}")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen = torch.Generator(device).manual_seed(0)
    towers = {}
    if args.base_model:
        from adaface_tpu_torch.tools.convert_sd import load_sd_towers

        towers = load_sd_towers(args.base_model, unet_cfg=MODEL_CFGS["unet_cfg"],
                                vae_cfg=MODEL_CFGS["vae_cfg"])
        print(f"loaded base model weights from {args.base_model}: {sorted(towers)}")
    if {"unet", "vae", "text_encoder"} <= set(towers):
        base = None
    else:
        base = PipelineModules.random_init(gen, device, dtype, **MODEL_CFGS)
    if towers:
        from adaface_tpu_torch.tools.convert_sd import load_pipeline_modules

        modules = load_pipeline_modules(towers, device, dtype, unet_cfg=MODEL_CFGS["unet_cfg"],
                                        vae_cfg=MODEL_CFGS["vae_cfg"], base=base)
    else:
        modules = base
    encoder = create_id2ada_prompt_encoder(
        args.encoder, torch.Generator(device).manual_seed(1), modules.tokenizer, device,
        **ENCODER_KW)
    if args.adaface_ckpt:
        load_adaface(encoder, args.adaface_ckpt)
    return AdaFaceWrapper(pipeline_name, modules, encoder, guidance_scale=args.guidance_scale,
                          num_inference_steps=args.num_inference_steps, dtype=dtype)


def load_adaface(encoder, ckpt_dir: str) -> None:
    """The SubjBasisGenerator(s) of a checkpoint of the port's trainer into
    the encoder, by the encoder's name or under "joint", at the
    prompt2token_proj widths the checkpoint holds (`_load_adaface`)."""
    from adaface_tpu_torch.train.checkpoint import load_subj_basis_generators

    load_subj_basis_generators(encoder, ckpt_dir)


def load_subject_images(path: str, limit: int | None = None) -> list[np.ndarray]:
    """A folder of PNGs (or one PNG) → RGB uint8 [H, W, 3] arrays."""
    from adaface_tpu_torch.utils.image import read_png, to_rgb

    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith(".png"))
    else:
        files = [path]
    return [to_rgb(read_png(f)) for f in files[:limit]]


def to_uint8(images) -> np.ndarray:
    """[N, 3, H, W] floats in [0, 1] → uint8 [N, H, W, 3]."""
    arr = images.float().cpu().numpy() if isinstance(images, torch.Tensor) else np.asarray(images)
    return (arr * 255).astype(np.uint8).transpose(0, 2, 3, 1)


def save_images(images, out_dir: str, prefix: str = "sample") -> list[str]:
    from adaface_tpu_torch.utils.image import write_png

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, im in enumerate(to_uint8(images)):
        paths.append(os.path.join(out_dir, f"{prefix}_{i:03d}.png"))
        write_png(paths[-1], im)
    return paths


def save_image_grid(images, out_path: str, cols: int = 2) -> str:
    """[N, 3, H, W] floats in [0, 1] → one grid PNG."""
    from adaface_tpu_torch.utils.image import write_png

    arr = to_uint8(images)
    n, h, w, _ = arr.shape
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(arr):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_png(out_path, grid)
    return out_path
