"""Shared helpers of the port's CLIs (`adaface_infer_torch.py`,
`adaface_translate_torch.py`, the evaluation and face tools), the
counterparts of `scripts/_common.py`: build the port's `AdaFaceWrapper` from
weight files (or random weights for a smoke run) on a device, name a face
backend, list, load and write images. Images are read by
`adaface_tpu_torch.utils.image.read_image` (PNG, JPEG, BMP) and written as
PNGs (no PIL needed).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from adaface_tpu_torch.inference.sd3_pipeline import SD3_CLIP_L_TEXT, SD3_VAE
from adaface_tpu_torch.inference.wrapper import SUPPORTED_PIPELINES
from adaface_tpu_torch.models.clip import CLIP_BIGG_TEXT, CLIP_L_TEXT
from adaface_tpu_torch.models.mmdit import SD3_MEDIUM
from adaface_tpu_torch.models.unet import SD15_UNET, SDXL_UNET
from adaface_tpu_torch.models.vae import SD_VAE

# the configurations of the random towers and their weight files: SD1.5 and
# CLIP-L; SDXL's and SD3's (random weights only); `ENCODER_KW` goes to
# `create_id2ada_prompt_encoder`
MODEL_CFGS = dict(unet_cfg=SD15_UNET, vae_cfg=SD_VAE, text_cfg=CLIP_L_TEXT)
XL_CFGS = dict(unet_cfg=SDXL_UNET, vae_cfg=SD_VAE, text_cfg=CLIP_L_TEXT,
               text2_cfg=CLIP_BIGG_TEXT)
SD3_CFGS = dict(mmdit_cfg=SD3_MEDIUM, vae_cfg=SD3_VAE, text_cfg=SD3_CLIP_L_TEXT,
                text2_cfg=CLIP_BIGG_TEXT)
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
    it), or for `--pipeline text2imgxl` / `text2img3` random SDXL / SD3
    towers (`--base_model` refused, as the JAX CLI refuses it), the encoder
    `--encoder` (random), its SubjBasisGenerator(s) from `--adaface_ckpt`.
    `pipeline_name` "text2video" (no `--pipeline` choice, as in the JAX CLI)
    gets the SD1.5 towers and random MM_SD15_V2 motion modules."""
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import create_id2ada_prompt_encoder
    from adaface_tpu_torch.inference.pipeline import PipelineModules
    from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper

    pipeline_name = getattr(args, "pipeline", None) or pipeline_name
    if pipeline_name not in SUPPORTED_PIPELINES:
        raise SystemExit(f"pipeline {pipeline_name!r} is not ported; the PyTorch port serves "
                         "'text2img', 'img2img' and 'text2video' (SD1.5), 'text2imgxl' (SDXL) "
                         "and 'text2img3' (SD3)")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    gen = torch.Generator(device).manual_seed(0)
    towers = {}
    if pipeline_name in ("text2imgxl", "text2img3"):
        if args.base_model:
            raise SystemExit(
                f"--base_model single-file loading for {pipeline_name} is not wired into this "
                "CLI: convert the towers with adaface_tpu_torch/tools/convert_sd.py (the SDXL "
                "UNet and VAE), tools/convert_mmdit.py (SD3) and tools/convert_clip.py, then "
                "assemble the pipeline modules in Python")
        if pipeline_name == "text2imgxl":
            from adaface_tpu_torch.inference.sdxl_pipeline import SDXLPipelineModules

            modules = SDXLPipelineModules.random_init(gen, device, dtype, **XL_CFGS)
        else:
            from adaface_tpu_torch.inference.sd3_pipeline import SD3PipelineModules

            modules = SD3PipelineModules.random_init(gen, device, dtype, **SD3_CFGS)
    elif args.base_model:
        from adaface_tpu_torch.tools.convert_sd import load_sd_towers

        towers = load_sd_towers(args.base_model, unet_cfg=MODEL_CFGS["unet_cfg"],
                                vae_cfg=MODEL_CFGS["vae_cfg"])
        print(f"loaded base model weights from {args.base_model}: {sorted(towers)}")
    if pipeline_name not in ("text2imgxl", "text2img3"):
        if {"unet", "vae", "text_encoder"} <= set(towers):
            base = None
        else:
            base = PipelineModules.random_init(gen, device, dtype, **MODEL_CFGS)
        if towers:
            from adaface_tpu_torch.tools.convert_sd import load_pipeline_modules

            modules = load_pipeline_modules(towers, device, dtype,
                                            unet_cfg=MODEL_CFGS["unet_cfg"],
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


def add_face_backend_arg(ap) -> None:
    from adaface_tpu_torch.evaluation.face_sim import FACE_BACKENDS

    ap.add_argument("--face_backend", default=FACE_BACKENDS[0], choices=FACE_BACKENDS,
                    help="the in-repo RetinaFace + ArcFace stack (random weights), or "
                         "'deterministic' (a hash of the pixels, for tests)")


def image_files(folder: str, exts=(".jpg", ".jpeg", ".png", ".webp", ".bmp")) -> list[str]:
    """The folder's image file names by extension, sorted, without the
    `*_mask.png` masks that sit beside training photos."""
    return sorted(f for f in os.listdir(folder)
                  if os.path.splitext(f)[1].lower() in exts and not f.endswith("_mask.png"))


def embed_folder(folder: str, backend) -> tuple[np.ndarray, list[str], list[str]]:
    """Each image of the folder (`image_files`) through the face backend →
    (embeddings [N, 512] of those with a face, their paths, every path)."""
    from adaface_tpu_torch.utils.image import read_image, to_rgb

    paths = [os.path.join(folder, f) for f in image_files(folder)]
    embs, kept = [], []
    for p in paths:
        e = backend.detect_and_embed(to_rgb(read_image(p)))
        if e is not None:
            embs.append(e)
            kept.append(p)
    return (np.stack(embs) if embs else np.zeros((0, 512), np.float32)), kept, paths


def load_subject_images(path: str, limit: int | None = None) -> list[np.ndarray]:
    """A folder of photos (or one) → RGB uint8 [H, W, 3] arrays, the
    reference's extensions (`_common.py:112`) read by `utils.image.read_image`
    (PNG, JPEG, BMP; a WebP raises with its path)."""
    from adaface_tpu_torch.data.personalized import IMG_EXTS
    from adaface_tpu_torch.utils.image import read_image, to_rgb

    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if os.path.splitext(f)[1].lower() in IMG_EXTS)
    else:
        files = [path]
    return [to_rgb(read_image(f)) for f in files[:limit]]


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
