"""Training CLI of the PyTorch port:

    python train_torch.py --base configs/stage1-distill-arc2face.yaml \
        --data_roots <subject folders> [key.path=value ...]
    python train_torch.py --base configs/finetune-unet.yaml --data_roots <...>
    python train_torch.py --base configs/stage2-comp-distill.yaml --data_roots <...>

The counterpart of `train.py`: unet-distill (Stage 1), recon and
comp-distill (Stage 2) iterations, and full-UNet finetuning
(`trainer.unfreeze_unet`). The same YAML and dot-list overrides; the
`model:` and `comp_distill:` sections become `TrainConfig` and
`CompDistillConfig` by field name, and the keys that name no field are
dropped, as `train.py` drops them (stage 2's `model.use_attn_lora`,
`use_ffn_lora`, `lora_rank` and `comp_distill.cls_comp_mix_ratio`: so, as
`train.py`, no UNet adapter trains from this CLI; ROADMAP §3). The model
stack is built with random weights from the config's seed: the SD1.5 UNet
(bf16 on the card, or fp32 master weights computed in bf16 when it trains),
the VAE encoder, CLIP-L text and the id→ada encoder (fp32); for recon or
comp iterations also the VAE decoder (bf16 on the card) and ArcFace (fp32),
from `model.arcface_ckpt` where given, else random with a warning, as
`train.py` builds it. The recon and comp losses compute in bf16 on the card.
Then `Trainer.fit`. Runs on the card (`--device cuda`, the default);
`--device cpu` runs it in fp32 on the host. Checkpoints land in
`<log_dir>/checkpoints/embeddings_gs-N` (with `unet_fp16.safetensors` when
the UNet trains). The identity losses' face detector is
`HostFaceDetector`'s chain (insightface, then OpenCV's cascade, whichever is
installed, else none): where it finds no face the identity losses stay gated
off. `--base_model` loads SD1.5 weights over the random ones (an LDM single
file or a diffusers UNet, `.safetensors` / `.ckpt`, through
`tools/convert_sd.py`), and `--scale_lr` scales the learning rate by
accumulation × devices (one) × batch, as `train.py` does.
`--comp_unet_weight_path` loads the comp-distill iterations' UNet weights
the same way; they are swapped into the frozen UNet for those iterations.
`comp_distill.use_face_flow=true` adds the GMA latent flow to the elastic
matching: converted from `comp_distill.gma_ckpt` (a torch `gma-sintel.pth`)
where given, else random from the config's seed, as `train.py` does.
`--extend_mkv_multiplier` (alias `--extend_prompt2token_proj_attention_
multiplier`) extends the prompt2token_proj attention's K/V of the
checkpoint it warm-starts from (`--adaface_ckpt_path` or `-r`).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from adaface_tpu_torch.utils.config import apply_dotlist, known_fields, load


# the `model:` keys the CLI itself reads; the others go to TrainConfig by name
CLI_MODEL_KEYS = ("id2ada_encoder", "out_id_embs_cfg_scales", "arcface_ckpt",
                  "use_identity_losses", "enable_static_img_suffix_embs")
# the `comp_distill:` keys the CLI itself reads
CLI_COMP_KEYS = ("gma_ckpt",)


def build_trainer(cfg: dict, args):
    """The model stack, the dataset and the trainer of a configuration →
    (trainer, dataset, the step to start from)."""
    from adaface_tpu_torch.core.params import build, init_fan_in_
    from adaface_tpu_torch.data.personalized import PersonalizedBase
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import create_id2ada_prompt_encoder
    from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
    from adaface_tpu_torch.id2ada.teachers import create_unet_teacher
    from adaface_tpu_torch.models.clip import CLIPTextModel, init_text_weights_
    from adaface_tpu_torch.models.unet import UNet2DConditionModel, init_unet_weights_
    from adaface_tpu_torch.models.vae import VAEDecoder, VAEEncoder
    from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
    from adaface_tpu_torch.text.tokenizer import default_tokenizer
    from adaface_tpu_torch.train.comp_step import CompDistillConfig
    from adaface_tpu_torch.train.recon_step import ReconStepConfig
    from adaface_tpu_torch.train.train_step import TrainConfig
    from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig

    tc_fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    tcfg = cfg.get("trainer") or {}
    trainer_cfg = TrainerConfig(data_roots=args.data_roots, log_dir=args.log_dir,
                                **{k: v for k, v in tcfg.items() if k in tc_fields})
    for key in ("clip_skip_weights", "unet_distill_steps_range",
                "perturb_face_id_embs_std_range"):
        setattr(trainer_cfg, key, tuple(getattr(trainer_cfg, key)))
    if getattr(args, "scale_lr", False):
        trainer_cfg.lr = scaled_lr(trainer_cfg)
        print(f"scaled lr: {trainer_cfg.lr}")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device).manual_seed(trainer_cfg.seed)
    print(f"building the model stack on {device} ...", flush=True)
    # a UNet that trains keeps fp32 master weights; the recon loss casts them
    # to its compute dtype at each evaluation
    unet = build(UNet2DConditionModel, device,
                 torch.float32 if trainer_cfg.unfreeze_unet else dtype, init_unet_weights_, gen)
    text = build(CLIPTextModel, device, torch.float32, init_text_weights_, gen)
    vae = build(VAEEncoder, device, dtype, init_fan_in_, gen)
    compute = "bfloat16" if device.type == "cuda" else "float32"
    trainer_cfg.recon_cfg = ReconStepConfig(compute_dtype=compute)
    comp_kw, dropped = known_fields(CompDistillConfig, cfg.get("comp_distill"))
    comp_cfg = CompDistillConfig(**{**comp_kw, "compute_dtype": compute})
    recon_kw = {}
    model_cfg = cfg.get("model") or {}
    # the plan has recon or comp iterations: the identity losses' towers
    if trainer_cfg.unet_distill_iter_gap != 1 or trainer_cfg.comp_distill_iter_gap > 0:
        recon_kw["vae_decoder"] = build(VAEDecoder, device, dtype, init_fan_in_, gen)
        if model_cfg.get("use_identity_losses", True):
            recon_kw["arcface"] = build_arcface(model_cfg.get("arcface_ckpt"), device, gen)
    if getattr(args, "base_model", None):
        load_base_model(args.base_model, unet, text, vae, recon_kw.get("vae_decoder"))

    enc_name = model_cfg.get("id2ada_encoder", "arc2face")
    enc_kw = {}
    scales = model_cfg.get("out_id_embs_cfg_scales")
    if enc_name in ("jointIDs", "joint"):
        enc_kw["is_training"] = True
        if scales:
            enc_kw["out_id_embs_cfg_scales"] = tuple(scales)
    elif scales:
        enc_kw["out_id_embs_cfg_scale"] = scales[0]
    if model_cfg.get("enable_static_img_suffix_embs"):
        raise NotImplementedError("enable_static_img_suffix_embs: the static suffix embeddings "
                                  "of the encoders are not wired in the port's CLI")
    tok = default_tokenizer()
    encoder = create_id2ada_prompt_encoder(enc_name, gen, tok, device, **enc_kw)
    em = EmbeddingManager(tok, [PlaceholderSpec(args.subject_string, encoder.num_id_vecs)])
    encs = getattr(encoder, "encoders", [encoder])
    sbgs = [e.subj_basis_generator for e in encs]
    trainable = {"sbg": sbgs[0] if len(sbgs) == 1 else sbgs}
    sbg_cfg: SubjBasisConfig | tuple = (sbgs[0].cfg if len(sbgs) == 1
                                        else tuple(s.cfg for s in sbgs))

    teacher = None
    if cfg.get("teacher"):
        teacher = create_unet_teacher(
            "simple_unet", unet=unet, p_uses_cfg=cfg["teacher"].get("p_uses_cfg", 0.0),
            cfg_scale_range=tuple(cfg["teacher"].get("cfg_scale_range", (1.3, 2.0))))
    overrides, model_dropped = known_fields(TrainConfig, model_cfg)
    train_cfg = TrainConfig(sbg=sbg_cfg, **overrides)
    unread = [k for k in model_dropped if k not in CLI_MODEL_KEYS]
    dropped = [k for k in dropped if k not in CLI_COMP_KEYS]
    if unread or dropped:
        print(f"keys nothing reads, dropped as train.py drops them: model {unread}, "
              f"comp_distill {dropped}", flush=True)
    frozen = {"unet": unet, "text_encoder": text}
    if comp_cfg.use_face_flow:
        frozen["flow"] = build_gma((cfg.get("comp_distill") or {}).get("gma_ckpt"), device, gen)
    if getattr(args, "comp_unet_weight_path", None):
        from adaface_tpu_torch.tools.convert_sd import load_sd_towers
        from adaface_tpu_torch.train.trainer import comp_unet_state_dict

        towers = load_sd_towers(args.comp_unet_weight_path, unet_cfg=unet.cfg,
                                vae_cfg=vae.cfg)
        frozen["comp_unet"] = comp_unet_state_dict(unet, towers["unet"])
        print(f"loaded comp-distill UNet from {args.comp_unet_weight_path}", flush=True)
    dataset = PersonalizedBase(
        trainer_cfg.data_roots, mix_subj_data_roots=args.mix_subj_data_roots,
        subject_string=args.subject_string,
        default_cls_delta_string=args.default_cls_delta_string,
        num_vectors_per_subj_token=encoder.num_id_vecs, size=trainer_cfg.image_size,
        seed=trainer_cfg.seed)
    print(f"{dataset.num_subjects()} subjects, {len(dataset)} images", flush=True)
    trainer = Trainer(trainer_cfg, train_cfg, frozen, trainable, encoder, em, vae=vae,
                      teacher=teacher, comp_cfg=comp_cfg, **recon_kw)
    start_step = 0
    mult = getattr(args, "extend_mkv_multiplier", 1)
    if args.resume:
        ck = Trainer.latest_ckpt(args.log_dir)
        if ck is None:
            print(f"no checkpoint under {args.log_dir}, starting fresh")
        else:
            start_step = trainer.load(ck, extend_mkv_multiplier=mult)
    elif args.adaface_ckpt_path:
        trainer.load(args.adaface_ckpt_path, extend_mkv_multiplier=mult)
    return trainer, dataset, start_step


def build_gma(path: str | None, device, gen: torch.Generator):
    """The elastic matching's GMA in fp32: converted from the torch
    `gma-sintel.pth` at `path` (`models/gma.convert_gma_state_dict`), else
    random at `init_gma_params`' scales (`train.py:170-188`)."""
    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.gma import GMA, convert_gma_state_dict, init_gma_weights_
    from adaface_tpu_torch.tools.ckpt_lib import load_state_dict

    model = build(GMA, device, torch.float32, init_gma_weights_, gen)
    if path:
        bridge.load(model, convert_gma_state_dict(load_state_dict(path)))
        print(f"loaded the GMA flow from {path}", flush=True)
    print("GMA latent flow enabled for elastic matching", flush=True)
    return model


def scaled_lr(trainer_cfg) -> float:
    """accumulation × devices × batch × base lr (`train.py:55-60`,
    `main.py:911-915`); the port trains on one device."""
    return trainer_cfg.accum_steps * 1 * trainer_cfg.batch_size * trainer_cfg.lr


def load_base_model(path: str, unet, text, vae_encoder, vae_decoder=None) -> dict:
    """SD1.5 weights from `path` (`load_sd_towers`) into the towers the file
    holds, each in its own dtype and device (`train.py:86-96`) → the trees."""
    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.tools.convert_sd import load_sd_towers

    towers = load_sd_towers(path, unet_cfg=unet.cfg, vae_cfg=vae_encoder.cfg)
    if "unet" in towers:
        bridge.load(unet, towers["unet"])
    if "text_encoder" in towers:
        bridge.load(text, towers["text_encoder"])
    if "vae" in towers:
        bridge.load(vae_encoder, bridge.vae_encoder_tree(towers["vae"]))
        if vae_decoder is not None:
            bridge.load(vae_decoder, bridge.vae_decoder_tree(towers["vae"]))
    print(f"loaded base model weights from {path}: {sorted(towers)}", flush=True)
    return towers


def build_arcface(path: str | None, device, gen: torch.Generator):
    """ArcFace in fp32: converted from the torch `arcface-resnet18` checkpoint
    at `path`, else random (the identity losses' plumbing only)."""
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models.arcface import (ArcFace, convert_arcface_state_dict,
                                                  init_arcface_weights_)
    from adaface_tpu_torch.tools.ckpt_lib import load_state_dict

    model = build(ArcFace, device, torch.float32, init_arcface_weights_, gen)
    if path:
        model.load_state_dict(convert_arcface_state_dict(load_state_dict(path)))
        print(f"loaded arcface tower from {path}")
    else:
        print("WARNING: no model.arcface_ckpt — identity losses run with a RANDOM-INIT "
              "ArcFace tower (plumbing only; pass the converted arcface-resnet18 ckpt for "
              "meaningful identity gradients)")
    return model


def build_and_train(cfg: dict, args) -> dict:
    """`build_trainer`, then `Trainer.fit` → the last step's metrics."""
    trainer, dataset, start_step = build_trainer(cfg, args)
    return trainer.fit(dataset, num_steps=args.max_steps or trainer.cfg.max_steps,
                       start_step=start_step)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="YAML config path")
    ap.add_argument("--data_roots", nargs="+", required=True)
    ap.add_argument("--mix_subj_data_roots", nargs="+", default=None,
                    help="folders where every image is a different person")
    ap.add_argument("--subject_string", default="z")
    ap.add_argument("--default_cls_delta_string", default="person")
    ap.add_argument("--log_dir", default="logs/run")
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("-r", "--resume", action="store_true",
                    help="resume from the newest checkpoint in --log_dir")
    ap.add_argument("--adaface_ckpt_path", default=None,
                    help="warm-start the SubjBasisGenerator(s) from this checkpoint")
    ap.add_argument("--base_model", default=None,
                    help="SD1.5 weights (.safetensors / .ckpt, an LDM single file or a "
                         "diffusers UNet); random if omitted")
    ap.add_argument("--scale_lr", action="store_true",
                    help="lr = accum_steps x devices x batch_size x lr")
    ap.add_argument("--comp_unet_weight_path", default=None,
                    help="UNet weights for the comp-distill iterations (.safetensors / .ckpt, "
                         "swapped into the frozen UNet for them)")
    ap.add_argument("--extend_mkv_multiplier",
                    "--extend_prompt2token_proj_attention_multiplier",
                    type=int, default=1, dest="extend_mkv_multiplier",
                    help="replicate the warm-start checkpoint's prompt2token_proj K/V "
                         "projections Nx (the round-2 recipe)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dot.key=value overrides")
    args = ap.parse_args(argv)
    return apply_dotlist(load(args.base), args.overrides), args


def main(argv=None):
    return build_and_train(*parse_args(argv))


if __name__ == "__main__":
    main()
