"""Stage-1 training CLI of the PyTorch port:

    python train_torch.py --base configs/stage1-distill-arc2face.yaml \
        --data_roots <subject folders> [key.path=value ...]

The counterpart of `train.py` for unet-distill configurations (every
iteration unet-distill: `comp_distill_iter_gap: 0`, `unet_distill_iter_gap:
1`): the same YAML and dot-list overrides, the model stack built with random
weights from the config's seed (SD1.5 UNet and VAE encoder in bf16 on the
card, CLIP-L text and the id→ada encoder in fp32), the id→ada encoder's
SubjBasisGenerator(s) trained against the frozen UNet as teacher, then
`Trainer.fit`. Runs on the card (`--device cuda`, the default); `--device
cpu` runs it in fp32 on the host. Checkpoints land in
`<log_dir>/checkpoints/embeddings_gs-N`. Loading converted SD1.5 weights
(`--base_model`), the comp-distill UNet and the ArcFace identity towers of
recon and comp iterations wait for their slices (ROADMAP §1).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from adaface_tpu_torch.utils.config import apply_dotlist, load


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
    from adaface_tpu_torch.models.vae import VAEEncoder
    from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
    from adaface_tpu_torch.text.tokenizer import default_tokenizer
    from adaface_tpu_torch.train.train_step import TrainConfig
    from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig

    tc_fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    tcfg = cfg.get("trainer") or {}
    trainer_cfg = TrainerConfig(data_roots=args.data_roots, log_dir=args.log_dir,
                                **{k: v for k, v in tcfg.items() if k in tc_fields})
    for key in ("clip_skip_weights", "unet_distill_steps_range",
                "perturb_face_id_embs_std_range"):
        setattr(trainer_cfg, key, tuple(getattr(trainer_cfg, key)))
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator(device).manual_seed(trainer_cfg.seed)
    print(f"building the model stack on {device} ...", flush=True)
    unet = build(UNet2DConditionModel, device, dtype, init_unet_weights_, gen)
    text = build(CLIPTextModel, device, torch.float32, init_text_weights_, gen)
    vae = build(VAEEncoder, device, dtype, init_fan_in_, gen)

    model_cfg = cfg.get("model") or {}
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
    tf_fields = {f.name for f in dataclasses.fields(TrainConfig)}
    overrides = {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()
                 if k in tf_fields}
    train_cfg = TrainConfig(sbg=sbg_cfg, **overrides)
    dataset = PersonalizedBase(
        trainer_cfg.data_roots, mix_subj_data_roots=args.mix_subj_data_roots,
        subject_string=args.subject_string,
        default_cls_delta_string=args.default_cls_delta_string,
        num_vectors_per_subj_token=encoder.num_id_vecs, size=trainer_cfg.image_size,
        seed=trainer_cfg.seed)
    print(f"{dataset.num_subjects()} subjects, {len(dataset)} images", flush=True)
    trainer = Trainer(trainer_cfg, train_cfg, {"unet": unet, "text_encoder": text}, trainable,
                      encoder, em, vae=vae, teacher=teacher)
    start_step = 0
    if args.resume:
        ck = Trainer.latest_ckpt(args.log_dir)
        if ck is None:
            print(f"no checkpoint under {args.log_dir}, starting fresh")
        else:
            start_step = trainer.load(ck)
    elif args.adaface_ckpt_path:
        trainer.load(args.adaface_ckpt_path)
    return trainer, dataset, start_step


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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dot.key=value overrides")
    args = ap.parse_args(argv)
    return apply_dotlist(load(args.base), args.overrides), args


def main(argv=None):
    return build_and_train(*parse_args(argv))


if __name__ == "__main__":
    main()
