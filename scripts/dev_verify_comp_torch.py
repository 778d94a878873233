"""Dev drive of the PyTorch port's comp-distill trainer path outside pytest:
the counterpart of `scripts/dev_verify_comp.py`.

4 optimizer steps of `Trainer.fit` with a comp iteration every other step
(`comp_distill_iter_gap=2`) on a 2-subject folder of random 64² PNGs
(written by `utils.image.encode_png`), at tiny widths with the Arc2Face
encoder on the hash face backend and random weights. On the CPU the widths
are the JAX script's (CLIP text 64 wide over 2 layers, a 4-level UNet of
16-32 channels: head dims 32, 8 and 16); on the card the smallest whose
attentions the flash backward kernels take (text 80 wide, UNet 80-160
channels, 2 heads: head dims 40 and 80), in bf16. Asserts a finite loss
and at least 2 comp iterations.

    python scripts/dev_verify_comp_torch.py          # on the card (cuda)
    python scripts/dev_verify_comp_torch.py cpu      # CPU
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from adaface_tpu_torch.models.clip import CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig

# the JAX script's tiny configs (`tests/test_id2ada.py`, `tests/test_train.py`)
D = 64
SMALL_CLIP = CLIPTextConfig(hidden_size=D, num_layers=2, num_heads=2, intermediate_size=128)
UNET_CFG = UNetConfig(block_channels=(16, 32, 32, 32), cross_attn_dim=D, num_heads=2,
                      norm_groups=8, lora_rank=4, lora_alpha=1)
# on the card: the flash backward kernels have head dims 40/48, 80, 160 and 512
CARD_CLIP = CLIPTextConfig(hidden_size=80, num_layers=2, num_heads=2, intermediate_size=160)
CARD_UNET = UNetConfig(block_channels=(80, 160, 160, 160), cross_attn_dim=80, num_heads=2,
                       norm_groups=8, lora_rank=4, lora_alpha=1)
K_ID = 16


def tiny_configs(device: torch.device) -> tuple[CLIPTextConfig, UNetConfig]:
    return (SMALL_CLIP, UNET_CFG) if device.type == "cpu" else (CARD_CLIP, CARD_UNET)


def write_folder(root: str) -> None:
    """Two subjects of 2 random 64² PNGs each, and their metainfo.json."""
    from adaface_tpu_torch.utils.image import write_png

    for si, name in enumerate(("alice", "bob")):
        d = os.path.join(root, name)
        os.makedirs(d)
        rs = np.random.RandomState(si)
        for i in range(2):
            write_png(os.path.join(d, f"{i}.png"), rs.randint(0, 255, (64, 64, 3), np.uint8))
    with open(os.path.join(root, "metainfo.json"), "w") as f:
        json.dump({"alice": {"cls_delta_string": "woman"}, "bob": {"cls_delta_string": "man"}}, f)


def build_trainer(device: torch.device, log_dir: str):
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
    from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import Arc2FaceID2AdaPrompt
    from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
    from adaface_tpu_torch.id2ada.teachers import create_unet_teacher
    from adaface_tpu_torch.models.clip import CLIPTextModel, init_text_weights_
    from adaface_tpu_torch.models.unet import UNet2DConditionModel, init_unet_weights_
    from adaface_tpu_torch.text.embedding_manager import EmbeddingManager, PlaceholderSpec
    from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
    from adaface_tpu_torch.train.comp_step import CompDistillConfig
    from adaface_tpu_torch.train.recon_step import ReconStepConfig
    from adaface_tpu_torch.train.train_step import TrainConfig
    from adaface_tpu_torch.train.trainer import Trainer, TrainerConfig

    gen = torch.Generator(device).manual_seed(0)
    dt = "float32" if device.type == "cpu" else "bfloat16"
    clip_cfg, unet_cfg = tiny_configs(device)
    tok = CLIPTokenizer.character_fallback()
    encoder = Arc2FaceID2AdaPrompt.random_init(gen, tok, device, text_cfg=clip_cfg,
                                               sbg_cfg=SubjBasisConfig(clip=clip_cfg),
                                               face_backend=DeterministicBackend())
    unet = build(lambda: UNet2DConditionModel(unet_cfg), device, torch.float32,
                 init_unet_weights_, gen)
    text = build(lambda: CLIPTextModel(clip_cfg), device, torch.float32, init_text_weights_,
                 gen)
    cfg = TrainerConfig(log_dir=log_dir, batch_size=2, max_steps=4, accum_steps=1,
                        ckpt_every=100, optimizer="adamw", lr=1e-4, warmup_steps=1,
                        comp_distill_iter_gap=2, unet_distill_iter_gap=0, image_size=128,
                        num_vectors_per_subj_token=K_ID, prefetch=0,
                        recon_cfg=ReconStepConfig(compute_dtype=dt))
    train_cfg = TrainConfig(unet=unet_cfg, sbg=encoder.sbg_cfg, clip_text=clip_cfg)
    return Trainer(cfg, train_cfg, {"unet": unet, "text_encoder": text},
                   {"sbg": encoder.subj_basis_generator}, encoder,
                   EmbeddingManager(tok, [PlaceholderSpec("z", K_ID)]),
                   teacher=create_unet_teacher("simple_unet", unet=unet),
                   comp_cfg=CompDistillConfig(num_priming_steps=2, num_denoising_steps=2,
                                              compute_dtype=dt))


def main(device: str = "cuda") -> dict:
    from adaface_tpu_torch.data.personalized import PersonalizedBase

    dev = torch.device(device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    with tempfile.TemporaryDirectory(prefix="toydata_") as root, \
            tempfile.TemporaryDirectory(prefix="logs_") as log_dir:
        write_folder(root)
        trainer = build_trainer(dev, log_dir)
        ds = PersonalizedBase(root, num_vectors_per_subj_token=K_ID, size=128, seed=0)
        metrics = trainer.fit(ds, num_steps=4)
    final = {k: float(v) for k, v in metrics.items()
             if isinstance(v, (int, float)) or getattr(v, "ndim", 1) == 0}
    print("final metrics:", final)
    assert np.isfinite(final["loss"]), "loss not finite"
    assert trainer.planner.comp_iters >= 2, "comp iterations did not run"
    print("OK: comp-distill trainer path ran", trainer.planner.comp_iters, "comp iters,",
          trainer.planner.recon_iters, "recon iters")
    return {"metrics": final, "comp_iters": trainer.planner.comp_iters,
            "recon_iters": trainer.planner.recon_iters}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
