"""The comp-distill UNet hot-swap of the port's trainer, and the Stage-2
recipes through the CLI, on the CPU at tiny widths.

`Trainer.fit` over a Stage-2 plan (comp, recon, comp, unet-distill) with
`frozen["comp_unet"]`: each comp iteration's step runs on the comp weights,
copied in place into the frozen UNet (the same parameter tensors), every
other step and the prefetch thread's teacher on the base weights, which
are back after each comp step and after the fit. Then `train_torch.py` on
`configs/stage2-comp-distill.yaml` with `--comp_unet_weight_path` (an SD1.5
single file), `comp_distill.use_face_flow=true` (a random GMA),
`--adaface_ckpt_path` with `--extend_mkv_multiplier 2` and
`trainer.optimizer=adam8bit`: what the CLI builds, and one comp micro-step.
"""

import numpy as np
import torch

from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.data.personalized import PersonalizedBase
from adaface_tpu_torch.id2ada.teachers import create_unet_teacher
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import gma as tgma
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.tools import ckpt_lib as tckpt
from adaface_tpu_torch.train import optimizers as topt
from adaface_tpu_torch.train.checkpoint import save_adaface_ckpt
from adaface_tpu_torch.train.trainer import comp_unet_state_dict
from adaface_tpu_torch.train.train_step import trainable_state_dicts
from tests.test_torch_cli import write_single_file
from tests.test_torch_comp import (IMAGE_SIZE, REPO, png_root, stage2_trainer,  # noqa: F401
                                   tiny_stage2_stack)
from tests.test_torch_models import UNET_KW, one_torch_thread  # noqa: F401
from tests.test_torch_train import TRAIN_TEXT_KW


def checksum(sd: dict) -> float:
    return float(sum(v.contiguous().double().sum() for v in sd.values()))


def weight_sum(unet) -> float:
    return checksum(unet.state_dict())


def test_comp_unet_swapped_in_and_restored(png_root, tmp_path):  # noqa: F811
    trainer = stage2_trainer(tmp_path / "a")
    unet = trainer.frozen["unet"]
    comp_tree = tckpt.unflatten_tree(bridge.tree_state_dict(stage2_trainer(
        tmp_path / "b", seed=7).frozen["unet"]))
    comp_sd = comp_unet_state_dict(unet, comp_tree)
    base_sd = {k: v.clone() for k, v in unet.state_dict().items()}
    trainer.set_comp_unet(comp_sd)
    trainer.teacher = create_unet_teacher("simple_unet", unet=unet)
    trainer.cfg.prefetch = 2
    base, comp = weight_sum(unet), checksum(comp_sd)
    assert base != comp
    ptrs = [p.data_ptr() for p in unet.parameters()]
    seen, teacher_seen = [], []
    real_get = trainer._get_step

    def get_step(flags):
        step = real_get(flags)

        def recorded(*a, **kw):
            seen.append((flags.iter_type, weight_sum(unet)))
            return step(*a, **kw)
        return recorded

    real_teacher = trainer.teacher.__class__.__call__

    def teacher_call(self, *a, **kw):
        teacher_seen.append(weight_sum(unet))
        return real_teacher(self, *a, **kw)

    trainer._get_step = get_step
    trainer.teacher.__class__.__call__ = teacher_call
    try:
        trainer.fit(PersonalizedBase(png_root, num_vectors_per_subj_token=16, size=IMAGE_SIZE,
                                     seed=0), num_steps=4)
    finally:
        trainer.teacher.__class__.__call__ = real_teacher
    assert [t for t, _ in seen] == ["comp_distill", "recon", "comp_distill", "unet_distill"]
    for t, s in seen:
        assert s == (comp if t == "comp_distill" else base), t
    assert teacher_seen and all(s == base for s in teacher_seen)
    assert [p.data_ptr() for p in unet.parameters()] == ptrs  # copied in place
    for k, v in unet.state_dict().items():
        assert torch.equal(v, base_sd[k]), k
    want = bridge.load(tunet.UNet2DConditionModel(unet.cfg), comp_tree).state_dict()
    for k, v in comp_sd.items():
        assert torch.equal(v, want[k]), k


def test_cli_stage2_recipes(monkeypatch, png_root, tmp_path):  # noqa: F811
    """The four Stage-2 recipe options together through `build_trainer`, then
    one comp micro-step with the flow, the MKV SubjBasisGenerators, adam8bit
    and the comp weights swapped in and back."""
    import train_torch

    comp_path = str(tmp_path / "comp.safetensors")
    towers = write_single_file(comp_path, TRAIN_TEXT_KW)
    tiny_stage2_stack(monkeypatch)
    cfg, args = train_torch.parse_args([
        "trainer.image_size=64", "--base", str(REPO / "configs/stage2-comp-distill.yaml"),
        "--data_roots", png_root, "--log_dir", str(tmp_path / "log"), "--max_steps", "1",
        "--device", "cpu"])
    trainer, _, _ = train_torch.build_trainer(cfg, args)
    ck = save_adaface_ckpt(str(tmp_path / "ck"), 0,
                           {"joint": trainable_state_dicts(trainer.state.params)})
    cfg, args = train_torch.parse_args([
        "trainer.image_size=64", "comp_distill.use_face_flow=true", "trainer.optimizer=adam8bit",
        "--base", str(REPO / "configs/stage2-comp-distill.yaml"), "--data_roots", png_root,
        "--log_dir", str(tmp_path / "log2"), "--max_steps", "1", "--device", "cpu",
        "--comp_unet_weight_path", comp_path, "--adaface_ckpt_path", ck,
        "--extend_prompt2token_proj_attention_multiplier", "2"])
    assert args.extend_mkv_multiplier == 2
    trainer, dataset, start = train_torch.build_trainer(cfg, args)
    assert isinstance(trainer.frozen["flow"], tgma.GMA) and trainer.comp_cfg.use_face_flow
    assert isinstance(trainer.state.optimizer.optimizer, topt.Adam8bit)
    for sbg in trainer.state.params["sbg"]:
        assert tclip.layer_multipliers(sbg.clip) == [2] * TRAIN_TEXT_KW["num_layers"]
    unet = trainer.frozen["unet"]
    rounded = tckpt.unflatten_tree({k: v.astype(np.float16).astype(np.float32)
                                    for k, v in tckpt.flatten_tree(towers["unet"]).items()})
    for k, v in comp_unet_state_dict(unet, rounded).items():  # the file's fp16 values
        assert torch.equal(trainer.frozen["comp_unet"][k], v), k
    base, comp_sum = weight_sum(unet), checksum(trainer.frozen["comp_unet"])
    seen = []
    real_get = trainer._get_step

    def get_step(flags):
        step = real_get(flags)
        return lambda *a, **kw: (seen.append((flags.iter_type, weight_sum(unet))),
                                 step(*a, **kw))[1]

    trainer._get_step = get_step
    metrics = trainer.fit(dataset, num_steps=1, start_step=start)
    assert seen[0][0] == "comp_distill" and seen[0][1] == comp_sum
    assert weight_sum(unet) == base and np.isfinite(float(metrics["loss"]))
