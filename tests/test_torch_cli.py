"""The port's command lines on the CPU at tiny widths: `train_torch.py
--base_model` (an SD1.5 single file in the LDM layout loaded over the
random towers) and `--scale_lr` (against `train.py`'s arithmetic), and the
inference twins `scripts/adaface_infer_torch.py` and
`adaface_translate_torch.py` end to end with `--device cpu`, 2 steps,
writing PNGs that `read_png` reads back. The widths are cut by patching the
modules (as `tests/test_torch_comp.py:tiny_stage2_stack` does) and the CLIs'
`MODEL_CFGS` / `ENCODER_KW`; each side keeps a tokenizer of its own.
"""

import pathlib

import numpy as np
import pytest
import torch

from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.core.params import build, init_fan_in_
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.tools import ckpt_lib as tckpt
from adaface_tpu_torch.utils import image as timage
from tests import torch_sd_layout as layout
from tests.test_torch_models import TEXT_KW, UNET_KW, VAE_KW
from tests.test_torch_train import TRAIN_TEXT_KW, make_png_dataset
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
HW = 64


def tiny_towers(text_kw, seed: int = 0) -> dict:
    """Random tiny UNet, VAE (encoder and decoder) and CLIP text trees from
    the port's modules (`bridge.tree_state_dict`)."""
    gen = torch.Generator().manual_seed(seed)
    cpu = torch.device("cpu")
    unet = build(lambda: tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), cpu,
                 torch.float32, tunet.init_unet_weights_, gen)
    text = build(lambda: tclip.CLIPTextModel(tclip.CLIPTextConfig(**text_kw)), cpu,
                 torch.float32, tclip.init_text_weights_, gen)
    enc = build(lambda: tvae.VAEEncoder(tvae.VAEConfig(**VAE_KW)), cpu, torch.float32,
                init_fan_in_, gen)
    dec = build(lambda: tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), cpu, torch.float32,
                init_fan_in_, gen)
    tree = lambda m: tckpt.unflatten_tree(bridge.tree_state_dict(m))  # noqa: E731
    return dict(unet=tree(unet), text=tree(text), vae={**tree(enc), **tree(dec)})


def write_single_file(path: str, text_kw) -> dict:
    towers = tiny_towers(text_kw)
    sd = layout.sd_single_file(towers["unet"], towers["vae"], towers["text"],
                               tunet.UNetConfig(**UNET_KW))
    tckpt.save_state_dict(sd, path)
    return towers


def test_train_cli_base_model_and_scale_lr(monkeypatch, tmp_path):
    """`--base_model` puts the file's UNet, text tower and VAE encoder into
    the stack (their fp16 values, in the modules' own dtype); `--scale_lr`
    scales the YAML's lr as `train.py` does on one device."""
    import train_torch
    from adaface_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from adaface_tpu_torch.id2ada import face_id_to_ada_prompt as fid
    from adaface_tpu_torch.models import clip as clip_mod

    path = str(tmp_path / "sd15.safetensors")
    towers = write_single_file(path, TRAIN_TEXT_KW)
    text_cfg = tclip.CLIPTextConfig(**TRAIN_TEXT_KW)
    real_enc = fid.create_id2ada_prompt_encoder
    monkeypatch.setattr(fid, "create_id2ada_prompt_encoder", lambda name, gen, tok, device, **kw:
                        real_enc(name, gen, tok, device, text_cfg=text_cfg,
                                 sbg_cfg=SubjBasisConfig(clip=text_cfg), **kw))
    monkeypatch.setattr(tunet, "UNet2DConditionModel",
                        lambda real=tunet.UNet2DConditionModel: real(tunet.UNetConfig(**UNET_KW)))
    monkeypatch.setattr(clip_mod, "CLIPTextModel", lambda real=clip_mod.CLIPTextModel: real(text_cfg))
    monkeypatch.setattr(tvae, "VAEEncoder",
                        lambda real=tvae.VAEEncoder: real(tvae.VAEConfig(**VAE_KW)))
    monkeypatch.setattr("adaface_tpu_torch.text.tokenizer.default_tokenizer",
                        CLIPTokenizer.character_fallback)
    config = str(REPO / "configs/stage1-distill-arc2face.yaml")
    cfg, args = train_torch.parse_args([
        "trainer.image_size=64", "--base", config, "--data_roots",
        make_png_dataset(tmp_path / "pngs", size=HW), "--log_dir", str(tmp_path / "log"),
        "--device", "cpu", "--base_model", path, "--scale_lr"])
    trainer, _, _ = train_torch.build_trainer(cfg, args)
    for name, module, tree in (("unet", trainer.frozen["unet"], towers["unet"]),
                               ("text_encoder", trainer.frozen["text_encoder"], towers["text"])):
        got = bridge.tree_state_dict(module)
        want = tckpt.flatten_tree(tree)
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].astype(np.float16).astype(np.float32),
                                          err_msg=f"{name} {k}")
    t = cfg["trainer"]
    jcfg = JTrainerConfig(**{k: v for k, v in t.items() if k in JTrainerConfig.__dataclass_fields__})
    assert trainer.cfg.lr == jcfg.accum_steps * (jcfg.dp or 1) * jcfg.batch_size * t["lr"] != t["lr"]


@pytest.fixture()
def cli(monkeypatch, tmp_path):
    """The CLI helpers with tiny towers, the tiny Arc2Face encoder and a
    tokenizer of their own; → (the module `_common_torch`, a PNG folder)."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import _common_torch

    text_cfg = tclip.CLIPTextConfig(**TEXT_KW)
    monkeypatch.setattr(_common_torch, "MODEL_CFGS", dict(
        unet_cfg=tunet.UNetConfig(**UNET_KW), vae_cfg=tvae.VAEConfig(**VAE_KW), text_cfg=text_cfg))
    monkeypatch.setattr(_common_torch, "ENCODER_KW", dict(
        text_cfg=text_cfg, sbg_cfg=SubjBasisConfig(clip=text_cfg)))
    monkeypatch.setattr("adaface_tpu_torch.inference.pipeline.default_tokenizer",
                        CLIPTokenizer.character_fallback)
    monkeypatch.setattr("adaface_tpu_torch.text.tokenizer.default_tokenizer",
                        CLIPTokenizer.character_fallback)
    pngs = tmp_path / "subject"
    pngs.mkdir()
    rs = np.random.RandomState(0)
    for i in range(2):
        timage.write_png(pngs / f"{i}.png", rs.randint(0, 256, (HW, HW, 3)).astype(np.uint8))
    return _common_torch, str(pngs)


def read_back(paths, n: int):
    assert len(paths) == n
    for p in paths:
        img = timage.read_png(p)
        assert img.shape == (HW, HW, 3) and img.dtype == np.uint8 and img.std() > 0


def test_infer_cli_writes_pngs(cli, tmp_path):
    """Random towers, then towers from a single file with an AdaFace
    checkpoint of the port's trainer: two 64x64 images in 2 steps each, and
    the grid."""
    from adaface_tpu_torch.train.checkpoint import save_adaface_ckpt
    import adaface_infer_torch

    _common, subject = cli
    argv = ["--subject", subject, "--device", "cpu", "--dtype", "f32", "--num_inference_steps",
            "2", "--num_images", "2", "--size", str(HW)]
    read_back(adaface_infer_torch.main(argv + ["--out_dir", str(tmp_path / "a")]), 2)
    assert timage.read_png(tmp_path / "a" / "grid.png").shape == (HW, 2 * HW, 3)

    path = str(tmp_path / "sd15.safetensors")
    write_single_file(path, TEXT_KW)
    gen = torch.Generator().manual_seed(5)
    enc = _common.build_wrapper(_common_args(_common, "cpu"), "text2img").id2ada_prompt_encoder
    sbg = enc.subj_basis_generator
    for p in sbg.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen))
    saved = {k: v for k, v in sbg.state_dict().items() if not k.startswith("clip.token")}
    ckpt = save_adaface_ckpt(str(tmp_path / "ckpt"), 3, {"joint": saved})
    read_back(adaface_infer_torch.main(argv + ["--out_dir", str(tmp_path / "b"), "--base_model",
                                               path, "--adaface_ckpt", ckpt]), 2)
    w = _common.build_wrapper(_common_args(_common, "cpu", base_model=path, adaface_ckpt=ckpt))
    got = w.id2ada_prompt_encoder.subj_basis_generator.state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())


def _common_args(common, device, **kw):
    import argparse

    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    args = ap.parse_args(["--device", device, "--dtype", "f32"])
    vars(args).update(kw)
    return args


def test_translate_cli_writes_pngs(cli, tmp_path):
    """A random identity onto two 64x64 PNGs (strength 0.5 of 4 steps: 2)."""
    import adaface_translate_torch

    _, subject = cli
    paths = adaface_translate_torch.main([
        "--randface", "--in_images", subject, "--device", "cpu", "--dtype", "f32",
        "--num_inference_steps", "4", "--strength", "0.5", "--out_dir", str(tmp_path / "t")])
    read_back(paths, 2)


def test_cli_refuses_the_pipelines_not_ported(cli):
    import adaface_infer_torch

    _, subject = cli
    for name in ("text2imgxl", "text2img3"):
        with pytest.raises(SystemExit, match="not ported"):
            adaface_infer_torch.main(["--subject", subject, "--device", "cpu",
                                      "--pipeline", name])
