"""SD1.5 UNet and VAE checkpoints → parameter trees, and trees → modules.

Counterpart of `adaface_tpu/tools/convert_sd.py`, in numpy: the same
functions return the same trees (nested dicts and lists of numpy arrays,
the JAX package's layout: conv kernels HWIO, dense weights [in, out]), so
one test can hold them leaf for leaf against the JAX converters. Arrays are
canonicalized as `jax.numpy.asarray` does with 64-bit types off: float64
and int64 become float32 and int32. The trees land in the port's modules
through `core/bridge.py` (`load_pipeline_modules`).

Handles diffusers `UNet2DConditionModel` state dicts (`convert_unet`, and
`export_unet_to_diffusers` back), CompVis/LDM `AutoencoderKL` ones
(`first_stage_model.*` of a single file, `convert_vae_ldm`), diffusers
`AutoencoderKL` ones (`convert_vae_diffusers`), EMA shadows
(`apply_ema_weights`) and whole single files (`load_sd_towers`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from adaface_tpu_torch.models.unet import SD15_UNET, UNetConfig
from adaface_tpu_torch.models.vae import SD_VAE, VAEConfig

# the 64-bit types `jax.numpy.asarray` narrows with x64 off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def arr(a) -> np.ndarray:
    """`a` as a numpy array of the dtype `jax.numpy.asarray` would give it."""
    a = np.asarray(a)
    return a.astype(_NARROW[a.dtype]) if a.dtype in _NARROW else a


def _cw(a):  # conv weight [O, I, H, W] → HWIO
    return arr(np.asarray(a).transpose(2, 3, 1, 0).copy())


def _lw(a):  # linear weight [O, I] → [I, O]
    return arr(np.asarray(a).T.copy())


def _conv(sd, p):
    return {"w": _cw(sd[f"{p}.weight"]), "b": arr(sd[f"{p}.bias"])}


def _dense(sd, p):
    return {"w": _lw(sd[f"{p}.weight"]), "b": arr(sd[f"{p}.bias"])}


def _norm(sd, p):
    return {"scale": arr(sd[f"{p}.weight"]), "bias": arr(sd[f"{p}.bias"])}


# ---------------------------------------------------------------------------
# UNet (diffusers naming)
# ---------------------------------------------------------------------------


def _unet_resnet(sd, p):
    out = {"norm1": _norm(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "time_emb_proj": _dense(sd, f"{p}.time_emb_proj"),
           "norm2": _norm(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _unet_attention(sd, p):
    return {"q": {"w": _lw(sd[f"{p}.to_q.weight"])}, "k": {"w": _lw(sd[f"{p}.to_k.weight"])},
            "v": {"w": _lw(sd[f"{p}.to_v.weight"])}, "o": _dense(sd, f"{p}.to_out.0")}


def _proj_conv(sd, p):
    """proj_in / proj_out: a 1x1 conv, or a linear one (SDXL's
    use_linear_projection) stored as a 1x1 conv."""
    w = np.asarray(sd[f"{p}.weight"])
    if w.ndim == 2:  # [O, I] → [1, 1, I, O]
        return {"w": arr(w.T[None, None].copy()), "b": arr(sd[f"{p}.bias"])}
    return _conv(sd, p)


def _unet_transformer_block(sd, b):
    return {"norm1": _norm(sd, f"{b}.norm1"), "attn1": _unet_attention(sd, f"{b}.attn1"),
            "norm2": _norm(sd, f"{b}.norm2"), "attn2": _unet_attention(sd, f"{b}.attn2"),
            "norm3": _norm(sd, f"{b}.norm3"),
            "ff": {"proj_in": _dense(sd, f"{b}.ff.net.0.proj"),
                   "proj_out": _dense(sd, f"{b}.ff.net.2")}}


def _unet_transformer(sd, p):
    depth = 0
    while f"{p}.transformer_blocks.{depth}.norm1.weight" in sd:
        depth += 1
    out = {"norm": _norm(sd, f"{p}.norm"), "proj_in": _proj_conv(sd, f"{p}.proj_in"),
           "proj_out": _proj_conv(sd, f"{p}.proj_out")}
    blocks = [_unet_transformer_block(sd, f"{p}.transformer_blocks.{i}") for i in range(depth)]
    if depth == 1:
        out["block"] = blocks[0]
    else:
        out["blocks"] = blocks
    return out


def convert_unet(sd: Mapping[str, np.ndarray], cfg: UNetConfig = SD15_UNET) -> dict:
    """A diffusers UNet state dict → the UNet tree (`convert_sd.py:120`)."""
    params = {
        "conv_in": _conv(sd, "conv_in"),
        "time_mlp": {"fc1": _dense(sd, "time_embedding.linear_1"),
                     "fc2": _dense(sd, "time_embedding.linear_2")},
        "down_blocks": [], "up_blocks": [],
        "conv_norm_out": _norm(sd, "conv_norm_out"), "conv_out": _conv(sd, "conv_out"),
    }
    for bi in range(len(cfg.block_channels)):
        blk = {"resnets": [], "attentions": []}
        for li in range(cfg.layers_per_block):
            blk["resnets"].append(_unet_resnet(sd, f"down_blocks.{bi}.resnets.{li}"))
            if cfg.down_has_attn[bi]:
                blk["attentions"].append(_unet_transformer(sd, f"down_blocks.{bi}.attentions.{li}"))
        if f"down_blocks.{bi}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"down_blocks.{bi}.downsamplers.0.conv")
        params["down_blocks"].append(blk)
    params["mid"] = {"resnet1": _unet_resnet(sd, "mid_block.resnets.0"),
                     "attention": _unet_transformer(sd, "mid_block.attentions.0"),
                     "resnet2": _unet_resnet(sd, "mid_block.resnets.1")}
    if "add_embedding.linear_1.weight" in sd:  # SDXL's text_time conditioning
        params["add_embedding"] = {"fc1": _dense(sd, "add_embedding.linear_1"),
                                   "fc2": _dense(sd, "add_embedding.linear_2")}
    for bi in range(len(cfg.block_channels)):
        blk = {"resnets": [], "attentions": []}
        for li in range(cfg.layers_per_block + 1):
            blk["resnets"].append(_unet_resnet(sd, f"up_blocks.{bi}.resnets.{li}"))
            if cfg.up_has_attn[bi]:
                blk["attentions"].append(_unet_transformer(sd, f"up_blocks.{bi}.attentions.{li}"))
        if f"up_blocks.{bi}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"up_blocks.{bi}.upsamplers.0.conv")
        params["up_blocks"].append(blk)
    return params


def export_unet_to_diffusers(params: dict, cfg: UNetConfig = SD15_UNET) -> dict:
    """The inverse of `convert_unet` (`convert_sd.py:165`): numpy arrays in
    torch's [O, I, ...] layouts under diffusers names."""
    sd: dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1).copy()
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_dense(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"]).T.copy()
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_norm(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def put_resnet(prefix, p):
        put_norm(f"{prefix}.norm1", p["norm1"])
        put_conv(f"{prefix}.conv1", p["conv1"])
        put_dense(f"{prefix}.time_emb_proj", p["time_emb_proj"])
        put_norm(f"{prefix}.norm2", p["norm2"])
        put_conv(f"{prefix}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            put_conv(f"{prefix}.conv_shortcut", p["conv_shortcut"])

    def put_attn(prefix, p):
        for name in ("q", "k", "v"):
            sd[f"{prefix}.to_{name}.weight"] = np.asarray(p[name]["w"]).T.copy()
        put_dense(f"{prefix}.to_out.0", p["o"])

    def put_transformer(prefix, p):
        put_norm(f"{prefix}.norm", p["norm"])
        put_conv(f"{prefix}.proj_in", p["proj_in"])
        for i, blk in enumerate(p["blocks"] if "blocks" in p else [p["block"]]):
            b = f"{prefix}.transformer_blocks.{i}"
            put_norm(f"{b}.norm1", blk["norm1"])
            put_attn(f"{b}.attn1", blk["attn1"])
            put_norm(f"{b}.norm2", blk["norm2"])
            put_attn(f"{b}.attn2", blk["attn2"])
            put_norm(f"{b}.norm3", blk["norm3"])
            put_dense(f"{b}.ff.net.0.proj", blk["ff"]["proj_in"])
            put_dense(f"{b}.ff.net.2", blk["ff"]["proj_out"])
        put_conv(f"{prefix}.proj_out", p["proj_out"])

    put_conv("conv_in", params["conv_in"])
    put_dense("time_embedding.linear_1", params["time_mlp"]["fc1"])
    put_dense("time_embedding.linear_2", params["time_mlp"]["fc2"])
    for bi, blk in enumerate(params["down_blocks"]):
        for li, res in enumerate(blk["resnets"]):
            put_resnet(f"down_blocks.{bi}.resnets.{li}", res)
        for li, att in enumerate(blk["attentions"]):
            put_transformer(f"down_blocks.{bi}.attentions.{li}", att)
        if "downsample" in blk:
            put_conv(f"down_blocks.{bi}.downsamplers.0.conv", blk["downsample"])
    put_resnet("mid_block.resnets.0", params["mid"]["resnet1"])
    put_transformer("mid_block.attentions.0", params["mid"]["attention"])
    put_resnet("mid_block.resnets.1", params["mid"]["resnet2"])
    if "add_embedding" in params:
        put_dense("add_embedding.linear_1", params["add_embedding"]["fc1"])
        put_dense("add_embedding.linear_2", params["add_embedding"]["fc2"])
    for bi, blk in enumerate(params["up_blocks"]):
        for li, res in enumerate(blk["resnets"]):
            put_resnet(f"up_blocks.{bi}.resnets.{li}", res)
        for li, att in enumerate(blk["attentions"]):
            put_transformer(f"up_blocks.{bi}.attentions.{li}", att)
        if "upsample" in blk:
            put_conv(f"up_blocks.{bi}.upsamplers.0.conv", blk["upsample"])
    put_norm("conv_norm_out", params["conv_norm_out"])
    put_conv("conv_out", params["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_resblock(sd, p, shortcut="nin_shortcut"):
    out = {"norm1": _norm(sd, f"{p}.norm1"), "conv1": _conv(sd, f"{p}.conv1"),
           "norm2": _norm(sd, f"{p}.norm2"), "conv2": _conv(sd, f"{p}.conv2")}
    if f"{p}.{shortcut}.weight" in sd:
        out["nin_shortcut"] = _conv(sd, f"{p}.{shortcut}")
    return out


def _vae_attn(sd, p):
    return {"norm": _norm(sd, f"{p}.norm"), "q": _conv(sd, f"{p}.q"), "k": _conv(sd, f"{p}.k"),
            "v": _conv(sd, f"{p}.v"), "proj_out": _conv(sd, f"{p}.proj_out")}


def convert_vae_ldm(sd: Mapping[str, np.ndarray], cfg: VAEConfig = SD_VAE) -> dict:
    """A CompVis/LDM AutoencoderKL state dict (`encoder.down.0.block.0…`,
    perhaps under `first_stage_model.`) → the VAE tree (`convert_sd.py:266`)."""
    if any(k.startswith("first_stage_model.") for k in sd):
        sd = {k[len("first_stage_model."):]: v for k, v in sd.items()
              if k.startswith("first_stage_model.")}
    n_levels = len(cfg.ch_mult)
    enc = {"conv_in": _conv(sd, "encoder.conv_in"), "down": []}
    for i in range(n_levels):
        level = {"blocks": [_vae_resblock(sd, f"encoder.down.{i}.block.{j}")
                            for j in range(cfg.num_res_blocks)]}
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            level["downsample"] = _conv(sd, f"encoder.down.{i}.downsample.conv")
        enc["down"].append(level)
    enc["mid"] = {"block_1": _vae_resblock(sd, "encoder.mid.block_1"),
                  "attn_1": _vae_attn(sd, "encoder.mid.attn_1"),
                  "block_2": _vae_resblock(sd, "encoder.mid.block_2")}
    enc["norm_out"] = _norm(sd, "encoder.norm_out")
    enc["conv_out"] = _conv(sd, "encoder.conv_out")
    dec = {"conv_in": _conv(sd, "decoder.conv_in"),
           "mid": {"block_1": _vae_resblock(sd, "decoder.mid.block_1"),
                   "attn_1": _vae_attn(sd, "decoder.mid.attn_1"),
                   "block_2": _vae_resblock(sd, "decoder.mid.block_2")},
           "up": []}
    # CompVis indexes decoder.up by level (0 = the highest resolution); the
    # tree keeps them in execution order, reversed
    for i in reversed(range(n_levels)):
        level = {"blocks": [_vae_resblock(sd, f"decoder.up.{i}.block.{j}")
                            for j in range(cfg.num_res_blocks + 1)]}
        if f"decoder.up.{i}.upsample.conv.weight" in sd:
            level["upsample"] = _conv(sd, f"decoder.up.{i}.upsample.conv")
        dec["up"].append(level)
    dec["norm_out"] = _norm(sd, "decoder.norm_out")
    dec["conv_out"] = _conv(sd, "decoder.conv_out")
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(sd, "quant_conv"),
            "post_quant_conv": _conv(sd, "post_quant_conv")}


def convert_vae_diffusers(sd: Mapping[str, np.ndarray], cfg: VAEConfig = SD_VAE) -> dict:
    """A diffusers AutoencoderKL state dict (`encoder.down_blocks.{i}.
    resnets.{j}…`, attention as linear to_q / to_k / to_v) → the VAE tree
    (`convert_sd.py:320`)."""
    n_levels = len(cfg.ch_mult)

    def resblock(p):
        return _vae_resblock(sd, p, shortcut="conv_shortcut")

    def attn(p):
        def lin_as_conv(name):  # [O, I] → [1, 1, I, O]
            w = np.asarray(sd[f"{p}.{name}.weight"])
            return {"w": arr(w.T[None, None].copy()), "b": arr(sd[f"{p}.{name}.bias"])}

        return {"norm": _norm(sd, f"{p}.group_norm"), "q": lin_as_conv("to_q"),
                "k": lin_as_conv("to_k"), "v": lin_as_conv("to_v"),
                "proj_out": lin_as_conv("to_out.0")}

    enc = {"conv_in": _conv(sd, "encoder.conv_in"), "down": []}
    for i in range(n_levels):
        level = {"blocks": [resblock(f"encoder.down_blocks.{i}.resnets.{j}")
                            for j in range(cfg.num_res_blocks)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            level["downsample"] = _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
        enc["down"].append(level)
    enc["mid"] = {"block_1": resblock("encoder.mid_block.resnets.0"),
                  "attn_1": attn("encoder.mid_block.attentions.0"),
                  "block_2": resblock("encoder.mid_block.resnets.1")}
    enc["norm_out"] = _norm(sd, "encoder.conv_norm_out")
    enc["conv_out"] = _conv(sd, "encoder.conv_out")
    dec = {"conv_in": _conv(sd, "decoder.conv_in"),
           "mid": {"block_1": resblock("decoder.mid_block.resnets.0"),
                   "attn_1": attn("decoder.mid_block.attentions.0"),
                   "block_2": resblock("decoder.mid_block.resnets.1")},
           "up": []}
    for i in range(n_levels):  # diffusers keeps the up blocks in execution order
        level = {"blocks": [resblock(f"decoder.up_blocks.{i}.resnets.{j}")
                            for j in range(cfg.num_res_blocks + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            level["upsample"] = _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        dec["up"].append(level)
    dec["norm_out"] = _norm(sd, "decoder.conv_norm_out")
    dec["conv_out"] = _conv(sd, "decoder.conv_out")
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(sd, "quant_conv"),
            "post_quant_conv": _conv(sd, "post_quant_conv")}


# ---------------------------------------------------------------------------
# single files
# ---------------------------------------------------------------------------


def ema_key(key: str) -> str:
    """The LitEma name of `model.diffusion_model.*` weight `key`: `model_ema.`
    + the name without `model.` and without dots (`model.diffusion_model.
    out.2.bias` → `model_ema.diffusion_modelout2bias`)."""
    return "model_ema." + key[len("model."):].replace(".", "")


def apply_ema_weights(sd: Mapping[str, np.ndarray]) -> dict:
    """`model.diffusion_model.*` weights replaced by their `model_ema.*`
    shadows (`convert_sd.py:401`); the shadows' bookkeeping
    (`model_ema.decay`, `num_updates`) is ignored."""
    out = dict(sd)
    n = 0
    for k in sd:
        if k.startswith("model.diffusion_model.") and ema_key(k) in sd:
            out[k] = sd[ema_key(k)]
            n += 1
    if n == 0:
        raise ValueError("prefer_ema=True but no model_ema.* shadows found")
    return out


def _cast_fp32(tree):
    if isinstance(tree, dict):
        return {k: _cast_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_fp32(v) for v in tree]
    if np.issubdtype(tree.dtype, np.floating):
        return tree.astype(np.float32)
    return tree


def load_sd_towers(path: str, unet_cfg: UNetConfig = SD15_UNET, vae_cfg: VAEConfig = SD_VAE,
                   prefer_ema: bool = False, cast_fp32: bool = True) -> dict:
    """An SD1.5 checkpoint on disk → the trees of every tower it holds
    (`convert_sd.py:422`): `unet`, `vae`, `text_encoder` with `text_cfg`.

    Takes the LDM single-file layout (`v1-5-pruned.ckpt` and its
    `.safetensors` twins; `model.diffusion_model.`, `first_stage_model.`,
    `cond_stage_model.transformer.`) or a bare diffusers UNet state dict.
    `prefer_ema` takes the UNet's `model_ema.*` shadows; `cast_fp32`
    upcasts floating leaves to fp32."""
    from adaface_tpu_torch.tools.ckpt_lib import extract_subtree, load_state_dict
    from adaface_tpu_torch.tools.convert_clip import convert_text_model
    from adaface_tpu_torch.tools.convert_ldm_unet import convert_ldm_unet

    # the schedule buffers and the EMA bookkeeping are never matched
    sd = {k: v for k, v in load_state_dict(path).items() if hasattr(v, "shape")}
    if prefer_ema:
        sd = apply_ema_weights(sd)
    out: dict = {}
    if any(k.startswith("model.diffusion_model.") for k in sd):
        out["unet"] = convert_ldm_unet(sd, unet_cfg)
        if any(k.startswith("first_stage_model.") for k in sd):
            out["vae"] = convert_vae_ldm(extract_subtree(sd, "first_stage_model."), vae_cfg)
        if any(k.startswith("cond_stage_model.transformer.") for k in sd):
            te = extract_subtree(sd, "cond_stage_model.transformer.")
            out["text_encoder"], out["text_cfg"] = convert_text_model(te)
    else:
        out["unet"] = convert_unet(sd, unet_cfg)
    if cast_fp32:
        out = {k: v if k == "text_cfg" else _cast_fp32(v) for k, v in out.items()}
    return out


def load_module(make, tree, device, dtype) -> torch.nn.Module:
    """`make()` on the meta device, materialised on `device` in `dtype` and
    loaded from the tree through `core.bridge.load` (strict), frozen; the
    buffers no state dict holds refilled (`reset_buffers`)."""
    from adaface_tpu_torch.core import bridge

    with torch.device("meta"):
        module = make()
    module = bridge.load(module.to_empty(device=device).to(dtype), tree)
    for m in module.modules():
        if hasattr(m, "reset_buffers"):
            m.reset_buffers()
    return module


def load_pipeline_modules(towers: dict, device, dtype=torch.bfloat16, tokenizer=None,
                          unet_cfg: UNetConfig = SD15_UNET, vae_cfg: VAEConfig = SD_VAE,
                          base=None):
    """`load_sd_towers`' output → `PipelineModules` on `device` in `dtype`:
    the UNet, the VAE's decoder and encoder and the CLIP text tower from the
    trees (`scripts/_common.py:_load_base_model`); a tower the file lacks is
    taken from `base` (a `PipelineModules`), or raises without one."""
    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.inference.pipeline import PipelineModules
    from adaface_tpu_torch.models.clip import CLIPTextModel
    from adaface_tpu_torch.models.unet import UNet2DConditionModel
    from adaface_tpu_torch.models.vae import VAEDecoder, VAEEncoder
    from adaface_tpu_torch.text.tokenizer import default_tokenizer

    def need(name):
        if base is None:
            raise ValueError(f"the checkpoint has no {name} and no base modules were given")
        return getattr(base, name)

    kw = {}
    if "unet" in towers:
        kw["unet"] = load_module(lambda: UNet2DConditionModel(unet_cfg), towers["unet"], device,
                                 dtype)
    else:
        kw["unet"] = need("unet")
    if "vae" in towers:
        kw["vae"] = load_module(lambda: VAEDecoder(vae_cfg),
                                bridge.vae_decoder_tree(towers["vae"]), device, dtype)
        kw["vae_encoder"] = load_module(lambda: VAEEncoder(vae_cfg),
                                        bridge.vae_encoder_tree(towers["vae"]), device, dtype)
    else:
        kw["vae"], kw["vae_encoder"] = need("vae"), need("vae_encoder")
    if "text_encoder" in towers:
        kw["text_encoder"] = load_module(lambda: CLIPTextModel(towers["text_cfg"]),
                                         towers["text_encoder"], device, dtype)
    else:
        kw["text_encoder"] = need("text_encoder")
    tokenizer = tokenizer or (base.tokenizer if base is not None else default_tokenizer())
    return PipelineModules(tokenizer=tokenizer, **kw)
