"""Checkpoint layouts written from parameter trees: the inverses of the
converters' key tables, for tests and for `chip_smoke.py`.

A tree here is the JAX package's parameter layout as numpy (conv kernels
HWIO, dense weights [in, out]); a list may also be a dict keyed "0", "1", ...
(`ckpt_lib.unflatten_tree` of `core.bridge.tree_state_dict`). The writers
give the torch layouts the converters read: the CompVis/LDM single file of
SD1.5 (`sd_single_file`: `model.diffusion_model.*` with its LitEma
`model_ema.*` shadows and the schedule buffers, `first_stage_model.*`,
`cond_stage_model.transformer.*`), the diffusers VAE, HF CLIP text and
vision towers, ConsistentID's `ProjPlusModel` and the face-parsing BiSeNet.
"""

from __future__ import annotations

import numpy as np

from adaface_tpu_torch.tools.convert_ldm_unet import ldm_unet_key_pairs
from adaface_tpu_torch.tools.convert_sd import ema_key, export_unet_to_diffusers


def items(x):
    """A list's, or an int-keyed dict's, entries in order."""
    if isinstance(x, dict):
        return [x[k] for k in sorted(x, key=int)]
    return list(x)


def as_lists(tree):
    """Int-keyed dicts back to lists, all the way down."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [as_lists(v) for v in items(tree)]
        return {k: as_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_lists(v) for v in tree]
    return tree


class _Writer(dict):
    def conv(self, p, d, bias=True):
        self[f"{p}.weight"] = np.asarray(d["w"]).transpose(3, 2, 0, 1).copy()
        if bias:
            self[f"{p}.bias"] = np.asarray(d["b"])

    def linear(self, p, d, bias=True):
        self[f"{p}.weight"] = np.asarray(d["w"]).T.copy()
        if bias:
            self[f"{p}.bias"] = np.asarray(d["b"])

    def norm(self, p, d):
        self[f"{p}.weight"] = np.asarray(d["scale"])
        self[f"{p}.bias"] = np.asarray(d["bias"])

    def conv_as_linear(self, p, d):  # [1, 1, I, O] → [O, I]
        self[f"{p}.weight"] = np.asarray(d["w"])[0, 0].T.copy()
        self[f"{p}.bias"] = np.asarray(d["b"])


def unet_to_ldm(tree, cfg) -> dict:
    """The UNet tree → `model.diffusion_model.*` keys (LDM names)."""
    tree = as_lists(tree)
    for blk in tree["down_blocks"] + tree["up_blocks"]:
        blk.setdefault("attentions", [])  # a flat dict has no entry for an empty list
    df = export_unet_to_diffusers(tree, cfg)
    out = {}
    for ldm, name in ldm_unet_key_pairs(cfg):
        for suf in (".weight", ".bias"):
            if name + suf in df:
                out[f"model.diffusion_model.{ldm}{suf}"] = df.pop(name + suf)
    assert not df, f"UNet keys without an LDM name: {sorted(df)[:5]}"
    return out


def vae_to_ldm(tree) -> dict:
    """The VAE tree → CompVis `AutoencoderKL` keys (`encoder.down.0.block.0…`;
    the decoder's levels indexed from the highest resolution)."""
    w = _Writer()

    def res(p, d):
        w.norm(f"{p}.norm1", d["norm1"])
        w.conv(f"{p}.conv1", d["conv1"])
        w.norm(f"{p}.norm2", d["norm2"])
        w.conv(f"{p}.conv2", d["conv2"])
        if "nin_shortcut" in d:
            w.conv(f"{p}.nin_shortcut", d["nin_shortcut"])

    def attn(p, d):
        w.norm(f"{p}.norm", d["norm"])
        for k in ("q", "k", "v", "proj_out"):
            w.conv(f"{p}.{k}", d[k])

    def mid(p, d):
        res(f"{p}.mid.block_1", d["mid"]["block_1"])
        attn(f"{p}.mid.attn_1", d["mid"]["attn_1"])
        res(f"{p}.mid.block_2", d["mid"]["block_2"])

    enc, dec = tree["encoder"], tree["decoder"]
    w.conv("encoder.conv_in", enc["conv_in"])
    for i, level in enumerate(items(enc["down"])):
        for j, blk in enumerate(items(level["blocks"])):
            res(f"encoder.down.{i}.block.{j}", blk)
        if "downsample" in level:
            w.conv(f"encoder.down.{i}.downsample.conv", level["downsample"])
    mid("encoder", enc)
    w.norm("encoder.norm_out", enc["norm_out"])
    w.conv("encoder.conv_out", enc["conv_out"])
    w.conv("decoder.conv_in", dec["conv_in"])
    mid("decoder", dec)
    ups = items(dec["up"])
    for s, level in enumerate(ups):
        i = len(ups) - 1 - s
        for j, blk in enumerate(items(level["blocks"])):
            res(f"decoder.up.{i}.block.{j}", blk)
        if "upsample" in level:
            w.conv(f"decoder.up.{i}.upsample.conv", level["upsample"])
    w.norm("decoder.norm_out", dec["norm_out"])
    w.conv("decoder.conv_out", dec["conv_out"])
    w.conv("quant_conv", tree["quant_conv"])
    w.conv("post_quant_conv", tree["post_quant_conv"])
    return dict(w)


def vae_to_diffusers(tree) -> dict:
    """The VAE tree → diffusers `AutoencoderKL` keys (attention as linear
    to_q / to_k / to_v / to_out.0, up blocks in execution order)."""
    w = _Writer()

    def res(p, d):
        w.norm(f"{p}.norm1", d["norm1"])
        w.conv(f"{p}.conv1", d["conv1"])
        w.norm(f"{p}.norm2", d["norm2"])
        w.conv(f"{p}.conv2", d["conv2"])
        if "nin_shortcut" in d:
            w.conv(f"{p}.conv_shortcut", d["nin_shortcut"])

    def mid(p, d):
        res(f"{p}.mid_block.resnets.0", d["mid"]["block_1"])
        a, pa = d["mid"]["attn_1"], f"{p}.mid_block.attentions.0"
        w.norm(f"{pa}.group_norm", a["norm"])
        for k, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("proj_out", "to_out.0")):
            w.conv_as_linear(f"{pa}.{name}", a[k])
        res(f"{p}.mid_block.resnets.1", d["mid"]["block_2"])

    enc, dec = tree["encoder"], tree["decoder"]
    w.conv("encoder.conv_in", enc["conv_in"])
    for i, level in enumerate(items(enc["down"])):
        for j, blk in enumerate(items(level["blocks"])):
            res(f"encoder.down_blocks.{i}.resnets.{j}", blk)
        if "downsample" in level:
            w.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", level["downsample"])
    mid("encoder", enc)
    w.norm("encoder.conv_norm_out", enc["norm_out"])
    w.conv("encoder.conv_out", enc["conv_out"])
    w.conv("decoder.conv_in", dec["conv_in"])
    mid("decoder", dec)
    for i, level in enumerate(items(dec["up"])):
        for j, blk in enumerate(items(level["blocks"])):
            res(f"decoder.up_blocks.{i}.resnets.{j}", blk)
        if "upsample" in level:
            w.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", level["upsample"])
    w.norm("decoder.conv_norm_out", dec["norm_out"])
    w.conv("decoder.conv_out", dec["conv_out"])
    w.conv("quant_conv", tree["quant_conv"])
    w.conv("post_quant_conv", tree["post_quant_conv"])
    return dict(w)


def _clip_layers(w: _Writer, stem: str, layers) -> None:
    for i, layer in enumerate(items(layers)):
        p = f"{stem}.layers.{i}"
        w.norm(f"{p}.layer_norm1", layer["ln1"])
        for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            w.linear(f"{p}.self_attn.{hf}", layer["attn"][name])
        w.norm(f"{p}.layer_norm2", layer["ln2"])
        w.linear(f"{p}.mlp.fc1", layer["mlp"]["fc1"])
        w.linear(f"{p}.mlp.fc2", layer["mlp"]["fc2"])


def text_to_hf(tree, prefix: str = "text_model.") -> dict:
    """The CLIP text tree → HF `CLIPTextModel` keys."""
    w = _Writer()
    w[f"{prefix}embeddings.token_embedding.weight"] = np.asarray(tree["token_embedding"])
    w[f"{prefix}embeddings.position_embedding.weight"] = np.asarray(tree["position_embedding"])
    _clip_layers(w, f"{prefix}encoder", tree["layers"])
    w.norm(f"{prefix}final_layer_norm", tree["final_ln"])
    if "text_projection" in tree:
        w.linear("text_projection", tree["text_projection"], bias=False)
    return dict(w)


def vision_to_hf(tree, prefix: str = "vision_model.") -> dict:
    """The CLIP vision tree → HF `CLIPVisionModel(WithProjection)` keys."""
    w = _Writer()
    w[f"{prefix}embeddings.class_embedding"] = np.asarray(tree["class_embedding"])
    w[f"{prefix}embeddings.patch_embedding.weight"] = np.asarray(tree["patch_embedding"])
    w[f"{prefix}embeddings.position_embedding.weight"] = np.asarray(tree["position_embedding"])
    w.norm(f"{prefix}pre_layrnorm", tree["pre_ln"])
    _clip_layers(w, f"{prefix}encoder", tree["layers"])
    w.norm(f"{prefix}post_layernorm", tree["post_ln"])
    if "visual_projection" in tree:
        w.linear("visual_projection", tree["visual_projection"], bias=False)
    return dict(w)


def proj_plus_to_torch(tree) -> dict:
    """The ProjPlus tree → ConsistentID's `ProjPlusModel` keys."""
    w, r = _Writer(), "perceiver_resampler"
    w.linear("proj.0", tree["proj"]["fc1"])
    w.linear("proj.2", tree["proj"]["fc2"])
    w.norm("norm", tree["norm"])
    res = tree["resampler"]
    w.linear(f"{r}.proj_in", res["proj_in"])
    w.linear(f"{r}.proj_out", res["proj_out"])
    w.norm(f"{r}.norm_out", res["norm_out"])
    for i, layer in enumerate(items(res["layers"])):
        a, f = f"{r}.layers.{i}.0", f"{r}.layers.{i}.1"
        w.norm(f"{a}.norm1", layer["attn"]["ln_x"])
        w.norm(f"{a}.norm2", layer["attn"]["ln_lat"])
        for name in ("to_q", "to_kv", "to_out"):
            w.linear(f"{a}.{name}", layer["attn"][name], bias=False)
        w.norm(f"{f}.0", layer["ff"]["ln"])
        w.linear(f"{f}.1", layer["ff"]["fc1"], bias=False)
        w.linear(f"{f}.3", layer["ff"]["fc2"], bias=False)
    return dict(w)


def bisenet_to_torch(tree) -> dict:
    """The BiSeNet tree → the face-parsing checkpoint's keys
    (`79999_iter.pth`)."""
    w = _Writer()

    def bn(p, d):
        w.norm(p, d)
        w[f"{p}.running_mean"] = np.asarray(d["mean"])
        w[f"{p}.running_var"] = np.asarray(d["var"])

    def cbr(p, d):
        w.conv(f"{p}.conv", d["conv"], bias=False)
        bn(f"{p}.bn", d["bn"])

    def head(p, d):
        cbr(f"{p}.conv", d["conv"])
        w.conv(f"{p}.conv_out", d["cls"], bias=False)

    cp = "cp.resnet"
    w.conv(f"{cp}.conv1", tree["conv1"], bias=False)
    bn(f"{cp}.bn1", tree["bn1"])
    for li, layer in enumerate(items(tree["layers"]), start=1):
        for bi, blk in enumerate(items(layer)):
            p = f"{cp}.layer{li}.{bi}"
            for k in ("1", "2"):
                w.conv(f"{p}.conv{k}", blk[f"conv{k}"], bias=False)
                bn(f"{p}.bn{k}", blk[f"bn{k}"])
            if "down" in blk:
                w.conv(f"{p}.downsample.0", blk["down"]["conv"], bias=False)
                bn(f"{p}.downsample.1", blk["down"]["bn"])
    for arm in ("arm16", "arm32"):
        cbr(f"cp.{arm}.conv", tree[arm]["conv"])
        w.conv(f"cp.{arm}.conv_atten", tree[arm]["atten"]["conv"], bias=False)
        bn(f"cp.{arm}.bn_atten", tree[arm]["atten"]["bn"])
    for name in ("conv_head16", "conv_head32", "conv_avg"):
        cbr(f"cp.{name}", tree[name])
    cbr("ffm.convblk", tree["ffm"]["convblk"])
    w.conv("ffm.conv1", tree["ffm"]["conv1"], bias=False)
    w.conv("ffm.conv2", tree["ffm"]["conv2"], bias=False)
    for name, key in (("conv_out", "out"), ("conv_out16", "out16"), ("conv_out32", "out32")):
        head(name, tree[key])
    return dict(w)


def schedule_buffers(n: int = 1000) -> dict:
    """The LDM schedule's buffers a single file carries (never converted)."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n, dtype=np.float64) ** 2
    cum = np.cumprod(1.0 - betas)
    return {"betas": betas, "alphas_cumprod": cum,
            "alphas_cumprod_prev": np.append(1.0, cum[:-1]),
            "sqrt_alphas_cumprod": np.sqrt(cum), "log_one_minus_alphas_cumprod": np.log(1 - cum)}


def sd_single_file(unet_tree, vae_tree, text_tree, unet_cfg, ema_unet_tree=None,
                   dtype=np.float16) -> dict:
    """An SD1.5 single file's state dict in the LDM layout: the UNet under
    `model.diffusion_model.`, its LitEma shadows under `model_ema.` (from
    `ema_unet_tree`, else the same weights) with `model_ema.decay` /
    `num_updates`, the VAE under `first_stage_model.`, the text tower under
    `cond_stage_model.transformer.`, and the schedule buffers; floating
    tensors in `dtype`."""
    unet = unet_to_ldm(unet_tree, unet_cfg)
    ema = unet_to_ldm(ema_unet_tree if ema_unet_tree is not None else unet_tree, unet_cfg)
    sd = dict(unet)
    sd.update({ema_key(k): v for k, v in ema.items()})
    sd.update({f"first_stage_model.{k}": v for k, v in vae_to_ldm(vae_tree).items()})
    sd.update({f"cond_stage_model.transformer.{k}": v for k, v in text_to_hf(text_tree).items()})
    sd = {k: np.asarray(v).astype(dtype) for k, v in sd.items()}
    sd.update({k: v.astype(np.float32) for k, v in schedule_buffers().items()})
    sd["model_ema.decay"] = np.asarray(0.9999, np.float32)
    sd["model_ema.num_updates"] = np.asarray(1000, np.int32)
    return sd
