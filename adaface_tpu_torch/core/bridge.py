"""Carry the JAX package's parameter pytrees into the port's modules.

The port's modules mirror the JAX pytrees key for key (`down_blocks.0.
resnets.1.conv1` is `p["down_blocks"][0]["resnets"][1]["conv1"]`), so the
bridge is one walk over the tree with these leaf rules:

    w      4-D HWIO conv kernel  → weight, OIHW
    w      2-D [in, out] dense   → weight, [out, in]
    b                            → bias
    scale  (norm)                → weight
    mean, var  (batch norm)      → running_mean, running_var buffers
    other leaves (embedding tables, bias of norms, layer weights) as they are

Where the module keeps several projections of one input as one weight
(`attn1.qkv`, `attn2.kv` of the UNet), `load` stacks the tree's separate
`q`, `k`, `v` leaves into it. A CLIP tower's layers are built at the K/V
widths the tree holds (MKV attention, `models.clip.fit_kv_widths_`) before
they load. The video UNet's motion modules (`models.motion.MotionModules`)
load `init_motion_params`' tree, or the AnimateDiff converter's
(`tools.convert_motion`), by the same walk (q, k, v into `qkv`). The GMA
flow network's tree (`models.gma.convert_gma_state_dict`, or
`init_gma_params`') loads into `models.gma.GMA` by the same rules: its
instance norms hold nothing, its batch norms their statistics.

The ViT's tree (`models.vit`) keeps its patch kernel OIHW: `vit_tree` re-lays
it as HWIO before `load`.

A tree of `quantize_unet_params` (`adaface_tpu/ops/quant.py:108`) loads with
`load_quantized`: each node with `w_q` becomes the port's `Int8Conv2d` /
`Int8Linear`, its HWIO `w_q` → [O, kh, kw, I] and IO → [O, I] (int8), its
`w_scale` as it is; `tree_state_dict` writes them back in JAX's layouts.

The UNet's adapters (`attn_lora`, `ffn_lora`) go through `lora_state_dict`
and back through `lora_tree`: a dense `a` [in, r] / `b` [r, out] becomes
`lora_a` [r, in] / `lora_b` [out, r], a conv `a` HWIO [3, 3, in, r] / `b`
[1, 1, r, out] becomes OIHW, `mag` becomes `magnitude`.

Leaves may be numpy arrays or anything `numpy.asarray` takes (JAX arrays
included); the bridge itself never imports JAX.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

# batch-norm statistics leaves → the buffers torch's BatchNorm names so
BN_STATS = {"mean": "running_mean", "var": "running_var"}
# SubjBasisGenerator buffers the port recomputes from the tokenizer and the
# embedding tables instead of loading them (`subj_basis_generator.py:131-145`)
SBG_DERIVED = ("template_ids", "id_start", "pad_embeddings")


def _walk(tree: Any, prefix: str) -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _walk(sub, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _leaf(name: str, value) -> tuple[str, torch.Tensor]:
    a = np.asarray(value)
    head, _, leaf = name.rpartition(".")
    if leaf == "w":
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        leaf = "weight"
    elif leaf == "w_q":  # int8: HWIO → [O, kh, kw, I], IO → [O, I]
        a = a.transpose(3, 0, 1, 2) if a.ndim == 4 else a.T
    elif leaf == "b":
        leaf = "bias"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf in BN_STATS:
        leaf = BN_STATS[leaf]
    key = f"{head}.{leaf}" if head else leaf
    return key, torch.from_numpy(np.array(a))  # a writable copy


def state_dict(tree: Any) -> dict[str, torch.Tensor]:
    """JAX param pytree → torch state_dict of the mirroring port module."""
    return dict(_leaf(name, value) for name, value in _walk(tree, ""))


def fuse_projections(sd: dict, ref: dict) -> dict:
    """Stack `x.q.weight`, `x.k.weight`, `x.v.weight` of `sd` into the fused
    weights `x.qkv.weight` / `x.kv.weight` that `ref` (the module's own
    state dict) has in their place."""
    sd = dict(sd)
    for key in ref:
        head, _, leaf = key.rpartition(".")
        prefix, _, name = head.rpartition(".")
        parts = [f"{prefix}.{p}.{leaf}" for p in name]
        if name in ("qkv", "kv") and key not in sd and all(p in sd for p in parts):
            sd[key] = torch.cat([sd.pop(p) for p in parts], dim=0)
    return sd


def load(module: nn.Module, tree: Any) -> nn.Module:
    """Load a JAX pytree into `module` (strict: every key, every shape);
    returns it frozen and in eval mode, as `core.params.build` does."""
    from adaface_tpu_torch.models.clip import fit_kv_widths_

    sd = state_dict(tree)
    fit_kv_widths_(module, sd)
    ref = module.state_dict()
    sd = fuse_projections(sd, ref)
    module.load_state_dict({k: v.to(ref[k].dtype) if k in ref else v
                            for k, v in sd.items()}, strict=True)
    return module.requires_grad_(False).eval()


def load_quantized(module: nn.Module, tree: Any) -> nn.Module:
    """Load a JAX tree of `quantize_unet_params` into `module` (a UNet built
    at its config): each layer whose node holds `w_q` is first swapped, in
    `module`, for an `Int8Conv2d` / `Int8Linear`, then everything loads as
    `load` loads it."""
    from adaface_tpu_torch.ops.quant import Int8Conv2d, Int8Linear

    for name, _ in _walk(tree, ""):
        head, _, leaf = name.rpartition(".")
        if leaf == "w_q":
            parent_name, _, child = head.rpartition(".")
            parent = module.get_submodule(parent_name)
            base = parent.get_submodule(child)
            parent.register_module(
                child, Int8Conv2d(base) if isinstance(base, nn.Conv2d) else Int8Linear(base))
    return load(module, tree)


def vae_decoder_tree(vae_params: dict) -> dict:
    """The decode half of the JAX VAE params (`vae.py:174-224`)."""
    return {"decoder": vae_params["decoder"],
            "post_quant_conv": vae_params["post_quant_conv"]}


def vae_encoder_tree(vae_params: dict) -> dict:
    """The encode half of the JAX VAE params (`vae.py:174-224`)."""
    return {"encoder": vae_params["encoder"], "quant_conv": vae_params["quant_conv"]}


def vit_tree(params: dict) -> dict:
    """A JAX ViT tree (`adaface_tpu/models/vit.py`, or `models.vit.
    convert_dino_state_dict`'s) with its patch kernel, OIHW there, as the
    HWIO `w` the walk turns back into the port's OIHW conv weight."""
    patch = dict(params["patch_embedding"])
    patch["w"] = np.asarray(patch["w"]).transpose(2, 3, 1, 0)
    return {**params, "patch_embedding": patch}


def sbg_tree(sbg: dict) -> dict:
    """JAX SubjBasisGenerator {'params', 'buffers'} → the port's layout:
    the prompt2token_proj CLIP tower under `clip`, with its frozen embedding
    tables from the buffers (`subj_basis_generator.py:87-168`); the
    background generator's params as they are."""
    params, buffers = dict(sbg["params"]), dict(sbg["buffers"])
    for key in SBG_DERIVED:
        buffers.pop(key, None)
    if "prompt2token_proj" in params:
        params["clip"] = {"token_embedding": buffers.pop("token_embedding"),
                          "position_embedding": buffers.pop("position_embedding"),
                          **params.pop("prompt2token_proj")}
    if buffers:
        raise ValueError(f"SubjBasisGenerator buffers not ported: {sorted(buffers)}")
    return params


_NORMS = (nn.GroupNorm, nn.LayerNorm)
_FUSED_PARTS = {"qkv": ("q", "k", "v"), "kv": ("k", "v")}


def tree_state_dict(module: nn.Module) -> dict[str, np.ndarray]:
    """The inverse of `state_dict` + `fuse_projections`: a port module's
    parameters and batch-norm statistics under the flat names and in the
    layouts of the JAX pytree it mirrors (`adaface_tpu/tools/ckpt_lib.py:
    flatten_tree` of it), as fp32 numpy arrays: conv weights OIHW → HWIO `w`,
    dense [out, in] → [in, out] `w`, their biases `b`, a norm's weight
    `scale` (its bias `bias`), running statistics `mean` / `var`, and a fused
    `qkv` / `kv` weight split back into `q`, `k`, `v`; an int8 layer's `w_q`
    (int8, HWIO or IO), `w_scale` and `b`."""
    out: dict[str, np.ndarray] = {}
    for name, mod in module.named_modules():
        prefix = f"{name}." if name else ""
        if hasattr(mod, "w_q"):
            w_q = mod.w_q.cpu().numpy()
            out[f"{prefix}w_q"] = w_q.transpose(1, 2, 3, 0) if w_q.ndim == 4 else w_q.T
            out[f"{prefix}w_scale"] = mod.w_scale.float().cpu().numpy()
            out[f"{prefix}b"] = mod.bias.detach().float().cpu().numpy()
            continue
        tensors = dict(mod.named_parameters(recurse=False))
        tensors.update({k: v for k, v in mod.named_buffers(recurse=False)
                        if k in BN_STATS.values()})
        for leaf, t in tensors.items():
            a = t.detach().float().cpu().numpy()
            if isinstance(mod, nn.Conv2d) and leaf == "weight":
                out[f"{prefix}w"] = a.transpose(2, 3, 1, 0)
            elif isinstance(mod, nn.Linear) and leaf == "weight":
                parts = _FUSED_PARTS.get(name.rpartition(".")[2]) if hasattr(mod, "parts") else None
                if parts:
                    head = name.rpartition(".")[0]
                    for part, w in zip(parts, np.split(a, len(parts), axis=0)):
                        out[f"{head}.{part}.w"] = w.T
                else:
                    out[f"{prefix}w"] = a.T
            elif isinstance(mod, (nn.Conv2d, nn.Linear)) and leaf == "bias":
                out[f"{prefix}b"] = a
            elif leaf == "weight" and (isinstance(mod, _NORMS) or a.ndim == 1):
                out[f"{prefix}scale"] = a
            else:
                inverse = {v: k for k, v in BN_STATS.items()}
                out[f"{prefix}{inverse.get(leaf, leaf)}"] = a
    return out


# the adapters' leaves (`init_attn_lora_params`, `init_ffn_lora_params`)
LORA_LEAVES = {"a": "lora_a", "b": "lora_b", "mag": "magnitude"}


def lora_state_dict(tree: Any) -> dict[str, torch.Tensor]:
    """JAX `attn_lora` / `ffn_lora` tree → the state dict of the port's
    `AttnLoRA` / `FFNLoRA`."""
    out = {}
    for name, value in _walk(tree, ""):
        a = np.asarray(value)
        head, _, leaf = name.rpartition(".")
        if leaf in ("a", "b"):
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
        leaf = LORA_LEAVES.get(leaf, leaf)
        out[f"{head}.{leaf}" if head else leaf] = torch.from_numpy(np.array(a))
    return out


def lora_tree(module: nn.Module) -> dict:
    """The inverse of `lora_state_dict`: an `AttnLoRA` / `FFNLoRA` as the
    JAX package's nested tree of fp32 numpy arrays."""
    inverse = {v: k for k, v in LORA_LEAVES.items()}
    out: dict = {}
    for name, t in module.state_dict().items():
        head, _, leaf = name.rpartition(".")
        a = t.detach().float().cpu().numpy()
        if leaf in ("lora_a", "lora_b"):
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        node = out
        for part in head.split(".") if head else ():
            node = node.setdefault(part, {})
        node[inverse.get(leaf, leaf)] = a
    return out


def load_lora(module: nn.Module, tree: Any) -> nn.Module:
    """Load a JAX adapter tree into `module` (strict), left trainable."""
    ref = module.state_dict()
    module.load_state_dict({k: v.to(ref[k].dtype) if k in ref else v
                            for k, v in lora_state_dict(tree).items()}, strict=True)
    return module
