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
# SubjBasisGenerator params of the non-face (DINO) branch, not on the face path
SBG_NOT_PORTED = ("obj_proj_in",)


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


def load(module: nn.Module, tree: Any) -> nn.Module:
    """Load a JAX pytree into `module` (strict: every key, every shape);
    returns it frozen and in eval mode, as `core.params.build` does."""
    sd = state_dict(tree)
    ref = module.state_dict()
    module.load_state_dict({k: v.to(ref[k].dtype) if k in ref else v
                            for k, v in sd.items()}, strict=True)
    return module.requires_grad_(False).eval()


def vae_decoder_tree(vae_params: dict) -> dict:
    """The decode half of the JAX VAE params (`vae.py:174-224`)."""
    return {"decoder": vae_params["decoder"],
            "post_quant_conv": vae_params["post_quant_conv"]}


def sbg_tree(sbg: dict) -> dict:
    """JAX SubjBasisGenerator {'params', 'buffers'} → the port's layout:
    the prompt2token_proj CLIP tower under `clip`, with its frozen embedding
    tables from the buffers (`subj_basis_generator.py:87-168`)."""
    params, buffers = dict(sbg["params"]), dict(sbg["buffers"])
    for key in SBG_NOT_PORTED:
        params.pop(key, None)
    for key in SBG_DERIVED:
        buffers.pop(key)
    clip = {"token_embedding": buffers.pop("token_embedding"),
            "position_embedding": buffers.pop("position_embedding"),
            **params.pop("prompt2token_proj")}
    if buffers:
        raise ValueError(f"SubjBasisGenerator buffers not ported: {sorted(buffers)}")
    return {"clip": clip, **params}
