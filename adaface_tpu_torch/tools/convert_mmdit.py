"""SD3 MMDiT checkpoints (diffusers' `SD3Transformer2DModel` layout) ↔ the
`models/mmdit.py` parameter tree.

Counterpart of `adaface_tpu/tools/convert_mmdit.py`, in numpy: `convert_mmdit`
(`:29`) takes any mapping of name → array and gives the JAX package's tree
(conv weights [O, I, H, W] → HWIO, linear [O, I] → [I, O]; a checkpoint's own
position table `pos_embed.pos_embed` carried as `pos_embed_table`, flattened
to [rows, hidden]); `export_mmdit_to_diffusers` (`:88`) is its inverse.
`load_mmdit` builds the port's module from either.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from adaface_tpu_torch.models.mmdit import SD3_MEDIUM, MMDiT, MMDiTConfig
from adaface_tpu_torch.tools.convert_sd import _cw, _dense, arr


def convert_mmdit(sd: Mapping[str, np.ndarray], cfg: MMDiTConfig = SD3_MEDIUM) -> dict:
    """A diffusers SD3 transformer state dict → the JAX package's tree. A
    block is the last one's pre-only form where `attn.to_add_out` is
    absent."""
    params = {
        "patch_embed": {"w": _cw(sd["pos_embed.proj.weight"]),
                        "b": arr(sd["pos_embed.proj.bias"])},
        "time_mlp": {"fc1": _dense(sd, "time_text_embed.timestep_embedder.linear_1"),
                     "fc2": _dense(sd, "time_text_embed.timestep_embedder.linear_2")},
        "pooled_mlp": {"fc1": _dense(sd, "time_text_embed.text_embedder.linear_1"),
                       "fc2": _dense(sd, "time_text_embed.text_embedder.linear_2")},
        "context_embedder": _dense(sd, "context_embedder"),
        "blocks": [],
        "ada_out": _dense(sd, "norm_out.linear"),
        "proj_out": _dense(sd, "proj_out"),
    }
    if "pos_embed.pos_embed" in sd:
        tab = np.asarray(sd["pos_embed.pos_embed"])
        params["pos_embed_table"] = arr(tab.reshape(-1, tab.shape[-1]))
    for i in range(cfg.depth):
        b = f"transformer_blocks.{i}"
        blk = {
            "ada_x": _dense(sd, f"{b}.norm1.linear"),
            "ada_ctx": _dense(sd, f"{b}.norm1_context.linear"),
            "attn": {"q": _dense(sd, f"{b}.attn.to_q"), "k": _dense(sd, f"{b}.attn.to_k"),
                     "v": _dense(sd, f"{b}.attn.to_v"), "o": _dense(sd, f"{b}.attn.to_out.0")},
            "attn_ctx": {"q": _dense(sd, f"{b}.attn.add_q_proj"),
                         "k": _dense(sd, f"{b}.attn.add_k_proj"),
                         "v": _dense(sd, f"{b}.attn.add_v_proj")},
            "mlp_x": {"fc1": _dense(sd, f"{b}.ff.net.0.proj"),
                      "fc2": _dense(sd, f"{b}.ff.net.2")},
        }
        if cfg.qk_norm:
            blk["attn"]["q_rms"] = arr(sd[f"{b}.attn.norm_q.weight"])
            blk["attn"]["k_rms"] = arr(sd[f"{b}.attn.norm_k.weight"])
            blk["attn_ctx"]["q_rms"] = arr(sd[f"{b}.attn.norm_added_q.weight"])
            blk["attn_ctx"]["k_rms"] = arr(sd[f"{b}.attn.norm_added_k.weight"])
        if f"{b}.attn.to_add_out.weight" in sd:
            blk["attn_ctx"]["o"] = _dense(sd, f"{b}.attn.to_add_out")
            blk["mlp_ctx"] = {"fc1": _dense(sd, f"{b}.ff_context.net.0.proj"),
                              "fc2": _dense(sd, f"{b}.ff_context.net.2")}
        params["blocks"].append(blk)
    return params


def export_mmdit_to_diffusers(params: dict, cfg: MMDiTConfig = SD3_MEDIUM) -> dict:
    """The inverse of `convert_mmdit`: numpy arrays in diffusers' names and
    torch layouts."""
    sd: dict[str, np.ndarray] = {}

    def put_dense(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"]).T.copy()
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    sd["pos_embed.proj.weight"] = np.asarray(params["patch_embed"]["w"]).transpose(
        3, 2, 0, 1).copy()
    sd["pos_embed.proj.bias"] = np.asarray(params["patch_embed"]["b"])
    if "pos_embed_table" in params:
        sd["pos_embed.pos_embed"] = np.asarray(params["pos_embed_table"])
    for name, key in (("time_mlp", "timestep_embedder"), ("pooled_mlp", "text_embedder")):
        for i in (1, 2):
            put_dense(f"time_text_embed.{key}.linear_{i}", params[name][f"fc{i}"])
    put_dense("context_embedder", params["context_embedder"])
    for i, blk in enumerate(params["blocks"]):
        b = f"transformer_blocks.{i}"
        put_dense(f"{b}.norm1.linear", blk["ada_x"])
        put_dense(f"{b}.norm1_context.linear", blk["ada_ctx"])
        for name, key in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            put_dense(f"{b}.attn.{key}", blk["attn"][name])
        for name in ("q", "k", "v"):
            put_dense(f"{b}.attn.add_{name}_proj", blk["attn_ctx"][name])
        put_dense(f"{b}.ff.net.0.proj", blk["mlp_x"]["fc1"])
        put_dense(f"{b}.ff.net.2", blk["mlp_x"]["fc2"])
        if "q_rms" in blk["attn"]:
            sd[f"{b}.attn.norm_q.weight"] = np.asarray(blk["attn"]["q_rms"])
            sd[f"{b}.attn.norm_k.weight"] = np.asarray(blk["attn"]["k_rms"])
            sd[f"{b}.attn.norm_added_q.weight"] = np.asarray(blk["attn_ctx"]["q_rms"])
            sd[f"{b}.attn.norm_added_k.weight"] = np.asarray(blk["attn_ctx"]["k_rms"])
        if "o" in blk["attn_ctx"]:
            put_dense(f"{b}.attn.to_add_out", blk["attn_ctx"]["o"])
            put_dense(f"{b}.ff_context.net.0.proj", blk["mlp_ctx"]["fc1"])
            put_dense(f"{b}.ff_context.net.2", blk["mlp_ctx"]["fc2"])
    put_dense("norm_out.linear", params["ada_out"])
    put_dense("proj_out", params["proj_out"])
    return sd


def load_mmdit(tree: dict, cfg: MMDiTConfig, device, dtype=torch.bfloat16) -> MMDiT:
    """The port's MMDiT on `device` in `dtype` from a tree (`convert_mmdit`'s
    or the JAX package's), with the tree's position table where it has one;
    frozen."""
    from adaface_tpu_torch.tools.convert_sd import load_module

    table = tree.get("pos_embed_table")
    rows = None if table is None else np.asarray(table).shape[0]
    if rows is not None and math.isqrt(rows) ** 2 != rows:
        raise ValueError(f"pos_embed_table: {rows} rows are not a square grid")
    return load_module(lambda: MMDiT(cfg, pos_embed_rows=rows), tree, device, dtype)
