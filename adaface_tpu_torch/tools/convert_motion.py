"""AnimateDiff motion-module checkpoints → the `models/motion.py` tree.

Counterpart of `adaface_tpu/tools/convert_motion.py`, in numpy: the public
`mm_sd_v15*.ckpt` layout

    {down,up}_blocks.{b}.motion_modules.{l}.temporal_transformer.
        norm.{weight,bias}
        proj_in.{weight,bias}
        transformer_blocks.{t}.attention_blocks.{a}.to_{q,k,v}.weight
        transformer_blocks.{t}.attention_blocks.{a}.to_out.0.{weight,bias}
        transformer_blocks.{t}.norms.{a}.{weight,bias}
        transformer_blocks.{t}.ff.net.0.proj.{weight,bias}   (GEGLU)
        transformer_blocks.{t}.ff.net.2.{weight,bias}
        transformer_blocks.{t}.ff_norm.{weight,bias}
        proj_out.{weight,bias}
    mid_block.motion_modules.0....

becomes the JAX package's tree (Linear weights [out, in] → [in, out]);
`pos_encoder.pe` buffers are skipped (the table is computed).
`core.bridge.load(MotionModules(...), tree)` builds the port's modules from
it. `.safetensors` files are read by `tools/ckpt_lib.load_safetensors`, so
no `safetensors` package is needed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from adaface_tpu_torch.tools.convert_sd import _dense, _lw, _norm


def _module(sd: Mapping[str, np.ndarray], prefix: str, num_layers: int,
            attns_per_block: int) -> dict:
    tt = f"{prefix}.temporal_transformer"
    blocks = []
    for t in range(num_layers):
        tb = f"{tt}.transformer_blocks.{t}"
        attns = []
        for a in range(attns_per_block):
            ab = f"{tb}.attention_blocks.{a}"
            attns.append({
                "norm": _norm(sd, f"{tb}.norms.{a}"),
                **{p: {"w": _lw(sd[f"{ab}.to_{p}.weight"])} for p in ("q", "k", "v")},
                "o": _dense(sd, f"{ab}.to_out.0"),
            })
        blocks.append({"attn": attns, "norm_ff": _norm(sd, f"{tb}.ff_norm"),
                       "ff": {"proj_in": _dense(sd, f"{tb}.ff.net.0.proj"),
                              "proj_out": _dense(sd, f"{tb}.ff.net.2")}})
    return {"norm": _norm(sd, f"{tt}.norm"), "proj_in": _dense(sd, f"{tt}.proj_in"),
            "blocks": blocks, "proj_out": _dense(sd, f"{tt}.proj_out")}


def convert_motion_modules(sd: Mapping[str, np.ndarray], num_down_blocks: int = 4,
                           layers_per_block: int = 2, num_layers: int = 1,
                           attns_per_block: int = 2) -> dict:
    """A whole AnimateDiff state dict → {"down", "mid", "up"}
    (`convert_motion_modules`, `convert_motion.py:74`)."""
    def modules(kind: str, b: int, n: int) -> list:
        return [_module(sd, f"{kind}_blocks.{b}.motion_modules.{i}", num_layers, attns_per_block)
                for i in range(n)]

    return {"down": [modules("down", b, layers_per_block) for b in range(num_down_blocks)],
            "mid": _module(sd, "mid_block.motion_modules.0", num_layers, attns_per_block),
            "up": [modules("up", b, layers_per_block + 1) for b in range(num_down_blocks)]}


def load_motion_ckpt(path: str, **kw) -> dict:
    """A `.ckpt` (its `state_dict` where it has one), `.safetensors` or
    `.npz` AnimateDiff checkpoint → the tree (`load_motion_ckpt`, `:100`)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    elif path.endswith(".safetensors"):
        from adaface_tpu_torch.tools.ckpt_lib import load_safetensors

        sd = load_safetensors(path)
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in obj:
            obj = obj["state_dict"]
        sd = {k: v.numpy() for k, v in obj.items()}
    sd = {k: v for k, v in sd.items() if not k.endswith("pos_encoder.pe")}
    return convert_motion_modules(sd, **kw)
