"""ConsistentID's trained image projection → the `ProjPlus` tree.

Counterpart of `adaface_tpu/tools/convert_consistentid.py:54-114`, in numpy:
the `ProjPlusModel` inside `ConsistentID-v1.bin` (its "image_proj"
sub-dict), a bare ProjPlusModel state dict, or either under an
"image_proj_model." prefix → the JAX package's `init_proj_plus` tree, which
`core.bridge.load` lands in the port's `ProjPlus`.

torch key layout (IP-Adapter FaceID-Plus `ProjPlusModel`):
    proj.0.{weight,bias}                      id_dim → id_dim·2
    proj.2.{weight,bias}                      id_dim·2 → out_dim·num_tokens
    norm.{weight,bias}
    perceiver_resampler.proj_in / proj_out / norm_out.{weight,bias}
    perceiver_resampler.layers.{i}.0.norm1 / norm2.{weight,bias}  (x, latents LN)
    perceiver_resampler.layers.{i}.0.to_q / to_kv / to_out.weight
    perceiver_resampler.layers.{i}.1.0.{weight,bias}              (FF LayerNorm)
    perceiver_resampler.layers.{i}.1.1 / 1.3.weight               (FF, no bias)
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

from adaface_tpu_torch.tools.convert_sd import arr


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"scale": arr(sd[f"{prefix}.weight"]), "bias": arr(sd[f"{prefix}.bias"])}


def _linear(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True) -> dict:
    p = {"w": arr(np.asarray(sd[f"{prefix}.weight"]).T)}
    if bias:
        p["b"] = arr(sd[f"{prefix}.bias"])
    return p


def _normalize_state_dict(sd: Mapping[str, Any]) -> Mapping[str, Any]:
    if "image_proj" in sd and isinstance(sd["image_proj"], Mapping):
        sd = sd["image_proj"]
    if any(k.startswith("image_proj_model.") for k in sd):
        sd = {k[len("image_proj_model."):]: v for k, v in sd.items()
              if k.startswith("image_proj_model.")}
    return sd


def convert_consistentid_proj(sd: Mapping[str, Any]) -> dict:
    """A torch ProjPlusModel state dict → the `init_proj_plus` tree."""
    sd = _normalize_state_dict(sd)
    depth = 1 + max((int(m.group(1)) for k in sd
                     if (m := re.match(r"perceiver_resampler\.layers\.(\d+)\.", k))), default=-1)
    if depth < 1:
        raise KeyError("no perceiver_resampler.layers.* keys found: not a ConsistentID "
                       "ProjPlusModel state dict")
    r = "perceiver_resampler"
    layers = []
    for i in range(depth):
        a, f = f"{r}.layers.{i}.0", f"{r}.layers.{i}.1"
        layers.append({
            "attn": {"ln_x": _ln(sd, f"{a}.norm1"), "ln_lat": _ln(sd, f"{a}.norm2"),
                     "to_q": _linear(sd, f"{a}.to_q", bias=False),
                     "to_kv": _linear(sd, f"{a}.to_kv", bias=False),
                     "to_out": _linear(sd, f"{a}.to_out", bias=False)},
            "ff": {"ln": _ln(sd, f"{f}.0"), "fc1": _linear(sd, f"{f}.1", bias=False),
                   "fc2": _linear(sd, f"{f}.3", bias=False)}})
    return {"proj": {"fc1": _linear(sd, "proj.0"), "fc2": _linear(sd, "proj.2")},
            "norm": _ln(sd, "norm"),
            "resampler": {"proj_in": _linear(sd, f"{r}.proj_in"),
                          "proj_out": _linear(sd, f"{r}.proj_out"),
                          "norm_out": _ln(sd, f"{r}.norm_out"), "layers": layers}}


def load_consistentid_proj(path: str) -> dict:
    """`ConsistentID-v1.bin` (a torch checkpoint) → the image projection's tree."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v
          for k, v in _normalize_state_dict(sd).items()}
    return convert_consistentid_proj(sd)


def proj_plus_dims(tree: dict) -> dict:
    """The `ProjPlus` constructor's arguments that the tree's shapes give:
    id_dim, clip_dim, out_dim, num_tokens, depth."""
    id_dim = tree["proj"]["fc1"]["w"].shape[0]
    out_dim = tree["norm"]["scale"].shape[0]
    return dict(id_dim=id_dim, clip_dim=tree["resampler"]["proj_in"]["w"].shape[0],
                out_dim=out_dim, num_tokens=tree["proj"]["fc2"]["w"].shape[1] // out_dim,
                depth=len(tree["resampler"]["layers"]))
