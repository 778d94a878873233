"""AdaFace training checkpoints.

Counterpart of `save_adaface_ckpt` and `load_adaface_ckpt` in
`adaface_tpu/train/checkpoint.py`: the same tree (`subj_basis_generators`
by encoder name, each a SubjBasisGenerator's parameters or a list of them
for a joint encoder, and `unet_lora_modules` when LoRAs train) and the same
manifest keys, written as

    ckpt_dir/
      manifest.json   # version, step, kind, mkv_multipliers
      state.pt        # torch.save of the tree, tensors on the CPU

The MKV re-extension on load waits for the MKV slice, and the converter of
the reference's pickled checkpoints for the converters (ROADMAP §1).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

CKPT_VERSION = 1


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def save_adaface_ckpt(ckpt_dir: str, step: int, sbg_params_by_encoder: dict[str, Any],
                      unet_lora_params: Any | None = None,
                      mkv_multipliers: dict[str, list[int]] | None = None) -> str:
    """Write the trainable AdaFace state (the equivalent of the reference's
    `embeddings_gs-{step}.pt`) → the directory's absolute path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {"subj_basis_generators": sbg_params_by_encoder}
    if unet_lora_params is not None:
        state["unet_lora_modules"] = unet_lora_params
    manifest = {"version": CKPT_VERSION, "step": int(step), "kind": "adaface",
                "mkv_multipliers": mkv_multipliers or {}}
    # the state first, renamed into place; the manifest last, so a reader
    # never finds a manifest without its state
    tmp = os.path.join(ckpt_dir, "state.pt.tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(ckpt_dir, "state.pt"))
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return ckpt_dir


def load_adaface_ckpt(ckpt_dir: str) -> tuple[dict, dict]:
    """→ (state tree with CPU tensors, manifest)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    state = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu",
                       weights_only=True)
    return state, manifest
