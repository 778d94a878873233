"""AdaFace training checkpoints.

Counterpart of `save_adaface_ckpt` and `load_adaface_ckpt` in
`adaface_tpu/train/checkpoint.py`: the same tree (`subj_basis_generators`
by encoder name, each a SubjBasisGenerator's parameters or a list of them
for a joint encoder, and `unet_lora_modules` when LoRAs train) and the same
manifest keys, written as

    ckpt_dir/
      manifest.json   # version, step, kind, mkv_multipliers
      state.pt        # torch.save of the tree, tensors on the CPU

The manifest's `mkv_multipliers` are read from the prompt2token_proj K/V
widths of what is saved (per encoder name: a layer list, or one per
SubjBasisGenerator of a joint encoder). `load_adaface_ckpt` re-extends or
squeezes prompt2token_proj to the multipliers asked for
(`checkpoint.py:97-128`); `load_subj_basis_generators` loads a checkpoint's
SubjBasisGenerators into an encoder at their widths (serving). The
converter of the reference's pickled checkpoints waits in ROADMAP §1.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from adaface_tpu_torch.models.clip import layer_multipliers
from adaface_tpu_torch.utils.tensor import Draws

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
    if mkv_multipliers is None:
        mkv_multipliers = {name: _multipliers(sbg) for name, sbg in sbg_params_by_encoder.items()}
        mkv_multipliers = {k: v for k, v in mkv_multipliers.items() if v}
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


def _multipliers(sbg):
    """prompt2token_proj's layer multipliers of a SubjBasisGenerator state dict
    (a list of them for a joint encoder); [] for one without the tower."""
    if isinstance(sbg, (list, tuple)):
        out = [_multipliers(s) for s in sbg]
        return out if any(out) else []
    return layer_multipliers(sbg, prefix="clip.") if isinstance(sbg, dict) else []


def _resize(sd: dict, want: list[int], have: list[int], draws: Draws | None) -> dict:
    from adaface_tpu_torch.id2ada.subj_basis_generator import (
        extend_prompt2token_proj_attention, squeeze_prompt2token_proj_attention)

    mult = [w // h if h else 1 for w, h in zip(want, have)]
    div = [h // w if w and h > w else 1 for w, h in zip(want, have)]
    if any(m > 1 for m in mult):
        sd = extend_prompt2token_proj_attention(sd, mult, draws, perturb_std=0.1)
    if any(d > 1 for d in div):
        sd = squeeze_prompt2token_proj_attention(sd, div)
    return sd


def load_adaface_ckpt(ckpt_dir: str, want_mkv_multipliers: dict | None = None,
                      draws: Draws | None = None) -> tuple[dict, dict]:
    """→ (state tree with CPU tensors, manifest). With `want_mkv_multipliers`
    ({encoder name: a layer list, or one per SubjBasisGenerator of a joint
    encoder}), each named SubjBasisGenerator whose manifest multipliers
    differ is re-extended (perturbed copies, `draws` in order; a generator
    seeded 0 if None) or squeezed to them (`checkpoint.py:97-128`)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    state = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu",
                       weights_only=True)
    if want_mkv_multipliers:
        saved = manifest.get("mkv_multipliers", {})
        draws = draws or Draws(generator=torch.Generator().manual_seed(0))
        sbgs = state.get("subj_basis_generators", {})
        for name, want in want_mkv_multipliers.items():
            have, sbg = saved.get(name), sbgs.get(name)
            if sbg is None or not have:
                continue
            if isinstance(sbg, (list, tuple)):
                sbgs[name] = [_resize(s, w, h, draws) for s, w, h in zip(sbg, want, have)]
            else:
                sbgs[name] = _resize(sbg, want, have, draws)
    return state, manifest


def load_subj_basis_generators(encoder, ckpt_dir: str) -> None:
    """The SubjBasisGenerator(s) of a checkpoint of the port's trainer into an
    id→ada encoder, by the encoder's name or under "joint" (the i-th of a
    joint list into the i-th sub-encoder), each at the prompt2token_proj
    widths the checkpoint holds (`scripts/_common.py:_load_adaface`)."""
    from adaface_tpu_torch.id2ada.subj_basis_generator import load_sbg_state_dict

    state, _ = load_adaface_ckpt(ckpt_dir)
    sbgs = state.get("subj_basis_generators", {})
    for i, enc in enumerate(getattr(encoder, "encoders", [encoder])):
        for key in (enc.name, "joint"):
            if key not in sbgs:
                continue
            sd = sbgs[key][i] if isinstance(sbgs[key], (list, tuple)) else sbgs[key]
            load_sbg_state_dict(enc.subj_basis_generator, sd, f"{ckpt_dir} ({enc.name})")
            print(f"loaded SBG params for {enc.name} from {ckpt_dir}")
            break
