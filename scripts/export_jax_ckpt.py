"""Export a checkpoint of the JAX trainer into the PyTorch port's format.

    python scripts/export_jax_ckpt.py <jax ckpt dir> <out dir>

The JAX trainer (`adaface_tpu/train/trainer.py` `Trainer.save`) writes an
Orbax tree under `state/` beside `manifest.json`; the port reads its own
`state.pt` + `manifest.json` (`adaface_tpu_torch/train/checkpoint.py`). This
script runs where JAX and orbax are installed, as `train.py` does, and
writes what the port's `AdaFaceWrapper.load_adaface_ckpt`,
`load_unet_lora_weights`, `Trainer.load` (`train_torch.py -r` or
`--adaface_ckpt_path`) and the `_torch` CLIs read:

- the SubjBasisGenerators under their encoder names (a list under a joint
  encoder's name), each as the port's state dict (`core/bridge.py`: the
  prompt2token_proj tower under `clip`, its frozen embedding tables left
  out as the port's checkpoints leave them out), at the K/V widths they
  hold, so an MKV-extended checkpoint stays extended;
- the UNet's attention and FFN DoRA adapters (`unet_lora_modules`) where
  present, as the state dicts of the port's `AttnLoRA` / `FFNLoRA`;
- the manifest's `mkv_multipliers` where it has them (else the port reads
  them from the widths) and its step;
- `unet_fp16.safetensors` of a finetuning run, copied as it is: both
  packages write it under the JAX UNet tree's flat names.

Optimizer state is not carried: resuming restarts the optimizer in both
packages (`train.py`'s resume comment). The port's modules never import this
script; it is the one place where the two packages meet outside the tests.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

UNET_FP16 = "unet_fp16.safetensors"


def sbg_state_dict(params) -> dict:
    """A JAX SubjBasisGenerator's params (a list of them for a joint
    encoder) → the port's state dict(s), as `Trainer.save` writes them."""
    from adaface_tpu_torch.core import bridge

    if isinstance(params, (list, tuple)):
        return [sbg_state_dict(p) for p in params]
    return bridge.state_dict({("clip" if k == "prompt2token_proj" else k): v
                              for k, v in params.items()})


def export(src: str, dst: str) -> str:
    """The JAX checkpoint at `src` → the port's at `dst` → its path."""
    from adaface_tpu.train.checkpoint import load_checkpoint
    from adaface_tpu_torch.core import bridge
    from adaface_tpu_torch.train.checkpoint import save_adaface_ckpt

    state, manifest = load_checkpoint(src)
    if manifest.get("kind", "adaface") != "adaface":
        raise ValueError(f"{src}: a checkpoint of kind {manifest['kind']!r}, not an AdaFace one")
    sbgs = {name: sbg_state_dict(p)
            for name, p in (state.get("subj_basis_generators") or {}).items()}
    lora = {key: bridge.lora_state_dict(tree)
            for key, tree in (state.get("unet_lora_modules") or {}).items()}
    out = save_adaface_ckpt(dst, int(manifest.get("step", 0)), sbgs,
                            unet_lora_params=lora or None,
                            mkv_multipliers=manifest.get("mkv_multipliers") or None)
    if os.path.exists(os.path.join(src, UNET_FP16)):
        shutil.copyfile(os.path.join(src, UNET_FP16), os.path.join(out, UNET_FP16))
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="checkpoint directory of the JAX trainer")
    ap.add_argument("dst", help="directory for the port's checkpoint")
    args = ap.parse_args(argv)
    out = export(args.src, args.dst)
    print(f"exported {args.src} -> {out} (optimizer state not carried: resume restarts it)")
    return out


if __name__ == "__main__":
    main()
