"""Checkpoint surgery CLI of the PyTorch port, the counterpart of
`scripts/ckpt_tool.py`: one entry point for the reference's checkpoint tools,
on `adaface_tpu_torch.tools.ckpt_lib` (numpy; `.safetensors` read and
written without the `safetensors` package) and the port's AdaFace
checkpoints (`adaface_tpu_torch/train/checkpoint.py`).

    python scripts/ckpt_tool_torch.py repl_vae  base.safetensors vae.safetensors out.safetensors
    python scripts/ckpt_tool_torch.py repl_text base.safetensors te.safetensors  out.safetensors
    python scripts/ckpt_tool_torch.py avg       a.safetensors b.safetensors -o out.safetensors -w 0.5 0.5
    python scripts/ckpt_tool_torch.py extract_unet sd.ckpt out.safetensors
    python scripts/ckpt_tool_torch.py fp16      in.safetensors out.safetensors
    python scripts/ckpt_tool_torch.py diff      a.safetensors b.safetensors
    python scripts/ckpt_tool_torch.py check     in.safetensors
    python scripts/ckpt_tool_torch.py repl_pat  base donor out -p 'unet.*attn*'
    python scripts/ckpt_tool_torch.py extract_sbg  <adaface_ckpt_dir> out.safetensors
    python scripts/ckpt_tool_torch.py squeeze_mkv  <adaface_ckpt_dir> out_dir -d 2 2 ...
    python scripts/ckpt_tool_torch.py clean     <logs_root> --pat REGEX [--keep N] [--mock]

`extract_sbg` writes each SubjBasisGenerator's tensors under
`<encoder>.<name>` (a joint encoder's i-th under `<encoder>.<i>.<name>`),
named as the port's modules name them. `squeeze_mkv` averages each
MKV-extended prompt2token_proj back down by its divisors (one broadcasts to
every layer; a joint encoder's generators each) and writes a checkpoint
whose manifest multipliers are read from the squeezed widths.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adaface_tpu_torch.tools.ckpt_lib import (  # noqa: E402
    average_state_dicts, cast_fp16, check_weights, clean_log_folders, extract_subtree,
    flatten_tree, load_state_dict, model_diff, replace_by_pattern, replace_subtree,
    save_state_dict)

VAE_PREFIX = "first_stage_model."
TEXT_PREFIX = "cond_stage_model."
UNET_PREFIX = "model.diffusion_model."


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("repl_vae", "repl_text"):
        p = sub.add_parser(name)
        p.add_argument("base"), p.add_argument("donor"), p.add_argument("out")
        p.add_argument("--donor_prefix", default="")
    p = sub.add_parser("avg")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("-w", "--weights", nargs="+", type=float, default=None)
    p = sub.add_parser("extract_unet")
    p.add_argument("base"), p.add_argument("out")
    p.add_argument("--prefix", default=UNET_PREFIX)
    p = sub.add_parser("fp16")
    p.add_argument("base"), p.add_argument("out")
    p = sub.add_parser("diff")
    p.add_argument("a"), p.add_argument("b")
    p.add_argument("--topk", type=int, default=20)
    p = sub.add_parser("check")
    p.add_argument("base")
    p = sub.add_parser("repl_pat")
    p.add_argument("base"), p.add_argument("donor"), p.add_argument("out")
    p.add_argument("-p", "--patterns", nargs="+", required=True)
    p.add_argument("--regex", action="store_true")
    p = sub.add_parser("extract_sbg")
    p.add_argument("ckpt_dir"), p.add_argument("out")
    p.add_argument("--encoder", default=None, help="only this encoder (default: all)")
    p = sub.add_parser("squeeze_mkv")
    p.add_argument("ckpt_dir"), p.add_argument("out")
    p.add_argument("-d", "--divisors", nargs="+", type=int, required=True,
                   help="per-layer MKV divisors (a single value broadcasts)")
    p.add_argument("--encoder", default=None)
    p = sub.add_parser("clean", help="prune old checkpoints under a root of log dirs")
    p.add_argument("root", help="root folder containing per-run log dirs")
    p.add_argument("--pat", required=True, help="regex a run's checkpoints path must match")
    p.add_argument("--skip_pat", default=None, help="regex of checkpoints paths to leave alone")
    p.add_argument("--keep", type=int, default=1, help="most-recent checkpoints to keep")
    p.add_argument("--del_samples", action="store_true",
                   help="also delete each run's samples/ folder")
    p.add_argument("--mock", action="store_true",
                   help="print what would be deleted without deleting")
    return ap.parse_args(argv)


def squeeze_sbg(sd: dict, divisors: list[int]) -> dict:
    """One SubjBasisGenerator state dict with prompt2token_proj squeezed by
    `divisors` (one value: every layer); as it is without the tower."""
    from adaface_tpu_torch.id2ada.subj_basis_generator import squeeze_prompt2token_proj_attention
    from adaface_tpu_torch.models.clip import layer_multipliers

    n_layers = len(layer_multipliers(sd, prefix="clip."))
    if not n_layers:
        return sd
    div = divisors * n_layers if len(divisors) == 1 else divisors
    return squeeze_prompt2token_proj_attention(sd, div)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.cmd in ("repl_vae", "repl_text"):
        prefix = VAE_PREFIX if args.cmd == "repl_vae" else TEXT_PREFIX
        out = replace_subtree(load_state_dict(args.base), load_state_dict(args.donor), prefix,
                              donor_prefix=args.donor_prefix or None)
        save_state_dict(out, args.out)
        print(f"wrote {args.out}")
    elif args.cmd == "avg":
        sds = [load_state_dict(p) for p in args.inputs]
        save_state_dict(average_state_dicts(sds, args.weights), args.out)
        print(f"averaged {len(sds)} ckpts → {args.out}")
    elif args.cmd == "extract_unet":
        sd = extract_subtree(load_state_dict(args.base), args.prefix)
        save_state_dict(sd, args.out)
        print(f"extracted {len(sd)} tensors → {args.out}")
    elif args.cmd == "fp16":
        save_state_dict(cast_fp16(load_state_dict(args.base)), args.out)
        print(f"wrote fp16 → {args.out}")
    elif args.cmd == "diff":
        rows, miss_a, miss_b = model_diff(load_state_dict(args.a), load_state_dict(args.b),
                                          args.topk)
        for k, d in rows:
            print(f"{d:12.6g}  {k}")
        if miss_a:
            print(f"only in b: {len(miss_a)} keys")
        if miss_b:
            print(f"only in a: {len(miss_b)} keys")
    elif args.cmd == "check":
        print(check_weights(load_state_dict(args.base)))
    elif args.cmd == "repl_pat":
        out = replace_by_pattern(load_state_dict(args.base), load_state_dict(args.donor),
                                 args.patterns, use_regex=args.regex)
        save_state_dict(out, args.out)
        print(f"wrote {args.out}")
    elif args.cmd == "extract_sbg":
        from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt

        state, _ = load_adaface_ckpt(args.ckpt_dir)
        sbgs = state["subj_basis_generators"]
        names = [args.encoder] if args.encoder else list(sbgs)
        flat = {}
        for name in names:
            for k, v in flatten_tree(sbgs[name]).items():
                flat[f"{name}.{k}"] = v
        save_state_dict(flat, args.out)
        print(f"extracted SBG {names} ({len(flat)} tensors) → {args.out}")
    elif args.cmd == "squeeze_mkv":
        from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt, save_adaface_ckpt

        state, manifest = load_adaface_ckpt(args.ckpt_dir)
        sbgs = state["subj_basis_generators"]
        names = [args.encoder] if args.encoder else list(sbgs)
        for name in names:
            sbg = sbgs[name]
            sbgs[name] = ([squeeze_sbg(s, args.divisors) for s in sbg]
                          if isinstance(sbg, (list, tuple)) else squeeze_sbg(sbg, args.divisors))
        save_adaface_ckpt(args.out, int(manifest.get("step", 0)), sbgs,
                          unet_lora_params=state.get("unet_lora_modules"))
        print(f"squeezed MKV {names} by {args.divisors} → {args.out}")
    elif args.cmd == "clean":
        n_del = clean_log_folders(args.root, args.pat, skip_pat=args.skip_pat, keep=args.keep,
                                  del_samples=args.del_samples, mock=args.mock)
        print(f"{'would delete' if args.mock else 'deleted'} {n_del} checkpoint dirs")


if __name__ == "__main__":
    main()
