"""Multi-subject evaluation on the PyTorch port (the twin of
`scripts/gen_prompts_and_eval.py`).

Resolves the subjects (the folders under `--subjects_root`, or a
fish-syntax subject table `--subject_file`), runs
`txt2img_eval_torch.py` on each, and averages the scores CSV:

    python scripts/gen_prompts_and_eval_torch.py --subjects_root subjects/ \
        --prompt_set dreambench --out_root eval_out --scores_csv all.csv

With neither, `--fixture_root` names a checkout of the reference's
evaluation fixtures (`evaluation/info-subjects-celebrity.sh` or `-ood.sh`
and the subject folders); the table's `data_folder` is relative to it.
`--list_only` prints the resolved subjects and writes the scores CSV's
header without generating anything. Generation runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_SUBJECT_FILES = {
    "celebrity": "evaluation/info-subjects-celebrity.sh",
    "ood": "evaluation/info-subjects-ood.sh",
}
SKELETON_HEADER = ["subject", "prompt_set", "clip_text", "clip_img", "dino", "face_sim",
                   "n_images"]


def resolve_subjects(args, ap) -> tuple[list[str], dict]:
    """→ (subject names, {subject: class type}); sets `args.subjects_root`
    from the table's `data_folder` where it was not given."""
    from adaface_tpu_torch.evaluation.eval_utils import parse_range_str, parse_subject_file

    fixture_root = None
    if args.subject_file is None and args.subjects_root is None and args.fixture_root:
        cand = os.path.join(args.fixture_root, REFERENCE_SUBJECT_FILES[args.fixture_set])
        if os.path.exists(cand):
            args.subject_file, fixture_root = cand, args.fixture_root
            print(f"using the reference fixtures: {cand}")
    subj_types: dict[str, str] = {}
    if args.subject_file:
        subj_info, subj2attr = parse_subject_file(args.subject_file)
        subjects = subj_info["subjects"]
        subj_types = subj2attr.get("subj_types", {})
        if args.subjects_root is None:
            args.subjects_root = subj_info.get("data_folder", ["."])[0]
            if fixture_root is not None:
                args.subjects_root = os.path.join(fixture_root, args.subjects_root)
    elif args.subjects_root:
        subjects = sorted(d for d in os.listdir(args.subjects_root)
                          if os.path.isdir(os.path.join(args.subjects_root, d)))
    else:
        ap.error("one of --subjects_root / --subject_file / --fixture_root is required")
    sel = parse_range_str(args.subject_range)
    if sel is not None:
        subjects = [subjects[i] for i in sel if i < len(subjects)]
    return subjects, subj_types


def list_only(args, subjects: list[str], subj_types: dict) -> None:
    missing = [n for n in subjects if not os.path.isdir(os.path.join(args.subjects_root, n))]
    for name in subjects:
        d = os.path.join(args.subjects_root, name)
        n_imgs = sum(1 for f in os.listdir(d) if f.lower().endswith((".jpg", ".jpeg", ".png"))
                     and "_mask" not in f) if os.path.isdir(d) else 0
        print(f"{name}\t{subj_types.get(name, '?')}\t{n_imgs} images")
    if not os.path.exists(args.scores_csv):
        with open(args.scores_csv, "w", newline="") as f:
            csv.writer(f).writerow(SKELETON_HEADER)
    if missing:
        raise SystemExit(f"missing subject folders: {missing}")
    print(f"{len(subjects)} subjects resolved under {args.subjects_root}; "
          f"skeleton at {args.scores_csv}")


def averages(scores_csv: str) -> dict:
    """Each numeric column's mean over the CSV's rows → {column: (mean, n)},
    over the values that parse as numbers. (The JAX script creates a
    column's list before it parses the value, so a text column such as
    `subject` leaves an empty list and its average divides by zero.)"""
    with open(scores_csv) as f:
        rows = list(csv.DictReader(f))
    nums: dict[str, list[float]] = {}
    for row in rows:
        for k, v in row.items():
            try:
                x = float(v)
            except (TypeError, ValueError):
                continue
            nums.setdefault(k, []).append(x)
    return {k: (sum(v) / len(v), len(v)) for k, v in nums.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--subjects_root", default=None)
    ap.add_argument("--subject_file", default=None,
                    help="fish-syntax subject table (info-subjects-*.sh style): subjects, "
                         "subj_types, and data_folder when --subjects_root is omitted")
    ap.add_argument("--subject_range", default=None, help="e.g. '0-5'")
    ap.add_argument("--prompt_set", default="dreambench")
    ap.add_argument("--out_root", default="eval_out")
    ap.add_argument("--scores_csv", default="scores.csv")
    ap.add_argument("--n_samples", type=int, default=4)
    ap.add_argument("--num_inference_steps", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the rest of the line goes to txt2img_eval_torch.py, options included
    # (`--extra_args --adaface_ckpt DIR --guidance_scale 5`, as the periodic
    # evaluation loop passes them): give it last
    ap.add_argument("--extra_args", nargs=argparse.REMAINDER, default=[])
    ap.add_argument("--fixture_root", default=None,
                    help="a checkout of the reference's evaluation fixtures, used when "
                         "neither --subjects_root nor --subject_file is given")
    ap.add_argument("--fixture_set", default="celebrity", choices=sorted(REFERENCE_SUBJECT_FILES))
    ap.add_argument("--list_only", action="store_true",
                    help="resolve the subjects and write the scores CSV's header only")
    args = ap.parse_args(argv)

    subjects, subj_types = resolve_subjects(args, ap)
    if args.list_only:
        list_only(args, subjects, subj_types)
        return
    for name in subjects:
        subj_dir = os.path.join(args.subjects_root, name)
        cmd = [sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "txt2img_eval_torch.py"),
               "--subject", subj_dir, "--subject_name", name, "--prompt_set", args.prompt_set,
               "--out_dir", os.path.join(args.out_root, name), "--n_samples",
               str(args.n_samples), "--num_inference_steps", str(args.num_inference_steps),
               "--calc_face_sim", "--compare_with", subj_dir, "--scores_csv", args.scores_csv,
               "--device", args.device] + args.extra_args
        if name in subj_types:
            cmd += ["--class_token", subj_types[name]]
        print(f"=== {name} ===", flush=True)
        subprocess.run(cmd, check=True)
    if os.path.exists(args.scores_csv):
        print("=== averages ===")
        for k, (mean, n) in averages(args.scores_csv).items():
            print(f"{k}: {mean:.4f} (n={n})")


if __name__ == "__main__":
    main()
