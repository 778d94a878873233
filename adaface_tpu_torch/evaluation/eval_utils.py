"""Evaluation harness orchestration.

Counterpart of `adaface_tpu/evaluation/eval_utils.py` (the reference's
`evaluation/eval_utils.py`): `compare_folders` (CLIP-T / CLIP-I / DINO of
generated samples against a ground-truth folder), `compare_face_folders`,
prompt-list formatting, range and subject-table parsing, and the CSV score
rows of `scripts/stable_txt2img.py --scores_csv`. The evaluators and the
face backend are passed in, so that weights load once across subjects.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Sequence

from adaface_tpu_torch.evaluation.face_sim import compare_face_images, load_folder_images


def parse_range_str(range_str: str | None) -> list[int] | None:
    """'1,3-5,8' → [1, 3, 4, 5, 8]; None or '' → None."""
    if not range_str:
        return None
    out: list[int] = []
    for part in range_str.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def parse_subject_file(path: str) -> tuple[dict, dict]:
    """A fish-syntax subject table (`info-subjects-celebrity.sh` style):
    lines of `set -g var v1 v2 …`, where a single `$other` value aliases an
    earlier variable. → (subj_info, subj2attr), subj2attr[var] mapping each
    subject to its `subj_types` / `cls_delta_strings` value."""
    subj_info: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            mat = re.search(r"^set -g ([a-zA-Z_]+)\s+(\S.*)", line.strip())
            if mat is None:
                continue
            values = mat.group(2).split()
            if len(values) == 1 and values[0].startswith("$"):
                values = subj_info[values[0][1:]]
            subj_info[mat.group(1)] = values

    if "subjects" not in subj_info:
        raise ValueError(f"{path}: missing required variables ['subjects']")
    subj2attr: dict[str, dict[str, str]] = {}
    for var in ("subj_types", "cls_delta_strings"):
        vals = subj_info.get(var)
        if vals is None:
            continue
        if len(vals) != len(subj_info["subjects"]):
            raise ValueError(f"{path}: {var} has {len(vals)} values for "
                             f"{len(subj_info['subjects'])} subjects")
        subj2attr[var] = dict(zip(subj_info["subjects"], vals))
    return subj_info, subj2attr


def format_prompt_list(placeholder: str, class_token: str, prompts: Sequence[str],
                       broad_class: int = 1) -> tuple[list[str], list[str]]:
    """Each template's '{}' filled with the placeholder and with the class
    token → (subject_prompts, class_prompts)."""
    return [p.format(placeholder) for p in prompts], [p.format(class_token) for p in prompts]


def compare_folders(samples_dir: str, gt_dir: str, prompt: str | None = None,
                    clip_evaluator=None, dino_evaluator=None,
                    num_samples: int | None = None) -> dict:
    """CLIP-T (with a prompt), CLIP-I and DINO of the samples against the
    ground truth, with each folder's image count."""
    samples = load_folder_images(samples_dir, num_samples)
    gt = load_folder_images(gt_dir, num_samples)
    scores: dict = {"n_samples": len(samples), "n_gt": len(gt)}
    if clip_evaluator is not None:
        if prompt:
            scores["clip_t"] = clip_evaluator.txt_to_img_similarity([prompt], samples)
        scores["clip_i"] = clip_evaluator.img_to_img_similarity(samples, gt)
    if dino_evaluator is not None:
        scores["dino"] = dino_evaluator.img_to_img_similarity(samples, gt)
    return scores


def compare_face_folders(samples_dir: str, gt_dir: str, backend,
                         num_samples: int | None = None) -> dict:
    """Face similarity between two folders with the named backend."""
    return compare_face_images(load_folder_images(samples_dir, num_samples),
                               load_folder_images(gt_dir, num_samples), backend)


def append_score_row(csv_path: str, row: dict) -> None:
    """Append one row of scores, the header first when the file is new."""
    exists = os.path.exists(csv_path)
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            writer.writeheader()
        writer.writerow(row)
