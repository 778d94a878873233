"""Evaluation generator and scorer on the PyTorch port (the twin of
`scripts/txt2img_eval.py`, the reference's `stable_txt2img.py`).

Generates `--n_samples` images for each prompt of a prompt set with a
subject's ada embeddings, then scores each prompt's folder against the
reference photos, CLIP-T / CLIP-I on ViT-B/32, DINO ViT-S/16 and face
similarity, and appends one CSV row a prompt:

    python scripts/txt2img_eval_torch.py --subject subjects/alice \
        --prompt_set dreambench --out_dir eval_out/alice \
        --calc_face_sim --compare_with subjects/alice --scores_csv scores.csv

Runs on the card (`--device cpu` for the CPU). The evaluators and the face
backend have random weights from fixed seeds until real ones are in the
repository: their scores measure the plumbing, not quality. Prompt i's
images come from a `torch.Generator` seeded `--seed` + i.
"""

from __future__ import annotations

import argparse
import os

import torch

from _common_torch import (add_face_backend_arg, add_model_args, build_wrapper,
                           load_subject_images, save_images)

# keyword arguments of the evaluators (their configurations: ViT-B/32 and
# DINO ViT-S/16 when empty)
CLIP_KW: dict = {}
DINO_KW: dict = {}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_model_args(ap)
    ap.add_argument("--subject", required=True)
    ap.add_argument("--subject_name", default=None)
    ap.add_argument("--class_token", default="person",
                    help="class word put into the prompts for CLIP-T (the reference scores "
                         "against the class prompt, e.g. 'man' / 'woman')")
    ap.add_argument("--prompt_set", default="dreambench",
                    choices=["dreambench", "community", "all"])
    ap.add_argument("--prompt_range", default=None, help="e.g. '0-4,7' to select prompts")
    ap.add_argument("--n_samples", type=int, default=4, help="per prompt")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out_dir", default="eval_out")
    ap.add_argument("--calc_face_sim", action="store_true")
    ap.add_argument("--compare_with", default=None,
                    help="ground-truth folder for CLIP-I / DINO / face similarity")
    ap.add_argument("--scores_csv", default=None)
    ap.add_argument("--guidance_scale_min", type=float, default=None)
    ap.add_argument("--config", default=None,
                    help="inference YAML (configs/inference.yaml): scheduler, steps and "
                         "guidance defaults")
    add_face_backend_arg(ap)
    args = ap.parse_args(argv)
    if args.config:
        apply_config(args, args.config)
    return args


def apply_config(args, path: str) -> None:
    """The inference YAML's `pipeline` values (steps, guidance, size) and
    `model.id2ada_encoder` over the arguments, read by the port's YAML
    reader."""
    from adaface_tpu_torch.utils.config import load

    icfg = load(path) or {}
    pipe_cfg = icfg.get("pipeline") or {}
    for yaml_key, attr in (("num_inference_steps", "num_inference_steps"),
                           ("guidance_scale", "guidance_scale"),
                           ("guidance_scale_min", "guidance_scale_min"),
                           ("image_size", "size")):
        if pipe_cfg.get(yaml_key) is not None:
            setattr(args, attr, pipe_cfg[yaml_key])
    if (icfg.get("model") or {}).get("id2ada_encoder"):
        args.encoder = icfg["model"]["id2ada_encoder"]


def select_prompts(prompt_set: str, prompt_range: str | None) -> list[str]:
    from adaface_tpu_torch.evaluation.eval_utils import parse_range_str
    from adaface_tpu_torch.evaluation.prompt_sets import PROMPT_SETS

    prompts = PROMPT_SETS[prompt_set]
    sel = parse_range_str(prompt_range)
    return prompts if sel is None else [prompts[i] for i in sel]


def generate(wrapper, prompts: list[str], out_dir: str, n_samples: int, size: int, seed: int,
             steps: int | None, class_token: str = "person") -> list[tuple[str, str]]:
    """Prompt i (its '{}' the subject's placeholder) → `n_samples` PNGs in
    `out_dir/pNN`, drawn from a generator seeded `seed` + i on the
    wrapper's device; → [(folder, the class prompt it is scored against)]."""
    placeholder = wrapper.update_prompt("")
    device = wrapper.pipeline.m.device
    dirs = []
    for pi, tmpl in enumerate(prompts):
        prompt = tmpl.format(placeholder)
        out = wrapper.forward(prompt, num_images=n_samples,
                              generator=torch.Generator(device).manual_seed(seed + pi),
                              height=size, width=size, update_prompt=False,
                              num_inference_steps=steps)
        d = os.path.join(out_dir, f"p{pi:02d}")
        save_images(out, d)
        dirs.append((d, tmpl.format(class_token)))
        print(f"[{pi + 1}/{len(prompts)}] {prompt!r}")
    return dirs


def score(dirs: list[tuple[str, str]], subject_name: str, compare_with: str | None,
          face_dir: str | None, clip_ev, dino_ev, backend,
          scores_csv: str | None = None) -> list[dict]:
    """Each folder's scores: CLIP-T, CLIP-I and DINO against `compare_with`,
    face similarity against `face_dir` (None: skipped), one CSV row each."""
    from adaface_tpu_torch.evaluation.eval_utils import (append_score_row,
                                                         compare_face_folders, compare_folders)

    rows = []
    for d, prompt_text in dirs:
        scores = {"subject": subject_name, "prompt": prompt_text, "dir": d}
        if compare_with:
            scores.update(compare_folders(d, compare_with, prompt=prompt_text,
                                          clip_evaluator=clip_ev, dino_evaluator=dino_ev))
        if face_dir:
            scores.update(compare_face_folders(d, face_dir, backend))
        if scores_csv:
            append_score_row(scores_csv, scores)
        print(scores)
        rows.append(scores)
    return rows


def main(argv=None) -> list[dict]:
    from adaface_tpu_torch.evaluation.clip_eval import CLIPEvaluator
    from adaface_tpu_torch.evaluation.dino_eval import DINOEvaluator
    from adaface_tpu_torch.evaluation.face_sim import make_face_backend

    args = parse_args(argv)
    wrapper = build_wrapper(args, "text2img")
    ada = wrapper.prepare_adaface_embeddings(images=load_subject_images(args.subject))
    if ada is None:
        raise SystemExit("no face detected in subject images")
    subj_name = args.subject_name or os.path.basename(os.path.normpath(args.subject))
    dirs = generate(wrapper, select_prompts(args.prompt_set, args.prompt_range), args.out_dir,
                    args.n_samples, args.size, args.seed, args.num_inference_steps,
                    args.class_token)
    if not (args.compare_with or args.calc_face_sim):
        return []
    device = torch.device(args.device)
    clip_ev = CLIPEvaluator(device, torch.Generator(device).manual_seed(0), **CLIP_KW)
    dino_ev = DINOEvaluator(device, torch.Generator(device).manual_seed(0), **DINO_KW)
    backend = (make_face_backend(args.face_backend, device, torch.Generator(device).manual_seed(0))
               if args.calc_face_sim else None)
    return score(dirs, subj_name, args.compare_with,
                 (args.compare_with or args.subject) if args.calc_face_sim else None,
                 clip_ev, dino_ev, backend, args.scores_csv)


if __name__ == "__main__":
    main()
