"""The evaluation harness: CLIP-T / CLIP-I (`clip_eval`), DINO
(`dino_eval`), face similarity (`face_sim`), the prompt sets and the
folder comparisons and score rows (`eval_utils`)."""

from adaface_tpu_torch.evaluation.eval_utils import (
    compare_face_folders,
    compare_folders,
    format_prompt_list,
    parse_range_str,
)
