"""Video face-similarity evaluation on the PyTorch port (the twin of
`scripts/eval_videos.py`):

    python scripts/eval_videos_torch.py --videos vids/ --ref_images subj/ \
        [--frames_per_video 8] [--scores_csv scores.csv] [--device cuda]

Samples frames from each clip with the JAX script's motion-ratio selection
(the frames whose change to the next is at or above the motions' median,
every len // n-th of them), embeds their faces with the named face backend
and scores them against the reference images (`evaluation/face_sim.py`),
on the card unless `--device cpu`. Clips are GIFs, the format the port's
video pipeline writes (`utils/image.write_gif`), decoded by the port's host
library as Pillow decodes them (`utils/image.read_gif_frames`); the JAX
script reads with OpenCV, which decodes such GIFs to the same frames.
`.mp4`, `.avi`, `.mov` and `.webm` clips raise a ValueError naming the
format: the card's machine has neither OpenCV nor any other decoder for
them.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".webm", ".gif"}


def read_video_frames(path: str) -> np.ndarray:
    """A clip's frames, uint8 [F, H, W, 3] RGB: a GIF's, composited as
    Pillow composites them; another video format raises naming it."""
    from adaface_tpu_torch.utils.image import read_gif_frames

    ext = os.path.splitext(path)[1].lower()
    if ext in VIDEO_EXTS - {".gif"}:
        raise ValueError(f"{path}: a {ext} video; the port decodes GIF clips only (no decoder "
                         "for this format without OpenCV)")
    return read_gif_frames(path)


def sample_frames(video_path: str, n_frames: int = 8,
                  motion_percentile: float = 50.0) -> list[np.ndarray]:
    """`n_frames` of a clip, picked among those that differ from the next
    frame by at least the `motion_percentile` of the clip's motions (the
    mean absolute int16 difference), at a stride of len // n_frames."""
    frames = list(read_video_frames(video_path))
    if not frames:
        return []
    motions = [float(np.abs(nxt.astype(np.int16) - cur.astype(np.int16)).mean())
               for cur, nxt in zip(frames[:-1], frames[1:])]
    if motions:
        thres = np.percentile(motions, motion_percentile)
        moving = [i for i, m in enumerate(motions) if m >= thres]
        idxs = moving or list(range(len(frames)))
    else:
        idxs = list(range(len(frames)))
    step = max(len(idxs) // n_frames, 1)
    return [frames[i] for i in idxs[::step][:n_frames]]


def main(argv=None) -> list[dict]:
    import torch

    from _common_torch import add_face_backend_arg
    from adaface_tpu_torch.evaluation.eval_utils import append_score_row
    from adaface_tpu_torch.evaluation.face_sim import (compare_face_images, load_folder_images,
                                                       make_face_backend)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--videos", required=True, help="a clip or a folder of clips")
    ap.add_argument("--ref_images", required=True)
    ap.add_argument("--frames_per_video", type=int, default=8)
    ap.add_argument("--scores_csv", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_face_backend_arg(ap)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    backend = make_face_backend(args.face_backend, device, torch.Generator(device).manual_seed(0))
    if os.path.isdir(args.videos):
        vids = sorted(os.path.join(args.videos, f) for f in os.listdir(args.videos)
                      if os.path.splitext(f)[1].lower() in VIDEO_EXTS)
    else:
        vids = [args.videos]
    refs = load_folder_images(args.ref_images)
    rows = []
    for v in vids:
        frames = sample_frames(v, args.frames_per_video)
        if not frames:
            print(f"{v}: no frames")
            continue
        row = {"video": os.path.basename(v), **compare_face_images(frames, refs, backend)}
        print(row)
        rows.append(row)
        if args.scores_csv:
            append_score_row(args.scores_csv, row)
    return rows


if __name__ == "__main__":
    main()
