"""Extract N evenly spaced frames of a clip on the PyTorch port (the twin of
`scripts/extract_frames.py`):

    python scripts/extract_frames_torch.py clip.gif out/frame 16

The frames at `np.linspace(0, total - 1, N)` (cast to int) are written as
`{out}_{i}.png` (`utils/image.write_png`); a clip shorter than N frames
writes nothing and exits 1. Clips are GIFs, decoded by the port's host
library as Pillow decodes them (`utils/image.read_gif_frames`); `.mp4`,
`.avi`, `.mov` and `.webm` raise a ValueError naming the format: the card's
machine has neither OpenCV nor any other decoder for them.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def extract_frames(video_path: str, out_prefix: str, num_frames: int) -> bool:
    import numpy as np

    from adaface_tpu_torch.utils.image import write_png
    from eval_videos_torch import read_video_frames

    frames = read_video_frames(video_path)
    total = len(frames)
    if total < num_frames:
        print(f"Number of frames must be >= {num_frames} (video has {total})")
        return False
    for i, k in enumerate(np.linspace(0, max(total - 1, 0), num_frames, dtype=int)):
        write_png(f"{out_prefix}_{i}.png", frames[k])
    print(f"Frames extracted to {out_prefix}_*.png")
    return True


if __name__ == "__main__":
    if len(sys.argv) != 4:
        print(__doc__)
        sys.exit(2)
    ok = extract_frames(sys.argv[1], sys.argv[2], int(sys.argv[3]))
    sys.exit(0 if ok else 1)
