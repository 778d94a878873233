"""Train the BiSeNet face parser on the PyTorch port (the twin of
`scripts/train_face_parsing.py`, the reference's `face_parsing/train.py`):
a thin entry over `adaface_tpu_torch.train.face_parsing_train.main`.

    python scripts/train_face_parsing_torch.py --data_root <root with images/ labels/> \
        [--max_iter 80000] [--batch_size 16] [--crop_size 448] [--out face_parsing_ckpt.pt]

OHEM cross-entropy on the main and two auxiliary heads, SGD with momentum
0.9 and weight decay 5e-4, 1000 warm-up steps then poly 0.9 decay, 10× the
learning rate on the FFM and output heads; train-mode BN on the
hand-written BN + activation kernels. Runs on the card unless `--device
cpu`. The saved state dict is what `eval_face_parsing_torch.py`,
`gen_face_masks_torch.py` and `makeup_demo_torch.py` take as
`--bisenet_ckpt`.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adaface_tpu_torch.train.face_parsing_train import main  # noqa: E402

if __name__ == "__main__":
    main()
