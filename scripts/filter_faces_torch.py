"""Dataset face filtering and dedup on the PyTorch port (the twin of
`scripts/filter_faces.py`).

    python scripts/filter_faces_torch.py filter  --in_dir d/ [--trash_dir t/]
    python scripts/filter_faces_torch.py dedup   --in_dir d/ --thres 0.95 [--trash_dir t/]
    python scripts/filter_faces_torch.py compare --a imgs_a/ --b imgs_b/
    python scripts/filter_faces_torch.py knn     --in_dir d/ --query img.png -k 5

`filter` moves the images without a detected face to `--trash_dir`;
`dedup` the later of two faces above `--thres` cosine. The face backend is
named (`--face_backend`) and runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from _common_torch import add_face_backend_arg, embed_folder


def move(path: str, trash_dir: str | None) -> None:
    if trash_dir:
        os.makedirs(trash_dir, exist_ok=True)
        shutil.move(path, os.path.join(trash_dir, os.path.basename(path)))


def main(argv=None) -> dict:
    from adaface_tpu_torch.evaluation.eval_utils import compare_face_folders
    from adaface_tpu_torch.evaluation.face_sim import make_face_backend
    from adaface_tpu_torch.utils.image import read_image, to_rgb

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_face_backend_arg(ap)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("filter")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--trash_dir", default=None)
    p = sub.add_parser("dedup")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--thres", type=float, default=0.95)
    p.add_argument("--trash_dir", default=None)
    p = sub.add_parser("compare")
    p.add_argument("--a", required=True)
    p.add_argument("--b", required=True)
    p = sub.add_parser("knn")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("-k", type=int, default=5)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    backend = make_face_backend(args.face_backend, device, torch.Generator(device).manual_seed(0))

    if args.cmd == "filter":
        _, kept, paths = embed_folder(args.in_dir, backend)
        bad = sorted(set(paths) - set(kept))
        for p in bad:
            move(p, args.trash_dir)
        print(f"{len(kept)} with faces, {len(bad)} without"
              + (" (moved)" if args.trash_dir else ""))
        return {"kept": kept, "without": bad}
    if args.cmd == "dedup":
        embs, kept, _ = embed_folder(args.in_dir, backend)
        sim = embs @ embs.T
        drop: set[int] = set()
        for i in range(len(kept)):
            if i not in drop:
                drop.update(j for j in range(i + 1, len(kept)) if sim[i, j] > args.thres)
        for j in sorted(drop):
            move(kept[j], args.trash_dir)
            print(f"dup: {kept[j]}")
        print(f"{len(drop)} near-duplicates (cos > {args.thres})")
        return {"dups": [kept[j] for j in sorted(drop)]}
    if args.cmd == "compare":
        scores = compare_face_folders(args.a, args.b, backend)
        print(scores)
        return scores
    embs, kept, _ = embed_folder(args.in_dir, backend)
    q = backend.detect_and_embed(to_rgb(read_image(args.query)))
    if q is None:
        raise SystemExit("no face in query image")
    sims = embs @ q
    order = np.argsort(-sims)[:args.k]
    for idx in order:
        print(f"{sims[idx]:.4f}  {kept[idx]}")
    return {"knn": [(kept[i], float(sims[i])) for i in order]}


if __name__ == "__main__":
    main()
