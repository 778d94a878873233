"""Face-embedding dataset utilities on the PyTorch port (the twin of
`scripts/face_tool.py`): the k nearest neighbours of each face of a folder
in embedding space (with a greedy near-duplicate list), all-pairs face
similarity between two folders, and a detection report.

    python scripts/face_tool_torch.py knn     <folder> -k 5 [--dedup_thres 0.95] [--rm]
    python scripts/face_tool_torch.py compare <folder_a> <folder_b>
    python scripts/face_tool_torch.py det     <folder>

The face backend is named (`--face_backend`, the in-repo RetinaFace +
ArcFace stack by default, random weights) and runs on the card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from _common_torch import add_face_backend_arg, embed_folder


def cmd_knn(args, backend) -> dict:
    embs, paths, _ = embed_folder(args.folder, backend)
    if len(paths) < 2:
        print(f"only {len(paths)} faces found, nothing to do")
        return {"dups": []}
    sim = embs @ embs.T  # embeddings are L2-normalized
    np.fill_diagonal(sim, -1.0)
    dups = set()
    for i, p in enumerate(paths):
        order = np.argsort(-sim[i])[:args.k]
        row = ", ".join(f"{os.path.basename(paths[j])}:{sim[i, j]:.3f}" for j in order)
        print(f"{os.path.basename(p)} -> {row}")
        # greedy dedup: the later file of any pair above the threshold
        dups.update(paths[j] for j in order if sim[i, j] >= args.dedup_thres and j > i)
    if dups:
        print(f"\n{len(dups)} near-duplicates (sim >= {args.dedup_thres}):")
        for p in sorted(dups):
            print(f"  {p}")
        if args.rm:
            for p in sorted(dups):
                os.remove(p)
            print("removed.")
    return {"dups": sorted(dups)}


def cmd_compare(args, backend) -> dict:
    from adaface_tpu_torch.evaluation.face_sim import calc_faces_similarities

    embs_a, _, _ = embed_folder(args.folder_a, backend)
    embs_b, _, _ = embed_folder(args.folder_b, backend)
    if not len(embs_a) or not len(embs_b):
        print("no faces found in one of the folders")
        return {}
    sim = calc_faces_similarities(embs_a, embs_b)
    print(f"{args.folder_a} ({len(embs_a)}) vs {args.folder_b} ({len(embs_b)}): "
          f"avg face sim {sim:.4f}")
    return {"face_sim": sim}


def cmd_det(args, backend) -> dict:
    _, kept, paths = embed_folder(args.folder, backend)
    for p in paths:
        print(f"{'face' if p in kept else 'NO FACE':8s} {p}")
    print(f"\n{len(kept)}/{len(paths)} images with a detected face")
    return {"faces": len(kept), "images": len(paths)}


def main(argv=None) -> dict:
    from adaface_tpu_torch.evaluation.face_sim import make_face_backend

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_face_backend_arg(ap)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("knn")
    p.add_argument("folder")
    p.add_argument("-k", type=int, default=5)
    p.add_argument("--dedup_thres", type=float, default=0.95)
    p.add_argument("--rm", action="store_true", help="delete near-duplicates (off by default)")
    p = sub.add_parser("compare")
    p.add_argument("folder_a")
    p.add_argument("folder_b")
    p = sub.add_parser("det")
    p.add_argument("folder")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    backend = make_face_backend(args.face_backend, device, torch.Generator(device).manual_seed(0))
    return {"knn": cmd_knn, "compare": cmd_compare, "det": cmd_det}[args.cmd](args, backend)


if __name__ == "__main__":
    main()
