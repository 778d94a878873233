"""BiSeNet face-parsing training: OHEM loss + warmup/poly SGD.

Counterpart of `adaface_tpu/train/face_parsing_train.py` (the reference's
`face_parsing/train.py`, `loss.py`, `optimizer.py`, `face_dataset.py`,
`transform.py`). Train-mode BN runs the hand-written BN + activation
kernels through `models/bisenet.py`.

    python -m adaface_tpu_torch.train.face_parsing_train --data_root <root with images/ labels/>
        [--max_iter 80000] [--batch_size 16] [--crop_size 448] [--out ckpt.pt]

The optimizer is `torch.optim.SGD` with four parameter groups (weight decay
on conv weights only; 10× learning rate on the FFM and output heads). The
optax chain of the JAX package — decayed weights added to the gradient,
momentum trace from 0, then lr·mul — is the same update as torch's SGD,
whose first momentum buffer is the gradient itself. Update k (from 0) uses
`warmup_poly_lr(k)`, as optax counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch.models.bisenet import BiSeNet, build_bisenet

IGNORE_LABEL = 255
LR_MUL_MODULES = ("ffm", "out", "out16", "out32")


# ---------------------------------------------------------------------------
# Losses (`face_parsing/loss.py`)
# ---------------------------------------------------------------------------


def ohem_ce_loss(logits, labels, thresh: float = 0.7, n_min: int | None = None):
    """Online hard-example mining CE over logits [B, C, H, W] and labels
    [B, H, W] (IGNORE_LABEL ignored): the mean CE of every pixel above
    -log(thresh) if the n_min-th largest is above it, else of the top n_min."""
    b, _, h, w = logits.shape
    if n_min is None:
        n_min = b * h * w // 16
    n_min = max(min(n_min, b * h * w), 1)

    valid = labels != IGNORE_LABEL
    lbl = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, lbl[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0).reshape(-1)

    thresh_l = -math.log(thresh)
    topk = torch.topk(nll, n_min, sorted=False).values
    use_thresh = topk.min() > thresh_l
    above = nll > thresh_l
    mean_above = torch.where(above, nll, 0.0).sum() / above.sum().clamp(min=1)
    return torch.where(use_thresh, mean_above, topk.mean())


def softmax_focal_loss(logits, labels, gamma: float = 2.0):
    """`loss.py:31-43` (provided but unused by the reference's train.py)."""
    valid = labels != IGNORE_LABEL
    lbl = torch.where(valid, labels, 0).long()
    logits = logits.float()
    p = torch.softmax(logits, dim=1)
    logp = F.log_softmax(logits, dim=1) * (1.0 - p) ** gamma
    nll = torch.where(valid, -logp.gather(1, lbl[:, None])[:, 0], 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# Warmup-exponential → poly SGD (`face_parsing/optimizer.py`)
# ---------------------------------------------------------------------------


def warmup_poly_lr(step: int, lr0: float = 1e-2, warmup_steps: int = 1000,
                   warmup_start_lr: float = 1e-5, max_iter: int = 80_000,
                   power: float = 0.9) -> float:
    """`optimizer.py:42-48`: exponential ramp to lr0, then poly decay; in
    fp32, as the JAX schedule computes it."""
    step = np.float32(step)
    wf = np.float32((lr0 / warmup_start_lr) ** (1.0 / warmup_steps))
    if step <= warmup_steps:
        return float(np.float32(warmup_start_lr) * wf ** step)
    frac = np.float32(1.0) - (step - np.float32(warmup_steps)) / np.float32(
        max_iter - warmup_steps)
    return float(np.float32(lr0) * np.maximum(frac, np.float32(0.0)) ** np.float32(power))


@dataclasses.dataclass
class FaceParsingTrainConfig:
    lr0: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    warmup_steps: int = 1000
    warmup_start_lr: float = 1e-5
    max_iter: int = 80_000
    power: float = 0.9
    ohem_thresh: float = 0.7
    crop_size: int = 448
    batch_size: int = 16

    def lr(self, step: int) -> float:
        return warmup_poly_lr(step, self.lr0, self.warmup_steps, self.warmup_start_lr,
                              self.max_iter, self.power)


def make_face_parsing_optimizer(cfg: FaceParsingTrainConfig, model: BiSeNet):
    """SGD + momentum in four groups: weight decay on conv weights only
    (`_is_no_wd`: BN scale/bias have none), `lr_mul` 10 on the FFM and the
    output heads (`_is_lr_mul`). Each group's lr is set per step from
    `cfg.lr(step) · lr_mul`."""
    groups = {}
    for name, p in model.named_parameters():
        lr_mul = 10.0 if name.split(".")[0] in LR_MUL_MODULES else 1.0
        decay = p.dim() == 4  # conv kernels
        groups.setdefault((lr_mul, decay), []).append(p)
    return torch.optim.SGD(
        [{"params": ps, "lr_mul": mul, "weight_decay": cfg.weight_decay if decay else 0.0,
          "lr": cfg.lr(0) * mul}
         for (mul, decay), ps in sorted(groups.items())],
        lr=cfg.lr0, momentum=cfg.momentum)


# ---------------------------------------------------------------------------
# Train step (`face_parsing/train.py:95-141`)
# ---------------------------------------------------------------------------


def face_parsing_loss(model: BiSeNet, images, labels, cfg: FaceParsingTrainConfig):
    """Main + 2 aux OHEM losses, equally weighted (`train.py:118-121`)."""
    out, out16, out32 = model(images)
    n_min = images.shape[0] * cfg.crop_size**2 // 16
    l_main = ohem_ce_loss(out, labels, cfg.ohem_thresh, n_min)
    l_16 = ohem_ce_loss(out16, labels, cfg.ohem_thresh, n_min)
    l_32 = ohem_ce_loss(out32, labels, cfg.ohem_thresh, n_min)
    loss = l_main + l_16 + l_32
    return loss, {"loss": loss, "loss_main": l_main, "loss_aux16": l_16, "loss_aux32": l_32}


def make_face_parsing_train_step(cfg: FaceParsingTrainConfig, model: BiSeNet, optimizer):
    """→ step(images, labels) → metrics (detached tensors): forward in
    train mode, backward, and one optimizer update at `cfg.lr(k)` for the
    k-th call, counting from 0."""
    count = [0]

    def step(images, labels):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = face_parsing_loss(model, images, labels, cfg)
        loss.backward()
        lr = cfg.lr(count[0])
        for group in optimizer.param_groups:
            group["lr"] = lr * group["lr_mul"]
        optimizer.step()
        count[0] += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# Data augmentation (`face_parsing/transform.py`, `face_dataset.py`)
# ---------------------------------------------------------------------------


def augment_face_parsing(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
                         crop_size: int = 448, scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
                         brightness: float = 0.5, contrast: float = 0.5,
                         saturation: float = 0.5):
    """RandomScale → RandomCrop → HorizontalFlip → ColorJitter, the
    composition in `face_dataset.py:34-44` (p_flip=0.5, jitter 0.5), on
    img [H, W, 3] uint8 and label [H, W] uint8 → (CHW fp32, label uint8)."""
    from PIL import Image

    scale = float(rng.choice(np.asarray(scales)))
    w, h = int(img.shape[1] * scale), int(img.shape[0] * scale)
    im = Image.fromarray(img).resize((w, h), Image.BILINEAR)
    lb = Image.fromarray(label).resize((w, h), Image.NEAREST)

    # pad if needed, then random crop
    pad_w, pad_h = max(crop_size - w, 0), max(crop_size - h, 0)
    if pad_w or pad_h:
        im2 = Image.new("RGB", (w + pad_w, h + pad_h))
        im2.paste(im, (0, 0))
        lb2 = Image.new("L", (w + pad_w, h + pad_h), IGNORE_LABEL)
        lb2.paste(lb, (0, 0))
        im, lb, w, h = im2, lb2, w + pad_w, h + pad_h
    x0 = int(rng.integers(0, w - crop_size + 1))
    y0 = int(rng.integers(0, h - crop_size + 1))
    box = (x0, y0, x0 + crop_size, y0 + crop_size)
    im, lb = im.crop(box), lb.crop(box)

    if rng.random() < 0.5:
        im = im.transpose(Image.FLIP_LEFT_RIGHT)
        lb = lb.transpose(Image.FLIP_LEFT_RIGHT)

    arr = np.asarray(im).astype(np.float32)
    # ColorJitter: brightness/contrast/saturation each ~U[1-r, 1+r]
    fb = float(rng.uniform(max(0, 1 - brightness), 1 + brightness))
    fc = float(rng.uniform(max(0, 1 - contrast), 1 + contrast))
    fs = float(rng.uniform(max(0, 1 - saturation), 1 + saturation))
    arr = arr * fb
    mean = arr.mean()
    arr = (arr - mean) * fc + mean
    gray = arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
    arr = (arr - gray[..., None]) * fs + gray[..., None]
    arr = np.clip(arr, 0, 255)

    # imagenet normalize, CHW (face_dataset.py:30-33)
    arr = arr / 255.0
    arr = (arr - np.asarray([0.485, 0.456, 0.406])) / np.asarray([0.229, 0.224, 0.225])
    return arr.transpose(2, 0, 1).astype(np.float32), np.asarray(lb, np.uint8)


class FaceMaskDataset:
    """CelebAMask-HQ-style folder pairs: `images/*.jpg` + `labels/*.png`
    (`face_dataset.py:15-33`)."""

    def __init__(self, root: str, crop_size: int = 448, seed: int = 0):
        self.img_dir = os.path.join(root, "images")
        self.lbl_dir = os.path.join(root, "labels")
        names = sorted(os.listdir(self.img_dir))
        self.items = [(os.path.join(self.img_dir, n),
                       os.path.join(self.lbl_dir, os.path.splitext(n)[0] + ".png"))
                      for n in names]
        self.crop_size = crop_size
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        from PIL import Image

        ip, lp = self.items[i]
        img = np.asarray(Image.open(ip).convert("RGB"))
        lbl = np.asarray(Image.open(lp).convert("L"))
        return augment_face_parsing(img, lbl, self.rng, self.crop_size)

    def get_eval(self, i):
        """Deterministic (image, label) pair: resize to crop_size with no
        augmentation, the standard segmentation-eval protocol."""
        from PIL import Image

        ip, lp = self.items[i]
        s = self.crop_size
        img = Image.open(ip).convert("RGB").resize((s, s), Image.BILINEAR)
        lbl = Image.open(lp).convert("L").resize((s, s), Image.NEAREST)
        arr = np.asarray(img).astype(np.float32) / 255.0
        arr = (arr - np.asarray([0.485, 0.456, 0.406])) / np.asarray([0.229, 0.224, 0.225])
        return arr.transpose(2, 0, 1).astype(np.float32), np.asarray(lbl, np.uint8)

    def batches(self, batch_size: int, steps: int):
        n = len(self.items)
        for _ in range(steps):
            idx = self.rng.integers(0, n, batch_size)
            pairs = [self[int(i)] for i in idx]
            yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def eval_batches(self, batch_size: int):
        """Sequential full pass, deterministic preprocessing: each image
        seen exactly once, no augmentation."""
        for start in range(0, len(self.items), batch_size):
            pairs = [self.get_eval(i)
                     for i in range(start, min(start + batch_size, len(self.items)))]
            yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


# ---------------------------------------------------------------------------
# Evaluation (`face_parsing/evaluate.py` equivalents)
# ---------------------------------------------------------------------------


def confusion_matrix(pred: np.ndarray, label: np.ndarray, n_classes: int = 19) -> np.ndarray:
    """Accumulate an [C, C] confusion matrix (rows = ground truth)."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    valid = label < n_classes
    idx = label[valid].astype(np.int64) * n_classes + pred[valid].astype(np.int64)
    return np.bincount(idx, minlength=n_classes * n_classes).reshape(n_classes, n_classes)


def miou_from_confusion(cm: np.ndarray) -> dict:
    """Per-class IoU + mean IoU + pixel accuracy from a confusion matrix."""
    cm = cm.astype(np.float64)
    tp = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - tp
    iou = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
    present = union > 0
    return {"per_class_iou": iou,
            "miou": float(np.nanmean(iou[present])) if present.any() else 0.0,
            "pixel_acc": float(tp.sum() / max(cm.sum(), 1))}


def evaluate_face_parsing(model: BiSeNet, dataset: FaceMaskDataset, batch_size: int = 8,
                          max_batches: int | None = None, n_classes: int = 19) -> dict:
    """mIoU and pixel accuracy of an eval-mode BiSeNet over one sequential
    pass of `dataset.eval_batches` (`max_batches` truncates it)."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    cm = np.zeros((n_classes, n_classes), np.int64)
    try:
        with torch.inference_mode():
            for bi, (images, labels) in enumerate(dataset.eval_batches(batch_size)):
                pred = model(torch.from_numpy(images).to(device)).argmax(1).cpu().numpy()
                cm += confusion_matrix(pred, labels, n_classes)
                if max_batches is not None and bi + 1 >= max_batches:
                    break
    finally:
        model.train(was_training)
    return miou_from_confusion(cm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--max_iter", type=int, default=80_000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--crop_size", type=int, default=448)
    ap.add_argument("--lr0", type=float, default=1e-2)
    ap.add_argument("--out", default="face_parsing_ckpt.pt")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = FaceParsingTrainConfig(lr0=args.lr0, max_iter=args.max_iter,
                                 crop_size=args.crop_size, batch_size=args.batch_size)
    device = torch.device(args.device)
    model = build_bisenet(device, torch.Generator(device=device).manual_seed(args.seed))
    opt = make_face_parsing_optimizer(cfg, model)
    step_fn = make_face_parsing_train_step(cfg, model, opt)

    ds = FaceMaskDataset(args.data_root, crop_size=args.crop_size, seed=args.seed)
    print(f"dataset: {len(ds)} images")

    t0 = time.time()
    for it, (images, labels) in enumerate(ds.batches(args.batch_size, args.max_iter)):
        metrics = step_fn(torch.from_numpy(images).to(device),
                          torch.from_numpy(labels.astype(np.int64)).to(device))
        if (it + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            rate = (it + 1) / (time.time() - t0)
            print(f"it {it + 1}/{args.max_iter} loss {m['loss']:.4f} "
                  f"(main {m['loss_main']:.4f}) {rate:.2f} it/s")

    torch.save(model.state_dict(), args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
