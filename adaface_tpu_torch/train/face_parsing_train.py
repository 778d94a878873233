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
import colorsys
import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch import native
from adaface_tpu_torch.models.bisenet import BiSeNet, build_bisenet
from adaface_tpu_torch.utils.image import (paste_pad, read_image, resize_nearest_pil,
                                           to_grey, to_rgb)

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


def draw_face_parsing(rng: np.random.Generator, shape: tuple, crop_size: int = 448,
                      scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0), brightness: float = 0.5,
                      contrast: float = 0.5, saturation: float = 0.5) -> dict:
    """The random decisions of `augment_face_parsing` for an image of
    `shape` [H, W, ...], drawn from `rng` in the order the JAX package
    draws them: the scale, the crop's corner, the flip, the three jitter
    factors."""
    scale = float(rng.choice(np.asarray(scales)))
    w, h = int(shape[1] * scale), int(shape[0] * scale)
    x0 = int(rng.integers(0, max(w, crop_size) - crop_size + 1))
    y0 = int(rng.integers(0, max(h, crop_size) - crop_size + 1))
    flip = rng.random() < 0.5
    fb = float(rng.uniform(max(0, 1 - brightness), 1 + brightness))
    fc = float(rng.uniform(max(0, 1 - contrast), 1 + contrast))
    fs = float(rng.uniform(max(0, 1 - saturation), 1 + saturation))
    return dict(size=(w, h), x0=x0, y0=y0, flip=flip, jitter=(fb, fc, fs))


def apply_face_parsing(img: np.ndarray, label: np.ndarray, d: dict, crop_size: int = 448):
    """The pixels of `augment_face_parsing` under the decisions `d`
    (`draw_face_parsing`). Pillow's BILINEAR resize through the host
    library (`native.resize_pil`); NEAREST, `Image.new` + `paste`,
    `crop` and `FLIP_LEFT_RIGHT` in numpy (`utils/image.py`), the same bits."""
    w, h = d["size"]
    im = native.resize_pil(img, (w, h))
    lb = resize_nearest_pil(label, (w, h))

    # pad if needed, then the crop
    pad_w, pad_h = max(crop_size - w, 0), max(crop_size - h, 0)
    if pad_w or pad_h:
        w, h = w + pad_w, h + pad_h
        im, lb = paste_pad(im, (w, h)), paste_pad(lb, (w, h), IGNORE_LABEL)
    x0, y0 = d["x0"], d["y0"]
    im = im[y0:y0 + crop_size, x0:x0 + crop_size]
    lb = lb[y0:y0 + crop_size, x0:x0 + crop_size]

    if d["flip"]:
        im, lb = im[:, ::-1], lb[:, ::-1]

    arr = np.asarray(im).astype(np.float32)
    # ColorJitter: brightness/contrast/saturation each ~U[1-r, 1+r]
    fb, fc, fs = d["jitter"]
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


def augment_face_parsing(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
                         crop_size: int = 448, scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
                         brightness: float = 0.5, contrast: float = 0.5,
                         saturation: float = 0.5):
    """RandomScale → RandomCrop → HorizontalFlip → ColorJitter, the
    composition in `face_dataset.py:34-44` (p_flip=0.5, jitter 0.5), on
    img [H, W, 3] uint8 and label [H, W] uint8 → (CHW fp32, label uint8),
    the JAX package's arrays from the same generator."""
    d = draw_face_parsing(rng, img.shape, crop_size, scales, brightness, contrast, saturation)
    return apply_face_parsing(img, label, d, crop_size)


class FaceMaskDataset:
    """CelebAMask-HQ-style folder pairs: `images/*.jpg` + `labels/*.png`
    (`face_dataset.py:15-33`). `batches` and `eval_batches` prepare a
    batch's items on a pool of threads (the decoder and the resample run in
    the host library, which lets go of the GIL) with the draws taken in
    item order, so a batch holds what `__getitem__` one item at a time
    gives."""

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

    def load(self, i):
        """Item i's image [H, W, 3] and label [H, W], uint8."""
        ip, lp = self.items[i]
        return to_rgb(read_image(ip)), to_grey(read_image(lp))

    def __getitem__(self, i):
        return augment_face_parsing(*self.load(i), self.rng, self.crop_size)

    def get_eval(self, i):
        """Deterministic (image, label) pair: resize to crop_size with no
        augmentation, the standard segmentation-eval protocol."""
        img, lbl = self.load(i)
        s = self.crop_size
        img = native.resize_pil(img, (s, s))
        lbl = resize_nearest_pil(lbl, (s, s))
        arr = img.astype(np.float32) / 255.0
        arr = (arr - np.asarray([0.485, 0.456, 0.406])) / np.asarray([0.229, 0.224, 0.225])
        return arr.transpose(2, 0, 1).astype(np.float32), np.asarray(lbl, np.uint8)

    @staticmethod
    def _pool(batch_size: int) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max(1, min(batch_size, len(os.sched_getaffinity(0)))))

    def batches(self, batch_size: int, steps: int):
        n = len(self.items)
        with self._pool(batch_size) as pool:
            for _ in range(steps):
                idx = [int(i) for i in self.rng.integers(0, n, batch_size)]
                pairs = list(pool.map(self.load, idx))
                draws = [draw_face_parsing(self.rng, img.shape, self.crop_size)
                         for img, _ in pairs]
                items = list(pool.map(lambda p, d: apply_face_parsing(*p, d, self.crop_size),
                                      pairs, draws))
                yield np.stack([p[0] for p in items]), np.stack([p[1] for p in items])

    def eval_batches(self, batch_size: int):
        """Sequential full pass, deterministic preprocessing: each image
        seen exactly once, no augmentation."""
        with self._pool(batch_size) as pool:
            for start in range(0, len(self.items), batch_size):
                pairs = list(pool.map(self.get_eval, range(
                    start, min(start + batch_size, len(self.items)))))
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


def parsing_palette(n_classes: int = 19) -> np.ndarray:
    """[C, 3] uint8 colors: background black, the parts on a golden-ratio
    walk of hues, saturation alternating 0.85 / 0.6."""
    colors = [(0, 0, 0)]
    for i in range(1, n_classes):
        h = (i * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.85 if i % 2 else 0.6, 1.0)
        colors.append((int(r * 255), int(g * 255), int(b * 255)))
    return np.asarray(colors, np.uint8)


def colorize_parsing(parsing: np.ndarray, n_classes: int = 19) -> np.ndarray:
    """[H, W] int parsing map → [H, W, 3] uint8 color map."""
    return parsing_palette(n_classes)[np.clip(parsing, 0, n_classes - 1)]


def overlay_parsing(image: np.ndarray, parsing: np.ndarray, alpha: float = 0.6) -> np.ndarray:
    """A parsing color map blended over an RGB uint8 image (the reference's
    `vis_parsing_maps`, `face_parsing/evaluate.py:25-60`: 0.4 image + 0.6
    colored annotation), in float32, truncated to uint8."""
    color = colorize_parsing(parsing).astype(np.float32)
    out = image.astype(np.float32) * (1 - alpha) + color * alpha
    return np.clip(out, 0, 255).astype(np.uint8)


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
