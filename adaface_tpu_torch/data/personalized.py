"""Training data pipeline (host-side).

Counterpart of `adaface_tpu/data/personalized.py` (`PersonalizedBase`,
`SubjectSampler`, `collate_batch`), numpy on the host, the same draws from
the same RandomState:

- scans per-subject folders (and mixed-subject folders) for images, pairs
  `*_mask.png` fg masks and `.txt` captions, reads `metainfo.json` person
  types;
- per item: RGB load → pad to square → NEAREST resize → random hflip →
  random downscale into the canvas in [0.4, 1] + random roll shift, with an
  aug_mask recording the pixels the image covers, through the port's host
  library (`native.prepare_item`; `augment_numpy`, the JAX package's numpy
  path, is its plain reference, the same bits);
- the 20 training prompt variants built around the subject placeholder
  with ", " filler expansion (`generate_prompts`);
- `SubjectSampler`: image-count-weighted subject sampling, skipping
  non-face subjects, one subject per batch.

Images are read by `utils/image.read_image` (PNG, JPEG, BMP: the card's
machine has no PIL); another format (WebP among the listed extensions)
raises with its path.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

import numpy as np

from adaface_tpu_torch import native
from adaface_tpu_torch.data.compositions import sample_compositions
from adaface_tpu_torch.utils.image import (pad_to_square, read_image, resize_nearest_pil,
                                           to_grey, to_rgb)

IMG_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp"}

BASE_TEMPLATES = [
    "a photo of a {}",
    "a picture of a {}",
    "a cropped photo of a {}",
    "a close-up photo of a {}",
    "a good photo of a {}",
]
FP_TEMPLATE = "face portrait of {}"
P_TEMPLATE = "a portrait of {}"


@dataclass
class Subject:
    name: str
    folder: str
    image_paths: list[str] = field(default_factory=list)
    mask_paths: list[str | None] = field(default_factory=list)
    caption_paths: list[str | None] = field(default_factory=list)
    cls_delta_string: str = "person"
    is_face: bool = True
    # True for FFHQ-style folders where every image is a different person
    # (`mix_subj_data_roots`, reference `personalized.py:130-168`)
    is_mix: bool = False


class PersonalizedBase:
    def __init__(
        self,
        data_roots: str | list[str],
        mix_subj_data_roots: str | list[str] | None = None,
        subject_string: str = "z",
        num_vectors_per_subj_token: int = 16,
        size: int = 512,
        flip_p: float = 0.5,
        scale_range: tuple[float, float] = (0.4, 1.0),
        shift_p: float = 0.5,
        max_shift_frac: float = 0.125,
        default_cls_delta_string: str = "person",
        rand_scale_p: float = 1.0,
        seed: int | None = None,
        # cap images per (non-mix) subject to speed loading
        # (reference `personalized.py:208-210`); 0 disables
        max_num_images_per_subject: int = 100,
    ):
        if isinstance(data_roots, str):
            data_roots = [data_roots]
        self.size = size
        self.subject_string = subject_string
        self.num_vectors = num_vectors_per_subj_token
        self.flip_p = flip_p
        self.scale_range = scale_range
        self.shift_p = shift_p
        self.max_shift_frac = max_shift_frac
        self.rand_scale_p = rand_scale_p
        self.rng = np.random.RandomState(seed)
        self.max_num_images_per_subject = max_num_images_per_subject

        self.subjects: list[Subject] = []
        for root in data_roots:
            self._scan_root(root, default_cls_delta_string)
        if mix_subj_data_roots:
            if isinstance(mix_subj_data_roots, str):
                mix_subj_data_roots = [mix_subj_data_roots]
            for root in mix_subj_data_roots:
                self._scan_mix_root(root, default_cls_delta_string)
        self.subject_names = [s.name for s in self.subjects]
        self.subjects_are_faces = [s.is_face for s in self.subjects]
        self._flat_index = [
            (si, ii)
            for si, s in enumerate(self.subjects)
            for ii in range(len(s.image_paths))
        ]

    # -------------------------------------------------------------- scanning
    def _scan_root(self, root: str, default_cls: str):
        meta = {}
        meta_path = os.path.join(root, "metainfo.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        subdirs = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not subdirs:  # root itself is a single subject folder
            subdirs = [""]
        for d in subdirs:
            folder = os.path.join(root, d) if d else root
            name = d or os.path.basename(os.path.normpath(root))
            subj = Subject(name=name, folder=folder)
            info = meta.get(name, {}) if isinstance(meta.get(name, {}), dict) else {}
            subj.cls_delta_string = info.get(
                "cls_delta_string", info.get("person_type", default_cls))
            subj.is_face = bool(info.get("is_face", True))
            for fn in sorted(os.listdir(folder)):
                stem, ext = os.path.splitext(fn)
                if ext.lower() not in IMG_EXTS or stem.endswith("_mask"):
                    continue
                path = os.path.join(folder, fn)
                mask = os.path.join(folder, stem + "_mask.png")
                cap = os.path.join(folder, stem + ".txt")
                subj.image_paths.append(path)
                subj.mask_paths.append(mask if os.path.exists(mask) else None)
                subj.caption_paths.append(cap if os.path.exists(cap) else None)
            cap = self.max_num_images_per_subject
            if cap > 0 and len(subj.image_paths) > cap:
                subj.image_paths = subj.image_paths[:cap]
                subj.mask_paths = subj.mask_paths[:cap]
                subj.caption_paths = subj.caption_paths[:cap]
            if subj.image_paths:
                self.subjects.append(subj)

    def _scan_mix_root(self, root: str, default_cls: str):
        """FFHQ-style mixed-subject folder: one Subject entry holding many
        different people, one image each (reference `personalized.py:161-228`:
        the folder is a single subj_root with `is_mix_subj=True`; filenames
        are not sorted since such folders may hold 100k+ images)."""
        subj = Subject(name=os.path.basename(os.path.normpath(root)),
                       folder=root, cls_delta_string=default_cls, is_mix=True)
        names = os.listdir(root)
        name_set = set(names)
        for fn in names:
            stem, ext = os.path.splitext(fn)
            if ext.lower() not in IMG_EXTS or stem.endswith("_mask"):
                continue
            subj.image_paths.append(os.path.join(root, fn))
            mask = stem + "_mask.png"
            subj.mask_paths.append(
                os.path.join(root, mask) if mask in name_set else None)
            cap = stem + ".txt"
            subj.caption_paths.append(
                os.path.join(root, cap) if cap in name_set else None)
        if subj.image_paths:
            self.subjects.append(subj)

    # ------------------------------------------------------------------ api
    def __len__(self):
        return len(self._flat_index)

    def num_subjects(self):
        return len(self.subjects)

    def images_per_subject(self):
        return [len(s.image_paths) for s in self.subjects]

    # ------------------------------------------------------- augmentation
    def _augment(self, img: np.ndarray, fg_mask: np.ndarray | None):
        """hflip + random downscale-into-canvas + random roll shift →
        (image [H, W, 3] float32 in [-1, 1], fg_mask [H, W], aug_mask [H, W]);
        the decisions are drawn first, in the JAX package's order, then the
        pixels go through the host library's `prepare_item` (a library
        that cannot be built or loaded raises)."""
        s = self.size
        do_flip = self.rng.rand() < self.flip_p
        scale = (self.rng.uniform(*self.scale_range)
                 if self.rng.rand() < self.rand_scale_p else 1.0)
        if self.rng.rand() < self.shift_p:
            max_shift = int(s * self.max_shift_frac)
            dy = int(self.rng.randint(-max_shift, max_shift + 1))
            dx = int(self.rng.randint(-max_shift, max_shift + 1))
        else:
            dy = dx = 0
        return native.prepare_item(img, fg_mask, s, do_flip, scale, dy, dx)

    def __getitem__(self, index) -> dict:
        if isinstance(index, tuple):
            si, ii = index
        else:
            si, ii = self._flat_index[index % len(self._flat_index)]
        subj = self.subjects[si]
        path = subj.image_paths[ii]
        size = (self.size, self.size)
        img = resize_nearest_pil(pad_to_square(to_rgb(read_image(path))), size)

        fg_mask = None
        if subj.mask_paths[ii] is not None:
            m = resize_nearest_pil(pad_to_square(to_grey(read_image(subj.mask_paths[ii]))),
                                   size)
            fg_mask = (m > 127).astype(np.float32)

        image, fg_mask, aug_mask = self._augment(img, fg_mask)

        caption = None
        if subj.caption_paths[ii] is not None:
            with open(subj.caption_paths[ii]) as f:
                caption = f.read().strip()

        example = {
            "image": image,  # [S, S, 3] in [-1, 1]
            "fg_mask": fg_mask,
            "aug_mask": aug_mask,
            "image_path": path,
            "caption": caption,
            "subject_idx": si,
            "is_face": subj.is_face,
            "is_in_mix_subj_folder": subj.is_mix,
        }
        self.generate_prompts(example, si)
        return example

    # ----------------------------------------------------------- prompts
    def generate_prompts(self, example: dict, subject_idx: int):
        """The 20 prompt variants (`generate_prompts:538-618`)."""
        subj = self.subjects[subject_idx]
        subject_string = self.subject_string
        cls_delta = subj.cls_delta_string
        if self.num_vectors > 1:
            subject_string = subject_string + ", " * (self.num_vectors - 1)
            cls_delta = cls_delta + ", " * (self.num_vectors - 1)

        compos, mods = sample_compositions(1, "animal" if subj.is_face else "object",
                                           rng=self.rng)
        compos_partial, modifier = compos[0], mods[0]
        mod_compos = modifier + ", " + compos_partial

        base = random.Random(self.rng.randint(1 << 30)).choice(BASE_TEMPLATES)
        n_extra = len(base.split()) - len(FP_TEMPLATE.split())
        fp_tmpl = ", " * n_extra + FP_TEMPLATE
        p_tmpl = ", " * n_extra + P_TEMPLATE

        e = example
        e["subject_name"] = subj.name
        e["subj_single_prompt"] = base.format(subject_string)
        e["subj_comp_prompt"] = base.format(subject_string) + ", " + compos_partial
        e["cls_single_prompt"] = base.format(cls_delta)
        e["cls_comp_prompt"] = base.format(cls_delta) + ", " + compos_partial
        for tag, tmpl in (("fp", fp_tmpl), ("p", p_tmpl)):
            e[f"subj_single_prompt_{tag}"] = tmpl.format(subject_string)
            e[f"subj_comp_prompt_{tag}"] = tmpl.format(subject_string) + ", " + compos_partial
            e[f"cls_single_prompt_{tag}"] = tmpl.format(cls_delta)
            e[f"cls_comp_prompt_{tag}"] = tmpl.format(cls_delta) + ", " + compos_partial
        e["subj_single_mod_prompt"] = base.format(subject_string) + ", " + modifier
        e["cls_single_mod_prompt"] = base.format(cls_delta) + ", " + modifier
        e["subj_comp_mod_prompt"] = base.format(subject_string) + ", " + mod_compos
        e["cls_comp_mod_prompt"] = base.format(cls_delta) + ", " + mod_compos
        # modifier-bearing fp/p variants, used by comp-distill and
        # recon-on-pure-noise prompt selection (`generate_prompts:608-617`,
        # consumed by `ddpm.py:999-1046`)
        for tag, tmpl in (("fp", fp_tmpl), ("p", p_tmpl)):
            e[f"subj_single_mod_prompt_{tag}"] = tmpl.format(subject_string) + ", " + modifier
            e[f"cls_single_mod_prompt_{tag}"] = tmpl.format(cls_delta) + ", " + modifier
            e[f"subj_comp_mod_prompt_{tag}"] = tmpl.format(subject_string) + ", " + mod_compos
            e[f"cls_comp_mod_prompt_{tag}"] = tmpl.format(cls_delta) + ", " + mod_compos
        e["compos_partial_prompt"] = compos_partial
        e["mod_compos_partial_prompt"] = mod_compos
        e["prompt_modifier"] = modifier


def augment_numpy(img: np.ndarray, fg_mask: np.ndarray | None, s: int, do_flip: bool,
                  scale: float, dy: int, dx: int):
    """The plain reference of `native.prepare_item` (the JAX package's numpy
    path): the same decisions give the same bits."""
    aug_mask = np.ones((s, s), np.float32)
    if fg_mask is None:
        fg_mask = np.ones((s, s), np.float32)

    if do_flip:
        img = img[:, ::-1]
        fg_mask = fg_mask[:, ::-1]

    if scale < 0.999:
        # floor-convention nearest resize (as ops/resize.py; PIL's
        # NEAREST samples elsewhere)
        ns = max(int(s * scale), 8)
        idx = (np.arange(ns) * s // ns).astype(np.int64)
        small = img[idx][:, idx]
        small_m = fg_mask[idx][:, idx]
        canvas = np.zeros((s, s, 3), img.dtype)
        mcanvas = np.zeros((s, s), np.float32)
        acanvas = np.zeros((s, s), np.float32)
        off = (s - ns) // 2
        canvas[off:off + ns, off:off + ns] = small
        mcanvas[off:off + ns, off:off + ns] = small_m
        acanvas[off:off + ns, off:off + ns] = 1.0
        img, fg_mask, aug_mask = canvas, mcanvas, acanvas

    if dy != 0 or dx != 0:
        img = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
        fg_mask = np.roll(np.roll(fg_mask, dy, axis=0), dx, axis=1)
        aug_mask = np.roll(np.roll(aug_mask, dy, axis=0), dx, axis=1)

    imgf = img.astype(np.float32) / 127.5 - 1.0
    return imgf, fg_mask, aug_mask


class SubjectSampler:
    """Image-count-weighted subject sampling; one subject per batch
    (`SubjectSampler`, `personalized.py:628-673`)."""

    def __init__(
        self,
        dataset: PersonalizedBase,
        batch_size: int,
        num_batches: int,
        skip_non_faces: bool = True,
        seed: int = 0,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_batches = num_batches
        counts = np.asarray(dataset.images_per_subject(), np.float64)
        if skip_non_faces:
            counts = counts * np.asarray(dataset.subjects_are_faces, np.float64)
        assert counts.sum() > 0, "no (face) subjects to sample"
        self.probs = counts / counts.sum()
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.num_batches * self.batch_size

    def __iter__(self):
        for _ in range(self.num_batches):
            si = int(self.rng.choice(len(self.probs), p=self.probs))
            n_img = len(self.ds.subjects[si].image_paths)
            for _ in range(self.batch_size):
                yield (si, int(self.rng.randint(n_img)))


def collate_batch(examples: list[dict]) -> dict:
    """Stack per-item arrays; keep prompt strings as lists."""
    out: dict = {}
    for k in examples[0]:
        vals = [e[k] for e in examples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out
