"""The port's evaluation harness (`adaface_tpu_torch/evaluation/`) against
the JAX package's on the CPU in fp32: the prompt sets; range, subject-table
and prompt-list parsing on `tests/test_evaluation.py`'s cases; the CLIP
and DINO evaluators at that file's tiny configs on trees carried over from
JAX (every leaf drawn), features and scores within 1e-5; `dino_preprocess`;
face similarity with the hash backend; folder comparisons and their CSV
rows; and the refusal of an unnamed face backend."""

import csv

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from adaface_tpu.evaluation import clip_eval as jclip_eval
from adaface_tpu.evaluation import dino_eval as jdino_eval
from adaface_tpu.evaluation import eval_utils as jeval_utils
from adaface_tpu.evaluation import face_sim as jface_sim
from adaface_tpu.evaluation import prompt_sets as jprompt_sets
from adaface_tpu.id2ada.face_backends import DeterministicBackend as JBackend
from adaface_tpu.models import clip as jclip
from adaface_tpu.models import vit as jvit
from adaface_tpu.text.tokenizer import CLIPTokenizer as JTokenizer
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.evaluation import clip_eval, dino_eval, eval_utils, face_sim, prompt_sets
from adaface_tpu_torch.id2ada.face_backends import DeterministicBackend
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import vit as tvit
from adaface_tpu_torch.text.tokenizer import CLIPTokenizer
from adaface_tpu_torch.utils.image import resize_cubic, write_png
from tests.test_evaluation import TINY_TEXT, TINY_VISION, TINY_VIT
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def port_cfg(cls, jcfg):
    """The port's config of `cls` with the JAX config's values."""
    return cls(**{k: getattr(jcfg, k) for k in cls.__dataclass_fields__ if hasattr(jcfg, k)})


def port_vit(tree):
    """The port's ViT at TINY_VIT loaded from a JAX tree."""
    return bridge.load(tvit.ViT(port_cfg(tvit.ViTConfig, TINY_VIT)),
                       bridge.vit_tree(jax.tree_util.tree_map(np.asarray, tree)))


def imgs(n, seed=0, hw=224):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 255, (hw, hw, 3), np.uint8) for _ in range(n)]


def test_prompt_sets_equal_jax():
    assert prompt_sets.PROMPT_SETS == jprompt_sets.PROMPT_SETS
    for name in ("DREAMBENCH_PROMPTS", "COMMUNITY_PROMPTS", "FREEU_PROMPTS"):
        assert getattr(prompt_sets, name) == getattr(jprompt_sets, name)


def test_parsers_equal_jax(tmp_path):
    for s in ("1,3-5,8", None, "", "0-4,7", " 2 , 9-10"):
        assert eval_utils.parse_range_str(s) == jeval_utils.parse_range_str(s)
    args = ("z", "person", ["a photo of {}", "{} at night"])
    assert eval_utils.format_prompt_list(*args) == jeval_utils.format_prompt_list(*args)
    assert eval_utils.format_prompt_list(*args) == (["a photo of z", "z at night"],
                                                    ["a photo of person", "person at night"])
    p = tmp_path / "info-subjects.sh"
    p.write_text("#!/usr/bin/fish\n"
                 "set -g subjects  alice    bob\n"
                 "set -g subj_types woman   man\n"
                 "set -g cls_delta_strings $subj_types\n"
                 "set -g data_folder subjects-celebrity\n")
    assert eval_utils.parse_subject_file(str(p)) == jeval_utils.parse_subject_file(str(p))
    bad = tmp_path / "bad.sh"
    bad.write_text("set -g subjects a b\nset -g subj_types man\n")
    for parse in (eval_utils.parse_subject_file, jeval_utils.parse_subject_file):
        with pytest.raises(ValueError, match="subj_types has 1 values for 2 subjects"):
            parse(str(bad))


@pytest.fixture(scope="module")
def clip_pair():
    """A JAX and a port CLIP evaluator on one set of drawn trees."""
    text = numpy_params(lambda k: jclip.init_text_params(k, TINY_TEXT), 21)
    vision = numpy_params(lambda k: jclip.init_vision_params(k, TINY_VISION), 22)
    proj = np.random.RandomState(23).randn(TINY_TEXT.hidden_size, 32).astype(np.float32) / 8
    jev = jclip_eval.CLIPEvaluator(text_params=text, vision_params=vision, text_cfg=TINY_TEXT,
                                   vision_cfg=TINY_VISION, text_projection=proj,
                                   tokenizer=JTokenizer.character_fallback())
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tev = clip_eval.CLIPEvaluator(
        "cpu", text=bridge.load(tclip.CLIPTextModel(port_cfg(
            tclip.CLIPTextConfig, TINY_TEXT)), as_np(text)),
        vision=bridge.load(tclip.CLIPVisionModel(port_cfg(
            tclip.CLIPVisionConfig, TINY_VISION)), as_np(vision)),
        text_projection=proj, tokenizer=CLIPTokenizer.character_fallback())
    return jev, tev


def test_clip_evaluator_matches_jax(clip_pair):
    jev, tev = clip_pair
    a, b = imgs(2, 0), imgs(3, 1)
    prompts = ["a photo of a person", "a person in the snow"]
    np.testing.assert_allclose(tev.text_features(prompts).numpy(),
                               np.asarray(jev.text_features(prompts)), atol=TOL)
    np.testing.assert_allclose(tev.image_features(a).numpy(), np.asarray(jev.image_features(a)),
                               atol=TOL)
    assert abs(tev.txt_to_img_similarity(prompts, a) - jev.txt_to_img_similarity(prompts, a)) <= TOL
    assert abs(tev.img_to_img_similarity(a, b) - jev.img_to_img_similarity(a, b)) <= TOL
    assert tev.img_to_img_similarity(a, a) > tev.img_to_img_similarity(a, b)


def test_clip_evaluator_random_init_and_to():
    """Random towers at the JAX scales from an explicit generator (the same
    seed, the same scores), and `to` keeps the weights."""
    cfg = dict(text_cfg=port_cfg(tclip.CLIPTextConfig, TINY_TEXT),
               vision_cfg=port_cfg(tclip.CLIPVisionConfig, TINY_VISION))
    e1 = clip_eval.CLIPEvaluator("cpu", torch.Generator().manual_seed(5), **cfg)
    e2 = clip_eval.CLIPEvaluator("cpu", torch.Generator().manual_seed(5), **cfg)
    a, b = imgs(2, 0, 64), imgs(2, 1, 64)
    assert e1.img_to_img_similarity(a, b) == e2.img_to_img_similarity(a, b)
    assert e1.to("cpu").txt_to_img_similarity(["x"], a) == e1.txt_to_img_similarity(["x"], a)
    assert e1.text_projection.shape == (TINY_TEXT.hidden_size, TINY_VISION.projection_dim)
    assert abs(e1.text_projection.std().item() * TINY_TEXT.hidden_size ** 0.5 - 1) < 0.1


def test_dino_evaluator_matches_jax():
    tree = numpy_params(lambda k: jvit.init_vit_params(k, TINY_VIT), 31)
    jev = jdino_eval.DINOEvaluator(params=tree, cfg=TINY_VIT)
    tev = dino_eval.DINOEvaluator("cpu", model=port_vit(tree))
    a, b = imgs(2, 0), imgs(3, 5)
    np.testing.assert_allclose(tev.image_features(a).numpy(), np.asarray(jev.image_features(a)),
                               atol=TOL)
    assert abs(tev.img_to_img_similarity(a, b) - jev.img_to_img_similarity(a, b)) <= TOL
    assert tev.to("cpu").img_to_img_similarity(a, b) == tev.img_to_img_similarity(a, b)


def test_dino_preprocess_equals_jax(monkeypatch):
    """The normalisation and layout equal JAX's bit for bit (JAX's
    `cv2.resize` given the port's bicubic); against OpenCV's own bicubic the
    pixels differ by at most one level at a few positions
    (`utils.image.resize_cubic`: OpenCV's vector pass rounds some sums the
    other way)."""
    import cv2

    images = imgs(2, 0, 64) + imgs(1, 2, 97)
    real = jdino_eval.dino_preprocess(images)
    got = dino_eval.dino_preprocess(images)
    level = 1 / 255 / jdino_eval.IMAGENET_STD.min()
    diff = np.abs(got - real)
    assert diff.max() <= level * 1.0001 and (diff > 1e-6).mean() <= 1e-4
    monkeypatch.setattr(cv2, "resize", lambda im, size, interpolation: resize_cubic(im, size))
    np.testing.assert_array_equal(got, jdino_eval.dino_preprocess(images))


def test_face_similarity_equals_jax():
    a, b = imgs(3, 0, 64), imgs(2, 9, 64)
    ea = face_sim.embed_images(a, DeterministicBackend())
    np.testing.assert_array_equal(ea, jface_sim.embed_images(a, JBackend()))
    got = face_sim.compare_face_images(a, b, DeterministicBackend(always_detect=False))
    want = jface_sim.compare_face_images(a, b, JBackend(always_detect=False))
    assert got == want
    black = [np.zeros((8, 8, 3), np.uint8)]
    assert face_sim.embed_images(black, DeterministicBackend(False)).shape == (0, 512)
    assert np.isnan(face_sim.compare_face_images(black, a, DeterministicBackend(False))[
        "face_sim"])


def test_unnamed_backend_raises():
    """JAX's `default_backend()` falls back to hashing bytes where
    insightface is missing; the port names the backends instead."""
    with pytest.raises(ValueError, match="retinaface_arcface.*deterministic"):
        face_sim.embed_images(imgs(1), None)
    with pytest.raises(ValueError, match="a face backend is required"):
        face_sim.compare_face_images(imgs(1), imgs(1), None)
    with pytest.raises(ValueError, match="insightface"):
        face_sim.make_face_backend("insightface", "cpu")
    assert isinstance(face_sim.make_face_backend("deterministic"), DeterministicBackend)
    be = face_sim.make_face_backend("retinaface_arcface", "cpu", torch.Generator().manual_seed(0))
    assert next(be.arc.arcface.parameters()).device.type == "cpu"


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_compare_folders_and_csv_equal_jax(tmp_path, clip_pair):
    """The same PNG folders (written by PIL) scored by both harnesses give
    the same CSV: the same header and rows, the numbers within 1e-5."""
    jclip_ev, tclip_ev = clip_pair
    tree = numpy_params(lambda k: jvit.init_vit_params(k, TINY_VIT), 32)
    jdino = jdino_eval.DINOEvaluator(params=tree, cfg=TINY_VIT)
    tdino = dino_eval.DINOEvaluator("cpu", model=port_vit(tree))
    d1, d2 = tmp_path / "samples", tmp_path / "gt"
    d1.mkdir(), d2.mkdir()
    for i, im in enumerate(imgs(2, 0)):
        Image.fromarray(im).save(d1 / f"{i}.png")
    for i, im in enumerate(imgs(2, 1)):
        write_png(d2 / f"{i}.png", im)
    (d2 / "notes.txt").write_text("not an image")
    rows = {}
    for side, mod, cev, dev, be in (("jax", jeval_utils, jclip_ev, jdino, JBackend()),
                                    ("port", eval_utils, tclip_ev, tdino, DeterministicBackend())):
        scores = mod.compare_folders(str(d1), str(d2), prompt="a photo", clip_evaluator=cev,
                                     dino_evaluator=dev)
        scores.update(mod.compare_face_folders(str(d1), str(d2), be))
        path = tmp_path / f"{side}.csv"
        for subject in ("alice", "bob"):
            mod.append_score_row(str(path), {"subject": subject, **scores})
        rows[side] = read_csv(path)
    assert [list(r) for r in rows["port"]] == [list(r) for r in rows["jax"]]
    assert list(rows["port"][0]) == ["subject", "n_samples", "n_gt", "clip_t", "clip_i", "dino",
                                     "face_sim", "n_faces_a", "n_faces_b"]
    for got, want in zip(rows["port"], rows["jax"]):
        for k in want:
            if k == "subject" or k.startswith("n_"):
                assert got[k] == want[k], k
            else:
                assert abs(float(got[k]) - float(want[k])) <= TOL, k
