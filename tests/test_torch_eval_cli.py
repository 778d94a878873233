"""The evaluation and face-tool twins (`scripts/*_torch.py`) end to end on
the CPU at tiny sizes (`--device cpu`), and against the JAX scripts where
those run on the CPU on the same inputs and parameters: the face masks of
`gen_face_masks` and the makeup output bit for bit (one synthetic BiSeNet
checkpoint in the reference's layout for both, 64² parsing),
`gen_prompts_and_eval --list_only`'s listing and CSV skeleton, the face
tools' reports (the JAX scripts' `default_backend()` is the hash backend
without insightface, the port's `--face_backend deterministic`), and the face parser's
overlays and mIoU. `txt2img_eval_torch.py` runs on the tiny towers of
`tests/test_torch_cli.py` with tiny evaluators."""

import csv
import importlib.util
import pathlib
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from adaface_tpu.models import bisenet as jbisenet
from adaface_tpu_torch.models import clip as tclip
from adaface_tpu_torch.models import vit as tvit
from adaface_tpu_torch.utils import image as timage
from tests import torch_sd_layout as layout
from tests.test_evaluation import TINY_TEXT, TINY_VISION, TINY_VIT
from tests.test_torch_cli import cli  # noqa: F401 (fixture)
from tests.test_torch_evaluation import port_cfg
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
PARSE = 64  # the parsing size: argmax ties between the two fp32 sides stay away at 64²


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, name: str, argv: list[str]):
    mod = jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod.main()


@pytest.fixture()
def scripts(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO / "scripts"))


@pytest.fixture(scope="module")
def bisenet_ckpt(tmp_path_factory) -> str:
    """A BiSeNet checkpoint in the reference's layout, every leaf drawn,
    the running variances positive."""
    def leaf(path, a):
        a = np.asarray(a)
        return 1.0 + np.abs(a) * 5 if str(path[-1].key) == "var" else a

    tree = jax.tree_util.tree_map_with_path(leaf, numpy_params(jbisenet.init_bisenet_params, 41))
    path = str(tmp_path_factory.mktemp("bisenet") / "79999_iter.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in layout.bisenet_to_torch(
        tree).items()}, path)
    return path


def photos(folder: pathlib.Path, sizes=((70, 90), (64, 64), (100, 52))) -> list[str]:
    """RGB photos as JPEG and PNG (PIL writes them; both sides read them)."""
    folder.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(len(str(folder)))
    names = []
    for i, (h, w) in enumerate(sizes):
        img = Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        name = f"face{i}.{'jpg' if i % 2 == 0 else 'png'}"
        img.save(folder / name, quality=90) if name.endswith("jpg") else img.save(folder / name)
        names.append(name)
    return names


def test_gen_face_masks_equal_jax(scripts, monkeypatch, tmp_path, bisenet_ckpt):
    """Every mask equal to the JAX script's (BICUBIC in, NEAREST back); then
    the trash rule at a threshold between the photos' face fractions: the
    same photos moved, the same masks written."""
    import gen_face_masks_torch

    names = photos(tmp_path / "a")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    common = ["--bisenet_ckpt", bisenet_ckpt, "--size", str(PARSE)]
    got = gen_face_masks_torch.main(["--in_dir", str(tmp_path / "a"), "--device", "cpu",
                                     "--min_face_frac", "0", *common])
    run_jax(monkeypatch, "gen_face_masks", ["--in_dir", str(tmp_path / "b"),
                                            "--min_face_frac", "0", *common])
    assert len(got["masks"]) == len(names)
    for name in names:
        mask = tmp_path / "a" / (name.rsplit(".", 1)[0] + "_mask.png")
        a = timage.read_png(mask)
        b = np.asarray(Image.open(tmp_path / "b" / mask.name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.shape == np.asarray(Image.open(tmp_path / "a" / name)).shape[:2]
        assert set(np.unique(a)) <= {0, 255}

    fracs = sorted(got["face_frac"].values())
    assert len(set(fracs)) > 1, fracs
    thres = str((fracs[0] + fracs[1]) / 2)
    for d in ("c", "d"):
        shutil.copytree(tmp_path / "a", tmp_path / d, ignore=shutil.ignore_patterns("*_mask.png"))
    trashed = gen_face_masks_torch.main(["--in_dir", str(tmp_path / "c"), "--device", "cpu",
                                         "--min_face_frac", thres, "--trash_dir",
                                         str(tmp_path / "c_trash"), *common])
    run_jax(monkeypatch, "gen_face_masks", ["--in_dir", str(tmp_path / "d"), "--min_face_frac",
                                            thres, "--trash_dir", str(tmp_path / "d_trash"),
                                            *common])
    assert len(trashed["filtered"]) == 1
    for sub in ("", "_trash"):
        assert sorted(p.name for p in (tmp_path / f"c{sub}").iterdir()) == \
            sorted(p.name for p in (tmp_path / f"d{sub}").iterdir())


def test_makeup_demo_equals_jax(scripts, monkeypatch, tmp_path, bisenet_ckpt):
    """LANCZOS in, parsing from a label PNG (NEAREST) or from BiSeNet:
    the same PNG as the JAX script's; pixels off the recoloured parts are
    the resized photo's."""
    import makeup_demo_torch

    photos(tmp_path, sizes=((90, 70),))
    image = str(tmp_path / "face0.jpg")
    rs = np.random.RandomState(5)
    labels = rs.randint(0, 19, (40, 50)).astype(np.uint8)
    labels[:10] = 17
    Image.fromarray(labels).save(tmp_path / "parsing.png")
    for extra in (["--parsing", str(tmp_path / "parsing.png"), "--upper_lip", "230,50,20",
                   "--hair", "10,20,250"],
                  ["--bisenet_ckpt", bisenet_ckpt]):
        argv = ["--image", image, "--size", str(PARSE), *extra]
        got = makeup_demo_torch.main(argv + ["--out", str(tmp_path / "port.png"),
                                             "--device", "cpu"])
        run_jax(monkeypatch, "makeup_demo", argv + ["--out", str(tmp_path / "jax.png")])
        want = np.asarray(Image.open(tmp_path / "jax.png"))
        np.testing.assert_array_equal(timage.read_png(tmp_path / "port.png"), want)
        np.testing.assert_array_equal(got, want)
    resized = np.asarray(Image.open(image).convert("RGB").resize((PARSE, PARSE), Image.LANCZOS))
    parsing = np.asarray(Image.fromarray(labels).resize((PARSE, PARSE), Image.NEAREST))
    got = makeup_demo_torch.main(["--image", image, "--size", str(PARSE), "--parsing",
                                  str(tmp_path / "parsing.png"), "--out",
                                  str(tmp_path / "p.png"), "--device", "cpu"])
    np.testing.assert_array_equal(got[parsing != 17], resized[parsing != 17])


def test_face_parsing_train_eval_equal_jax(scripts, monkeypatch, tmp_path, bisenet_ckpt, capsys):
    """`train_face_parsing_torch.py` saves a state dict that
    `eval_face_parsing_torch.py` reads; with the reference-layout checkpoint
    the overlays and the mIoU equal the JAX script's."""
    import eval_face_parsing_torch
    import train_face_parsing_torch

    root = tmp_path / "celeba"
    names = photos(root / "images", sizes=((64, 64), (80, 72), (64, 96)))
    (root / "labels").mkdir()
    rs = np.random.RandomState(9)
    for name in names:
        h, w = np.asarray(Image.open(root / "images" / name)).shape[:2]
        Image.fromarray(rs.randint(0, 19, (h, w)).astype(np.uint8)).save(
            root / "labels" / (name.rsplit(".", 1)[0] + ".png"))
    ckpt = str(tmp_path / "trained.pt")
    train_face_parsing_torch.main(["--data_root", str(root), "--max_iter", "1", "--batch_size",
                                   "2", "--crop_size", "64", "--out", ckpt, "--log_every", "1",
                                   "--device", "cpu"])
    trained = eval_face_parsing_torch.main(["--bisenet_ckpt", ckpt, "--dataset_root", str(root),
                                            "--size", str(PARSE), "--device", "cpu",
                                            "--batch_size", "2"])
    assert 0.0 <= trained["metrics"]["miou"] <= 1.0

    argv = ["--bisenet_ckpt", bisenet_ckpt, "--size", str(PARSE), "--in_dir",
            str(root / "images"), "--dataset_root", str(root), "--batch_size", "2"]
    capsys.readouterr()
    got = eval_face_parsing_torch.main(argv + ["--out_dir", str(tmp_path / "port"),
                                               "--device", "cpu"])
    port_out = capsys.readouterr().out
    run_jax(monkeypatch, "eval_face_parsing", argv + ["--out_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    miou = [line for line in port_out.splitlines() if line.startswith(("mIoU", "per-class"))]
    assert miou and miou == [line for line in jax_out.splitlines()
                             if line.startswith(("mIoU", "per-class"))]
    assert len(got["overlays"]) == len(names)
    for name in names:
        stem = name.rsplit(".", 1)[0]
        a = timage.read_png(tmp_path / "port" / f"{stem}.png")
        if name.endswith(".png"):  # JAX writes the overlay in the image's own format
            np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "jax" / name)))


def test_face_tools_equal_jax(scripts, monkeypatch, tmp_path, capsys):
    """Each subcommand's report equals the JAX script's with the hash
    backend, on a folder with a near-duplicate (a byte-equal copy)."""
    import face_tool_torch
    import filter_faces_torch

    names = photos(tmp_path / "a")
    shutil.copy(tmp_path / "a" / names[1], tmp_path / "a" / "dup.png")
    photos(tmp_path / "b", sizes=((50, 50), (60, 40)))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    port = ["--device", "cpu", "--face_backend", "deterministic"]
    cases = [("face_tool", face_tool_torch, ["knn", a, "-k", "2"]),
             ("face_tool", face_tool_torch, ["compare", a, b]),
             ("face_tool", face_tool_torch, ["det", a]),
             ("filter_faces", filter_faces_torch, ["dedup", "--in_dir", a, "--thres", "0.9"]),
             ("filter_faces", filter_faces_torch, ["filter", "--in_dir", a]),
             ("filter_faces", filter_faces_torch, ["knn", "--in_dir", a, "--query",
                                                   str(tmp_path / "b" / "face0.jpg"), "-k", "3"])]
    for name, mod, argv in cases:
        capsys.readouterr()
        mod.main(port + argv)
        got = capsys.readouterr().out
        run_jax(monkeypatch, name, argv)
        assert got == capsys.readouterr().out, argv
    # the later in sorted order of the byte-equal pair
    assert face_tool_torch.main(port + ["knn", a, "-k", "2", "--dedup_thres", "0.99"])["dups"] \
        == [str(tmp_path / "a" / names[1])]
    scores = filter_faces_torch.main(port + ["compare", "--a", a, "--b", b])
    assert scores["n_faces_a"] == 4 and scores["n_faces_b"] == 2
    report = face_tool_torch.main(["--device", "cpu", "det", b])  # RetinaFace + ArcFace
    assert report["images"] == 2


def test_gen_prompts_list_only_equals_jax(scripts, monkeypatch, tmp_path, capsys):
    """`--list_only` on a subject table and on a folder of subjects: the
    same listing and the same CSV skeleton as the JAX script."""
    import gen_prompts_and_eval_torch

    root = tmp_path / "subjects"
    photos(root / "alice")
    photos(root / "bob", sizes=((40, 40),))
    (root / "bob" / "x_mask.png").write_bytes(b"")
    table = tmp_path / "info-subjects.sh"
    table.write_text("set -g subjects alice bob\nset -g subj_types woman man\n"
                     f"set -g data_folder {root}\n")
    listings = []
    for argv in (["--subject_file", str(table)], ["--subjects_root", str(root)],
                 ["--subjects_root", str(root), "--subject_range", "1"]):
        outs, skeletons = [], []
        for side in ("port", "jax"):
            csv_path = tmp_path / f"{side}.csv"
            csv_path.unlink(missing_ok=True)
            full = argv + ["--list_only", "--scores_csv", str(csv_path)]
            if side == "port":
                gen_prompts_and_eval_torch.main(full)
            else:
                run_jax(monkeypatch, "gen_prompts_and_eval", full)
            outs.append(capsys.readouterr().out.replace(str(csv_path), "CSV"))
            skeletons.append(csv_path.read_text())
        assert outs[0] == outs[1], argv
        assert skeletons[0] == skeletons[1]
        listings.append(outs[0])
    assert "alice\twoman\t3 images\nbob\tman\t1 images\n" in listings[0]
    assert "alice\t?\t3 images" in listings[1] and "alice" not in listings[2]
    with pytest.raises(SystemExit, match="missing subject folders"):
        gen_prompts_and_eval_torch.main(["--subject_file", str(table), "--subjects_root",
                                         str(tmp_path), "--list_only", "--scores_csv",
                                         str(tmp_path / "m.csv")])
    with open(tmp_path / "avg.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerows([["subject", "clip_t", "dino"], ["a", "0.5", "0.25"], ["b", "0.25", "x"]])
    assert gen_prompts_and_eval_torch.averages(str(tmp_path / "avg.csv")) == {
        "clip_t": (0.375, 2), "dino": (0.25, 1)}


def test_txt2img_eval_writes_scores(cli, monkeypatch, tmp_path):  # noqa: F811
    """Two prompts × 2 samples at 64² in 2 steps on the tiny towers, then
    CLIP-T / CLIP-I / DINO against the subject and face similarity, one CSV
    row a prompt; the inference YAML through the port's reader; prompt i's
    images drawn from a generator seeded `seed` + i."""
    import txt2img_eval_torch

    common, subject = cli
    monkeypatch.setattr(txt2img_eval_torch, "CLIP_KW", dict(
        text_cfg=port_cfg(tclip.CLIPTextConfig, TINY_TEXT),
        vision_cfg=port_cfg(tclip.CLIPVisionConfig, TINY_VISION)))
    monkeypatch.setattr(txt2img_eval_torch, "DINO_KW", dict(cfg=port_cfg(tvit.ViTConfig,
                                                                          TINY_VIT)))
    config = tmp_path / "inference.yaml"
    config.write_text("pipeline:\n  num_inference_steps: 2\n  guidance_scale: 4.0\n"
                      "  guidance_scale_min: null\n  image_size: 64\nmodel:\n"
                      "  id2ada_encoder: arc2face\n")
    csv_path = tmp_path / "scores.csv"
    argv = ["--subject", subject, "--device", "cpu", "--dtype", "f32", "--config", str(config),
            "--n_samples", "2", "--prompt_range", "0,3", "--out_dir", str(tmp_path / "out"),
            "--compare_with", subject, "--calc_face_sim", "--face_backend", "deterministic",
            "--scores_csv", str(csv_path), "--class_token", "woman"]
    args = txt2img_eval_torch.parse_args(argv)
    assert (args.num_inference_steps, args.guidance_scale, args.size) == (2, 4.0, 64)
    rows = txt2img_eval_torch.main(argv)
    with open(csv_path) as f:
        got = list(csv.DictReader(f))
    assert [r["prompt"] for r in got] == ["a photo of woman in the jungle",
                                          "a photo of woman on a cobblestone street"]
    for r in got:
        assert r["n_samples"] == "2" and r["n_gt"] == "2" and r["n_faces_a"] == "2"
        for k in ("clip_t", "clip_i", "dino", "face_sim"):
            assert -1.0 <= float(r[k]) <= 1.0, k
    assert [r["dir"] for r in rows] == [str(tmp_path / "out" / "p00"),
                                        str(tmp_path / "out" / "p01")]
    a = [timage.read_png(p) for p in sorted((tmp_path / "out" / "p00").iterdir())]
    assert len(a) == 2 and a[0].shape == (64, 64, 3)
    # prompt 1 again from seed 1 alone: the same pixels
    w = common.build_wrapper(args, "text2img")
    w.prepare_adaface_embeddings(images=common.load_subject_images(subject))
    again = txt2img_eval_torch.generate(w, txt2img_eval_torch.select_prompts(
        "dreambench", "3"), str(tmp_path / "again"), 2, 64, 1, 2)
    np.testing.assert_array_equal(timage.read_png(pathlib.Path(again[0][0]) / "sample_000.png"),
                                  timage.read_png(tmp_path / "out" / "p01" / "sample_000.png"))
