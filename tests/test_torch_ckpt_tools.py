"""The port's checkpoint tools and host-side training leftovers against the
JAX package, on the CPU.

Each surgery of `adaface_tpu_torch/tools/ckpt_lib.py` against
`adaface_tpu/tools/ckpt_lib.py` on synthetic numpy state dicts (equal to the
bit, as both are numpy); every subcommand of `scripts/ckpt_tool_torch.py` on
temporary files against the JAX library's function on the same arrays;
`scripts/flow_tool_torch.py` on two PNGs already at `--size`;
`export_reference_ckpt` against JAX's on a synthetic "reference root" (a
temporary package defining an `nn.Module`, pickled with `torch.save`, then
dropped from `sys.modules`): both write the same npz files; and the sample
logger's grids against JAX's, read back.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from adaface_tpu.models import clip as jclip
from adaface_tpu.tools import ckpt_lib as jlib
from adaface_tpu_torch.tools import ckpt_lib as tlib
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def state_dict(seed: int, keys=("first_stage_model.enc.w", "first_stage_model.dec.b",
                                "cond_stage_model.tok.w", "model.diffusion_model.in.w",
                                "model.diffusion_model.out.b")) -> dict:
    rs = np.random.RandomState(seed)
    sd = {k: rs.randn(3, 4).astype(np.float32) for k in keys}
    sd["step_count"] = np.array([seed], np.int64)
    return sd


def assert_same(out: dict, ref: dict):
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_replace_subtree_matches_jax():
    base, donor = state_dict(0), state_dict(1)
    for prefix, donor_prefix in (("first_stage_model.", None), ("cond_stage_model.", None),
                                 ("first_stage_model.", "first_stage_model.")):
        assert_same(tlib.replace_subtree(base, donor, prefix, donor_prefix),
                    jlib.replace_subtree(base, donor, prefix, donor_prefix))
    renamed = {k.replace("first_stage_model.", ""): v for k, v in donor.items()}
    assert_same(tlib.replace_subtree(base, renamed, "first_stage_model.", ""),
                jlib.replace_subtree(base, renamed, "first_stage_model.", ""))
    with pytest.raises(KeyError, match="matched the donor"):
        tlib.replace_subtree(base, {}, "first_stage_model.")


def test_average_and_cast_match_jax():
    sds = [state_dict(i) for i in range(3)]
    sds[2]["only_here"] = np.ones(2, np.float32)
    for weights in (None, [0.2, 0.3, 0.5]):
        assert_same(tlib.average_state_dicts(sds, weights), jlib.average_state_dicts(sds, weights))
    assert_same(tlib.cast_fp16(sds[0]), jlib.cast_fp16(sds[0]))
    with pytest.raises(ValueError, match="2 weights for 3"):
        tlib.average_state_dicts(sds, [0.5, 0.5])


def test_model_diff_and_check_weights_match_jax():
    a, b = state_dict(0), state_dict(1)
    a["shape_differs"] = np.zeros((2, 2), np.float32)
    b["shape_differs"] = np.zeros(3, np.float32)
    a["only_a"], b["only_b"] = np.ones(1, np.float32), np.ones(1, np.float32)
    for topk in (3, 20):
        assert tlib.model_diff(a, b, topk) == jlib.model_diff(a, b, topk)
    bad = dict(a, nan=np.array([1.0, np.nan], np.float32), inf=np.array([np.inf], np.float32),
               zero=np.zeros(4, np.float32))
    assert tlib.check_weights(bad) == jlib.check_weights(bad)


@pytest.mark.parametrize("patterns,use_regex", [(["first_stage_model.*"], False),
                                                (["*.w"], False),
                                                ([r"diffusion_model\.(in|out)"], True)])
def test_replace_by_pattern_matches_jax(patterns, use_regex):
    base, donor = state_dict(0), state_dict(1)
    assert_same(tlib.replace_by_pattern(base, donor, patterns, use_regex),
                jlib.replace_by_pattern(base, donor, patterns, use_regex))
    with pytest.raises(KeyError, match="no keys matched"):
        tlib.replace_by_pattern(base, donor, ["nothing*"])


def log_tree(root: pathlib.Path):
    """Three runs: two with periodic checkpoints (directories and single
    files) and samples, one without a checkpoints folder."""
    for run, steps in (("run-a", (500, 1500, 1000, 2000)), ("run-b", (100, 300)),
                       ("skip-c", (7, 9))):
        ckpts = root / run / "checkpoints"
        ckpts.mkdir(parents=True)
        for i, step in enumerate(steps):
            if i % 2:
                (ckpts / f"embeddings_gs-{step}.pt").write_bytes(b"x")
            else:
                (ckpts / f"embeddings_gs-{step}").mkdir()
        (ckpts / "other.txt").write_text("kept")
        (root / run / "samples").mkdir()
    (root / "no-ckpts").mkdir()


def listing(root: pathlib.Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("kw", [dict(pat="run", keep=1), dict(pat=".", skip_pat="skip", keep=2,
                                                             del_samples=True),
                                dict(pat=".", keep=0, mock=True)])
def test_clean_log_folders_matches_jax(tmp_path, kw):
    for side in ("jax", "port"):
        log_tree(tmp_path / side)
    n_j = jlib.clean_log_folders(str(tmp_path / "jax"), **kw)
    n_t = tlib.clean_log_folders(str(tmp_path / "port"), **kw)
    assert n_t == n_j and n_t > 0
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")
    with pytest.raises(ValueError, match="keep"):
        tlib.clean_log_folders(str(tmp_path / "port"), ".", keep=-1)


def run_tool(*argv):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import ckpt_tool_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))
    ckpt_tool_torch.main([str(a) for a in argv])


def test_ckpt_tool_file_subcommands(tmp_path, capsys):
    """repl_vae, repl_text, avg, extract_unet, fp16, diff, check and repl_pat
    on `.safetensors` and `.npz` files, each against the JAX library on the
    same arrays."""
    a, b = state_dict(0), state_dict(1)
    pa, pb = tmp_path / "a.safetensors", tmp_path / "b.npz"
    tlib.save_state_dict(a, str(pa))
    tlib.save_state_dict(b, str(pb))
    out = tmp_path / "out.safetensors"
    for cmd, prefix in (("repl_vae", "first_stage_model."), ("repl_text", "cond_stage_model.")):
        run_tool(cmd, pa, pb, out)
        assert_same(tlib.load_state_dict(str(out)), jlib.replace_subtree(a, b, prefix))
    run_tool("avg", pa, pb, "-o", out, "-w", 0.25, 0.75)
    assert_same(tlib.load_state_dict(str(out)), jlib.average_state_dicts([a, b], [0.25, 0.75]))
    run_tool("extract_unet", pa, tmp_path / "unet.npz")
    assert_same(tlib.load_state_dict(str(tmp_path / "unet.npz")),
                jlib.extract_subtree(a, "model.diffusion_model."))
    run_tool("fp16", pa, out)
    assert_same(tlib.load_state_dict(str(out)), jlib.cast_fp16(a))
    run_tool("repl_pat", pa, pb, out, "-p", "*.w")
    assert_same(tlib.load_state_dict(str(out)), jlib.replace_by_pattern(a, b, ["*.w"]))
    run_tool("repl_pat", pa, pb, out, "-p", r"enc\.w$", "--regex")
    assert_same(tlib.load_state_dict(str(out)),
                jlib.replace_by_pattern(a, b, [r"enc\.w$"], use_regex=True))
    capsys.readouterr()
    run_tool("diff", pa, pb, "--topk", 2)
    rows, _, _ = jlib.model_diff(a, b, 2)
    printed = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in printed] == [k for k, _ in rows]
    run_tool("check", pa)
    assert capsys.readouterr().out.strip() == str(jlib.check_weights(a))


def mkv_sbg_state_dict(seed: int, multipliers=(2, 1)) -> dict:
    """A SubjBasisGenerator's state dict as the port's checkpoints hold it:
    prompt2token_proj's layers under `clip.` with K/V at `multipliers`."""
    rs = np.random.RandomState(seed)
    d = 8
    sd = {"proj.weight": torch.from_numpy(rs.randn(d, d).astype(np.float32))}
    for i, m in enumerate(multipliers):
        for name, rows in (("q", d), ("k", m * d), ("v", m * d)):
            sd[f"clip.layers.{i}.attn.{name}.weight"] = torch.from_numpy(
                rs.randn(rows, d).astype(np.float32))
            sd[f"clip.layers.{i}.attn.{name}.bias"] = torch.from_numpy(
                rs.randn(rows).astype(np.float32))
    return sd


def test_ckpt_tool_sbg_subcommands(tmp_path):
    """extract_sbg and squeeze_mkv on a checkpoint of the port's trainer: the
    squeezed K/V against JAX's `squeeze_mkv` on the same weights ([in, out]),
    a joint encoder's generators each, the manifest's multipliers read from
    the squeezed widths."""
    from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt, save_adaface_ckpt

    sbgs = {"arc2face": mkv_sbg_state_dict(0), "joint": [mkv_sbg_state_dict(1),
                                                         mkv_sbg_state_dict(2)]}
    ckpt = save_adaface_ckpt(str(tmp_path / "ckpt"), 7, sbgs)
    assert json.load(open(os.path.join(ckpt, "manifest.json")))["mkv_multipliers"] == {
        "arc2face": [2, 1], "joint": [[2, 1], [2, 1]]}
    run_tool("extract_sbg", ckpt, tmp_path / "sbg.safetensors")
    flat = tlib.load_state_dict(str(tmp_path / "sbg.safetensors"))
    assert len(flat) == len(sbgs["arc2face"]) + sum(len(s) for s in sbgs["joint"])
    np.testing.assert_array_equal(flat["joint.1.clip.layers.1.attn.k.weight"],
                                  sbgs["joint"][1]["clip.layers.1.attn.k.weight"].numpy())
    run_tool("extract_sbg", ckpt, tmp_path / "one.npz", "--encoder", "arc2face")
    assert sorted(tlib.load_state_dict(str(tmp_path / "one.npz"))) == sorted(
        f"arc2face.{k}" for k in sbgs["arc2face"])

    run_tool("squeeze_mkv", ckpt, tmp_path / "squeezed", "-d", 2, 1)
    state, manifest = load_adaface_ckpt(str(tmp_path / "squeezed"))
    assert manifest["step"] == 7
    assert manifest["mkv_multipliers"] == {"arc2face": [1, 1], "joint": [[1, 1], [1, 1]]}
    out = state["subj_basis_generators"]
    for got, src in ((out["arc2face"], sbgs["arc2face"]), (out["joint"][0], sbgs["joint"][0]),
                     (out["joint"][1], sbgs["joint"][1])):
        layers = [{"attn": {n: {"w": src[f"clip.layers.{i}.attn.{n}.weight"].numpy().T,
                                "b": src[f"clip.layers.{i}.attn.{n}.bias"].numpy()}
                            for n in "qkv"}} for i in range(2)]
        ref = jclip.squeeze_mkv({"layers": layers}, [2, 1])["layers"]
        for i in range(2):
            for n in "qkv":
                np.testing.assert_allclose(got[f"clip.layers.{i}.attn.{n}.weight"].numpy(),
                                           np.asarray(ref[i]["attn"][n]["w"]).T, rtol=1e-6)
                np.testing.assert_allclose(got[f"clip.layers.{i}.attn.{n}.bias"].numpy(),
                                           np.asarray(ref[i]["attn"][n]["b"]), rtol=1e-6)
        torch.testing.assert_close(got["proj.weight"], src["proj.weight"], rtol=0, atol=0)


def test_ckpt_tool_clean(tmp_path, capsys):
    log_tree(tmp_path / "port")
    log_tree(tmp_path / "jax")
    run_tool("clean", tmp_path / "port", "--pat", "run", "--keep", 1, "--del_samples")
    assert capsys.readouterr().out.strip().endswith("deleted 4 checkpoint dirs")
    jlib.clean_log_folders(str(tmp_path / "jax"), "run", keep=1, del_samples=True)
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")


def test_flow_tool(tmp_path):
    """Two 64x64 PNGs (the second the first shifted by 3 pixels) at
    `--size 64`, so no resize applies: with `--weights` a synthetic torch
    GMA checkpoint (`tests/test_torch_gma.py:torch_gma_state_dict`), the
    flow is JAX's `gma_flow` on JAX's conversion of the same checkpoint and
    the same [0, 255] pixels (1e-4 relative L2, as `test_torch_gma.py`), and
    the PNG written is JAX's `flow_to_image` of it. Without `--weights` the
    network is the port's seeded random one."""
    import jax

    from adaface_tpu.models import gma as jgma
    from adaface_tpu_torch.core.params import build
    from adaface_tpu_torch.models import gma as tgma
    from adaface_tpu_torch.utils.image import read_png, write_png
    from tests.test_torch_gma import REL_L2, rel_l2, torch_gma_state_dict

    rs = np.random.RandomState(3)
    img = rs.randint(0, 256, (64, 67, 3)).astype(np.uint8)
    write_png(tmp_path / "a.png", img[:, :64])
    write_png(tmp_path / "b.png", img[:, 3:])
    sd = torch_gma_state_dict()
    torch.save(sd, tmp_path / "gma.pth")
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import flow_tool_torch
    finally:
        sys.path.remove(str(REPO / "scripts"))

    def run(out, *extra):
        return flow_tool_torch.main([str(tmp_path / "a.png"), str(tmp_path / "b.png"), "--out",
                                     str(out), "--iters", "2", "--size", "64", "--device",
                                     "cpu", *extra])

    x = [im.astype(np.float32).transpose(2, 0, 1)[None] for im in (img[:, :64], img[:, 3:])]
    out = tmp_path / "flow.png"
    flow = run(out, "--weights", str(tmp_path / "gma.pth"))
    jtree = jgma.convert_gma_state_dict({k: v.numpy() for k, v in sd.items()})
    ref = np.asarray(jax.jit(lambda p, a, b_: jgma.gma_flow(p, a, b_, num_iters=2))(
        jtree, *x))[0].transpose(1, 2, 0)
    assert flow.shape == (64, 64, 2) and np.isfinite(flow).all()
    assert rel_l2(flow, ref) <= REL_L2
    np.testing.assert_array_equal(read_png(out), jgma.flow_to_image(flow))

    flow = run(tmp_path / "random.png")
    gma = build(tgma.GMA, "cpu", torch.float32, tgma.init_gma_weights_,
                torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = tgma.gma_flow(gma, *map(torch.from_numpy, x), num_iters=2)
    np.testing.assert_array_equal(flow, ref[0].permute(1, 2, 0).numpy())


REFERENCE_MODULE = '''
import torch
from torch import nn


class SubjBasisGenerator(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.proj = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d)
        self.register_buffer("scale", torch.full((d,), 0.5))
'''


def test_export_reference_ckpt_matches_jax(tmp_path):
    """A pickle of live modules from a package of a reference root: both
    packages' exports write the same npz files and info."""
    from adaface_tpu.train.checkpoint import export_reference_ckpt as jexport
    from adaface_tpu_torch.train.checkpoint import export_reference_ckpt

    root = tmp_path / "reference"
    (root / "refpkg").mkdir(parents=True)
    (root / "refpkg" / "__init__.py").write_text("")
    (root / "refpkg" / "modules.py").write_text(REFERENCE_MODULE)
    sys.path.insert(0, str(root))
    try:
        from refpkg.modules import SubjBasisGenerator

        gen = torch.Generator().manual_seed(5)
        sbgs = {}
        for key in ("z", "y"):
            m = SubjBasisGenerator(6)
            for p in m.parameters():
                p.data.copy_(torch.randn(p.shape, generator=gen))
            sbgs[key] = m
        lora = {"attn.22.q.lora_a": torch.randn(4, 6, generator=gen),
                "attn.22.q.magnitude": torch.randn(6, generator=gen).double()}
        pt = tmp_path / "embeddings_gs-500.pt"
        torch.save({"string_to_subj_basis_generator_dict": sbgs, "unet_lora_modules": lora}, pt)
    finally:
        sys.path.remove(str(root))
        for name in [n for n in sys.modules if n.split(".")[0] == "refpkg"]:
            del sys.modules[name]
    info_t = export_reference_ckpt(str(pt), str(tmp_path / "port"), str(root))
    info_j = jexport(str(pt), str(tmp_path / "jax"), reference_root=str(root))
    assert info_t == info_j == {"sbg_z": 5, "sbg_y": 5, "unet_lora": 2}
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith(".json"):
            assert (json.load(open(tmp_path / "port" / name))
                    == json.load(open(tmp_path / "jax" / name)))
            continue
        with np.load(tmp_path / "port" / name) as t, np.load(tmp_path / "jax" / name) as j:
            assert_same({k: t[k] for k in t.files}, {k: j[k] for k in j.files})
    assert str(root) not in sys.path  # the root was on it only while unpickling
    for name in [n for n in sys.modules if n.split(".")[0] == "refpkg"]:
        del sys.modules[name]


def test_sample_logger_matches_jax(tmp_path):
    """Grids of three iteration types (one unknown: grey), queued and written
    by the worker thread, read back equal to JAX's (PIL) pixels; a full
    queue drops."""
    from PIL import Image

    from adaface_tpu.utils.sample_logger import SampleLogger as JLogger
    from adaface_tpu_torch.utils.image import read_png
    from adaface_tpu_torch.utils.sample_logger import SampleLogger

    rs = np.random.RandomState(6)
    batches = [(10, "recon", rs.rand(3, 3, 8, 12).astype(np.float32) * 1.2 - 0.1),
               (20, "comp_distill", rs.rand(5, 3, 8, 8).astype(np.float32)),
               (30, "mystery", rs.rand(1, 3, 4, 4).astype(np.float32))]
    loggers = SampleLogger(str(tmp_path / "port")), JLogger(str(tmp_path / "jax"))
    for step, kind, images in batches:
        assert loggers[0].log(step, kind, torch.from_numpy(images))
        assert loggers[1].log(step, kind, images)
    for lg in loggers:
        lg.close()
    names = sorted(os.listdir(tmp_path / "jax" / "samples"))
    assert names == sorted(os.listdir(tmp_path / "port" / "samples")) and len(names) == 3
    for name in names:
        want = np.asarray(Image.open(tmp_path / "jax" / "samples" / name).convert("RGB"))
        np.testing.assert_array_equal(read_png(tmp_path / "port" / "samples" / name), want)
    full = SampleLogger(str(tmp_path / "full"), max_queue=1)
    full.close()  # the worker has stopped: what is queued stays queued
    assert full.log(1, "sample", np.zeros((1, 3, 2, 2)))
    assert not full.log(2, "sample", np.zeros((1, 3, 2, 2))) and full.dropped == 1
