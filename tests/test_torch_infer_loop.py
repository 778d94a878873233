"""`scripts/infer_every_n_min_torch.sh`, the periodic evaluation loop: a
stub `python` first on `PATH` records its argv; the twin (copied into a
temporary tree, so its log and its `cd` stay there) runs until the stub
has been called, then is stopped. With two checkpoint directories of
different mtimes it calls `scripts/gen_prompts_and_eval_torch.py` on the
newer one, with the subject range and the extra arguments of the
original; with none it waits. `gen_prompts_and_eval_torch.py` takes those
extra arguments, options included, and hands them to
`txt2img_eval_torch.py` (in the JAX orchestrator they stop argparse).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import pytest

from tests.test_torch_eval_cli import REPO

sys.path.insert(0, str(REPO / "scripts"))
import gen_prompts_and_eval_torch as orchestrator  # noqa: E402

STUB = """#!/bin/bash
printf '%s\\n' "$@" > "{record}.tmp" && mv "{record}.tmp" "{record}"
"""


def run_loop(tmp_path, args, wait_for_call: bool, seconds: float = 30.0):
    """The twin from a copy in tmp_path, the stub `python` on PATH → (the
    stub's argv or None, the loop's stdout)."""
    (tmp_path / "scripts").mkdir(exist_ok=True)
    shutil.copy(REPO / "scripts" / "infer_every_n_min_torch.sh", tmp_path / "scripts")
    (tmp_path / "bin").mkdir(exist_ok=True)
    record = tmp_path / "argv.txt"
    stub = tmp_path / "bin" / "python"
    stub.write_text(STUB.format(record=record))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    proc = subprocess.Popen(["bash", str(tmp_path / "scripts" / "infer_every_n_min_torch.sh"),
                             *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, start_new_session=True)
    deadline = time.monotonic() + (seconds if wait_for_call else 3.0)
    while time.monotonic() < deadline and not record.exists():
        time.sleep(0.05)
    time.sleep(0.2)
    os.killpg(proc.pid, 15)
    out, _ = proc.communicate(timeout=10)
    return (record.read_text().splitlines() if record.exists() else None), out


def make_ckpt(root, name: str, mtime: float) -> str:
    path = root / "logs" / "run" / "checkpoints" / name
    path.mkdir(parents=True)
    (path / "state.pt").write_bytes(b"x")
    os.utime(path, (mtime, mtime))
    return str(path)


def test_loop_evaluates_the_newest_checkpoint(tmp_path):
    now = time.time()
    older = make_ckpt(tmp_path, "embeddings_gs-900", now - 600)  # larger step, older
    newer = make_ckpt(tmp_path, "embeddings_gs-40", now - 60)
    argv, out = run_loop(tmp_path, ["1", "subjects-ood", "0-3"], wait_for_call=True)
    assert argv is not None, out
    assert argv == ["scripts/gen_prompts_and_eval_torch.py", "--subjects_root", "subjects-ood",
                    "--subject_range", "0-3", "--out_root", "samples", "--scores_csv",
                    "samples/scores.csv", "--extra_args", "--adaface_ckpt",
                    "logs/run/checkpoints/embeddings_gs-40", "--guidance_scale", "5"]
    assert os.path.samefile(tmp_path / argv[11], newer) and older != newer
    assert "evaluating logs/run/checkpoints/embeddings_gs-40" in out


def test_loop_waits_without_a_checkpoint(tmp_path):
    argv, out = run_loop(tmp_path, ["1", "subjects", "", str(tmp_path / "none" / "gs-*")],
                         wait_for_call=False)
    assert argv is None
    assert "no checkpoint matches" in out


def test_orchestrator_passes_the_extra_arguments_on(tmp_path, monkeypatch):
    (tmp_path / "subj" / "alice").mkdir(parents=True)
    calls = []
    monkeypatch.setattr(orchestrator.subprocess, "run", lambda cmd, check: calls.append(cmd))
    orchestrator.main(["--subjects_root", str(tmp_path / "subj"), "--scores_csv",
                       str(tmp_path / "scores.csv"), "--extra_args", "--adaface_ckpt",
                       "logs/run/checkpoints/embeddings_gs-40", "--guidance_scale", "5"])
    (cmd,) = calls
    assert cmd[1].endswith("txt2img_eval_torch.py")
    assert cmd[-4:] == ["--adaface_ckpt", "logs/run/checkpoints/embeddings_gs-40",
                        "--guidance_scale", "5"]
    assert cmd[cmd.index("--device") + 1] == "cuda"


@pytest.mark.parametrize("name", ["infer_every_n_min.sh", "infer_every_n_min_torch.sh"])
def test_twin_keeps_the_originals_arguments(name):
    text = (REPO / "scripts" / name).read_text()
    assert 'GLOB=${4:-logs/*/checkpoints/embeddings_gs-*}' in text
    assert "--extra_args --adaface_ckpt \"$CKPT\" --guidance_scale 5" in text
