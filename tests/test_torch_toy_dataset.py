"""`scripts/make_toy_dataset_torch.py` (no PIL) against
`scripts/make_toy_dataset.py` (Pillow, which the sandbox has): both write
to their own temporary folders; the decoded images and masks are equal bit
for bit, the captions and `metainfo.json` equal, and the port's
`PersonalizedBase` reads the twin's folder as it reads the original's.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from adaface_tpu_torch.data.personalized import PersonalizedBase
from adaface_tpu_torch.utils.image import read_image
from tests.test_torch_eval_cli import REPO, jax_script
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, str(REPO / "scripts"))
import make_toy_dataset_torch  # noqa: E402


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("n,size", [(3, 64), (2, 512)])
def test_toy_dataset_equals_jax_script(tmp_path, monkeypatch, n, size):
    ref, out = str(tmp_path / "pil"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["make_toy_dataset.py", ref, "--n", str(n),
                                      "--size", str(size)])
    jax_script("make_toy_dataset").main()
    make_toy_dataset_torch.main([out, "--n", str(n), "--size", str(size)])
    names = _files(ref)
    assert names == _files(out) and len(names) == 2 * 3 * n + 1
    for name in names:
        a, b = os.path.join(ref, name), os.path.join(out, name)
        if name.endswith(".png"):
            want = np.asarray(Image.open(a))
            got = np.asarray(Image.open(b))
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            if name.endswith("_mask.png"):
                assert set(np.unique(got)) == {0, 255}, name
            else:  # the port's own reader sees the same pixels
                np.testing.assert_array_equal(read_image(b), want, err_msg=name)
        elif name.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


def test_personalized_base_reads_the_twins_folder(tmp_path, monkeypatch):
    ref, out = str(tmp_path / "pil"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["make_toy_dataset.py", ref, "--n", "2", "--size", "128"])
    jax_script("make_toy_dataset").main()
    make_toy_dataset_torch.main([out, "--n", "2", "--size", "128"])
    got_ds = PersonalizedBase(out, size=128, seed=0)
    want_ds = PersonalizedBase(ref, size=128, seed=0)
    assert got_ds.subject_names == want_ds.subject_names == ["alice", "bob"]
    assert len(got_ds) == len(want_ds) == 4
    for i in range(len(got_ds)):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "image_path":
                assert os.path.relpath(got[k], out) == os.path.relpath(v, ref)
            elif isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
    assert [s.cls_delta_string for s in got_ds.subjects] == ["woman", "man"]
    item = got_ds[0]
    assert item["image"].shape == (128, 128, 3) and item["fg_mask"].max() == 1
    assert item["caption"] == "a photo of alice"
