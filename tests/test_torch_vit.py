"""The port's ViT (`adaface_tpu_torch/models/vit.py`) against the JAX
package's `vit_encode` on the CPU in fp32: a tiny ViT (2 layers, width 64,
patch 32) and one at DINO ViT-S/16's width with 2 layers, on trees whose
every leaf is drawn (`numpy_params`: biases and norms off their start),
carried over by `core.bridge.vit_tree` + `load`; the class token and the
patch tokens to 1e-5 relative L2. `convert_dino_state_dict` on a synthetic
facebookresearch/dino state dict, equal leaf for leaf on both sides."""

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.models import vit as jvit
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import vit as tvit
from tests.test_torch_models import numpy_params, one_torch_thread  # noqa: F401 (autouse)

REL_L2 = 1e-5
CASES = {"tiny": dict(hidden_size=64, num_layers=2, num_heads=2, patch_size=32),
         "dino width": dict(num_layers=2)}


def rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vit_matches_jax(case):
    kw = CASES[case]
    cfg_j, cfg_t = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    params = numpy_params(lambda k: jvit.init_vit_params(k, cfg_j), 7)
    model = bridge.load(tvit.ViT(cfg_t), bridge.vit_tree(jax.tree_util.tree_map(np.asarray,
                                                                                 params)))
    px = np.random.RandomState(3).randn(2, 3, 224, 224).astype(np.float32)
    ref = jax.jit(lambda p, x: jvit.vit_encode(p, x, cfg_j))(params, px)
    with torch.inference_mode():
        out = model(torch.from_numpy(px))
    for key in ("cls", "tokens"):
        assert rel_l2(out[key], ref[key]) <= REL_L2, key
    assert out["tokens"].shape == (2, (224 // cfg_t.patch_size) ** 2, cfg_t.hidden_size)


def test_vit_tree_round_trip():
    """`bridge.tree_state_dict` of a loaded ViT gives back the tree (the
    patch kernel as the HWIO `w` that `vit_tree` made of it)."""
    cfg = tvit.ViTConfig(**CASES["tiny"])
    tree = jax.tree_util.tree_map(np.asarray, numpy_params(
        lambda k: jvit.init_vit_params(k, jvit.ViTConfig(**CASES["tiny"])), 8))
    model = bridge.load(tvit.ViT(cfg), bridge.vit_tree(tree))
    got = bridge.tree_state_dict(model)
    np.testing.assert_array_equal(got["patch_embedding.w"],
                                  tree["patch_embedding"]["w"].transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(got["layers.1.attn.qkv.w"], tree["layers"][1]["attn"]["qkv"]["w"])
    np.testing.assert_array_equal(got["final_ln.scale"], tree["final_ln"]["scale"])


def dino_state_dict(cfg, seed: int) -> dict:
    """A facebookresearch/dino ViT state dict of `cfg`'s shapes, every
    tensor drawn."""
    rs = np.random.RandomState(seed)
    d, p, hidden = cfg.hidden_size, cfg.patch_size, cfg.hidden_size * cfg.mlp_ratio
    n = (cfg.image_size // p) ** 2 + 1
    shapes = {"cls_token": (1, 1, d), "pos_embed": (1, n, d),
              "patch_embed.proj.weight": (d, 3, p, p), "patch_embed.proj.bias": (d,),
              "norm.weight": (d,), "norm.bias": (d,)}
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        shapes.update({f"{b}.norm1.weight": (d,), f"{b}.norm1.bias": (d,),
                       f"{b}.attn.qkv.weight": (3 * d, d), f"{b}.attn.qkv.bias": (3 * d,),
                       f"{b}.attn.proj.weight": (d, d), f"{b}.attn.proj.bias": (d,),
                       f"{b}.norm2.weight": (d,), f"{b}.norm2.bias": (d,),
                       f"{b}.mlp.fc1.weight": (hidden, d), f"{b}.mlp.fc1.bias": (hidden,),
                       f"{b}.mlp.fc2.weight": (d, hidden), f"{b}.mlp.fc2.bias": (d,)})
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


def test_convert_dino_state_dict_matches_jax():
    kw = CASES["dino width"]
    cfg_j, cfg_t = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    sd = dino_state_dict(cfg_t, 11)
    got = tvit.convert_dino_state_dict(sd, cfg_t)
    want = jvit.convert_dino_state_dict(sd, cfg_j)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    # and the converted tree runs in the port as in JAX
    px = np.random.RandomState(4).randn(1, 3, 224, 224).astype(np.float32)
    model = bridge.load(tvit.ViT(cfg_t), bridge.vit_tree(got))
    with torch.inference_mode():
        out = model(torch.from_numpy(px))["cls"]
    assert rel_l2(out, jvit.vit_encode(want, px, cfg_j)["cls"]) <= REL_L2
