"""The port's motion modules and video UNet against the JAX package, on the CPU.

At the `TINY` / `MTINY` widths of `tests/test_motion.py` (motion trees drawn
from numpy by `numpy_params`, so every `proj_out` is non-zero and the frames
interact), fp32 on both sides, the port's side on one intra-op thread.
Tolerances: 1e-5 of the largest magnitude for the position table and one
module; 1e-4 for a whole UNet call (`test_torch_models.py`'s: fp32 sums over
some 70 layers taken in another order and by other convolution algorithms);
the converter and the bridge leaf for leaf, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from adaface_tpu.models import motion as jmotion
from adaface_tpu.models import unet as junet
from adaface_tpu.tools.convert_motion import convert_motion_modules as jconvert
from adaface_tpu.tools.ckpt_lib import flatten_tree as jflatten
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import motion as tmotion
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.tools import ckpt_lib
from adaface_tpu_torch.tools.convert_motion import convert_motion_modules, load_motion_ckpt
from tests.test_torch_models import _t, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

TINY_KW = dict(block_channels=(32, 64, 64, 64), cross_attn_dim=48, num_heads=4, norm_groups=8,
               lora_rank=8, lora_alpha=1)
MTINY_KW = dict(num_heads=2, norm_groups=8, max_frames=8)
MOTION_RTOL = 1e-5
UNET_RTOL = 1e-4
FRAMES = 4


@pytest.fixture(scope="module")
def pair():
    """(JAX UNet params, JAX motion tree, the port's UNet, the port's motion
    modules) on one set of numpy weights."""
    cfg_j = junet.UNetConfig(**TINY_KW)
    unet_p = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 30)
    motion_p = numpy_params(lambda k: jmotion.init_motion_params(
        k, cfg_j, jmotion.MotionConfig(**MTINY_KW)), 31)
    cfg_t = tunet.UNetConfig(**TINY_KW)
    unet = bridge.load(tunet.UNet2DConditionModel(cfg_t), unet_p)
    motion = bridge.load(tmotion.MotionModules(cfg_t, tmotion.MotionConfig(**MTINY_KW)), motion_p)
    return unet_p, motion_p, unet, motion


def video_inputs(v: int = 1, f: int = FRAMES, hw: int = 16, seed: int = 32):
    rs = np.random.RandomState(seed)
    x = rs.randn(v * f, 4, hw, hw).astype(np.float32)
    t = np.full((v * f,), 100, np.int32)
    ctx = rs.randn(v * f, 8, TINY_KW["cross_attn_dim"]).astype(np.float32)
    return x, t, ctx


def test_position_table_matches_jax():
    for length, dim in ((16, 32), (32, 320), (3, 1280)):
        ref = np.asarray(jmotion.sinusoidal_position_encoding(length, dim))
        out = tmotion.sinusoidal_position_encoding(length, dim).numpy()
        assert_close_rel(out, ref, MOTION_RTOL)
    pe = tmotion.sinusoidal_position_encoding(16, 32, torch.bfloat16)
    assert pe.dtype == torch.bfloat16
    np.testing.assert_array_equal(pe[0, 0::2].float().numpy(), 0.0)
    np.testing.assert_array_equal(pe[0, 1::2].float().numpy(), 1.0)


@pytest.mark.parametrize("where,frames", [("mid", 4), ("down.0.1", 2), ("up.1.2", 4),
                                          ("mid", 10)])
def test_motion_module_matches_jax(pair, where, frames):
    """One module, non-zero `proj_out`, on an NHWC map (JAX) and its
    channels-last NCHW view (the port); one frame is an identity; 10 frames
    run past the kept table's `max_frames` rows (8), as JAX computes the
    table at any length."""
    _, motion_p, _, motion = pair
    node, module = motion_p, motion
    for part in where.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
        module = module[int(part)] if part.isdigit() else getattr(module, part)
    c = node["proj_in"]["w"].shape[0]
    rs = np.random.RandomState(33)
    x = rs.randn(2 * frames, 4, 4, c).astype(np.float32)
    mcfg = jmotion.MotionConfig(**MTINY_KW)
    ref = jax.jit(lambda p, x: jmotion.motion_apply(p, x, frames, mcfg))(node, x)
    xt = _t(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        out = module(xt, frames)
        assert module(xt, 1) is xt
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert_close_rel(out.permute(0, 2, 3, 1).numpy(), ref, MOTION_RTOL)
    assert np.abs(np.asarray(ref) - x).max() > 1e-3  # the module did something


def test_video_unet_matches_jax(pair):
    """`UNet(..., motion=, num_frames=)` against `unet_apply(motion=,
    num_frames=)`: two videos of 4 frames, every temporal module active."""
    unet_p, motion_p, unet, motion = pair
    x, t, ctx = video_inputs(v=2)
    cfg_j, mcfg = junet.UNetConfig(**TINY_KW), jmotion.MotionConfig(**MTINY_KW)
    ref = jax.jit(lambda p, m, x, t, c: junet.unet_apply(
        p, x, t, c, cfg_j, motion=m, num_frames=FRAMES, motion_cfg=mcfg)[0])(
            unet_p, motion_p, x, t, ctx)
    with torch.inference_mode():
        out = unet(_t(x), _t(t).long(), _t(ctx), motion=motion, num_frames=FRAMES)
        image = unet(_t(x), _t(t).long(), _t(ctx))
    assert_close_rel(out.numpy(), ref, UNET_RTOL)
    assert (out - image).abs().max() > 1e-3  # the frames did interact


def test_zero_proj_out_video_unet_is_the_image_unet():
    """Motion modules at init (`proj_out` 0) leave the UNet's output as the
    image UNet's, frame by frame, to the bit."""
    from adaface_tpu_torch.core.params import build

    gen = torch.Generator().manual_seed(34)
    cfg = tunet.UNetConfig(**TINY_KW)
    unet = build(lambda: tunet.UNet2DConditionModel(cfg), "cpu", torch.float32,
                 tunet.init_unet_weights_, gen)
    motion = build(lambda: tmotion.MotionModules(cfg, tmotion.MotionConfig(**MTINY_KW)), "cpu",
                   torch.float32, tmotion.init_motion_weights_, gen)
    assert all(not m.proj_out.weight.any() for m in motion.modules()
               if isinstance(m, tmotion.MotionModule))
    # built on the meta device: the position table is filled by reset_buffers
    assert torch.equal(motion.mid.pe, tmotion.sinusoidal_position_encoding(8, 64))
    x, t, ctx = (_t(a) for a in video_inputs())
    with torch.inference_mode():
        video = unet(x, t.long(), ctx, motion=motion, num_frames=FRAMES)
        image = unet(x, t.long(), ctx)
    assert torch.equal(video, image)


def test_videos_independent_frames_interact(pair):
    """Perturbing video 1's first frame leaves video 0 as it was, and moves
    video 1's other frames (temporal mixing); without motion no frame moves
    another."""
    _, _, unet, motion = pair
    x, t, ctx = (_t(a) for a in video_inputs(v=2, f=2))
    x2 = x.clone()
    x2[2] += 1.0
    with torch.inference_mode():
        a = unet(x, t.long(), ctx, motion=motion, num_frames=2)
        b = unet(x2, t.long(), ctx, motion=motion, num_frames=2)
        c = unet(x, t.long(), ctx)
        d = unet(x2, t.long(), ctx)
    torch.testing.assert_close(b[:2], a[:2], rtol=0, atol=1e-6)
    assert (b[3] - a[3]).abs().max() > 1e-4
    torch.testing.assert_close(d[3], c[3], rtol=0, atol=1e-6)


def test_video_unet_refusals(pair):
    _, _, unet, motion = pair
    x, t, ctx = (_t(a) for a in video_inputs())
    with pytest.raises(ValueError, match="deepcache"):
        unet(x, t.long(), ctx, motion=motion, num_frames=FRAMES, deepcache="collect")
    with pytest.raises(ValueError, match="videos of 3 frames"):
        unet(x, t.long(), ctx, motion=motion, num_frames=3)


def animatediff_state_dict(c: int = 64, seed: int = 35) -> dict:
    """A synthetic AnimateDiff state dict of uniform width `c` (torch
    layouts: Linear [out, in]), with the `pos_encoder.pe` buffers."""
    rs = np.random.RandomState(seed)
    sd = {}

    def lin(prefix, cin, cout, bias=True):
        sd[f"{prefix}.weight"] = rs.randn(cout, cin).astype(np.float32)
        if bias:
            sd[f"{prefix}.bias"] = rs.randn(cout).astype(np.float32)

    def norm(prefix):
        sd[f"{prefix}.weight"] = rs.randn(c).astype(np.float32)
        sd[f"{prefix}.bias"] = rs.randn(c).astype(np.float32)

    def module(prefix):
        tt = f"{prefix}.temporal_transformer"
        norm(f"{tt}.norm")
        lin(f"{tt}.proj_in", c, c)
        tb = f"{tt}.transformer_blocks.0"
        for a in range(2):
            ab = f"{tb}.attention_blocks.{a}"
            for p in "qkv":
                lin(f"{ab}.to_{p}", c, c, bias=False)
            lin(f"{ab}.to_out.0", c, c)
            norm(f"{tb}.norms.{a}")
            sd[f"{ab}.pos_encoder.pe"] = rs.randn(1, 32, c).astype(np.float32)
        lin(f"{tb}.ff.net.0.proj", c, c * 8)
        lin(f"{tb}.ff.net.2", c * 4, c)
        norm(f"{tb}.ff_norm")
        lin(f"{tt}.proj_out", c, c)

    for b in range(4):
        for i in range(2):
            module(f"down_blocks.{b}.motion_modules.{i}")
        for i in range(3):
            module(f"up_blocks.{b}.motion_modules.{i}")
    module("mid_block.motion_modules.0")
    return sd


def assert_same_tree(out: dict, ref: dict):
    a, b = ckpt_lib.flatten_tree(out), jflatten(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("ext", [".npz", ".safetensors", ".ckpt"])
def test_converter_matches_jax(tmp_path, ext):
    """`convert_motion_modules` and `load_motion_ckpt` (each file format)
    against JAX's converter, leaf for leaf; the tree loads into the port's
    modules and runs."""
    sd = animatediff_state_dict()
    ref = jconvert({k: v for k, v in sd.items() if not k.endswith("pos_encoder.pe")})
    assert_same_tree(convert_motion_modules(
        {k: v for k, v in sd.items() if not k.endswith("pos_encoder.pe")}), ref)
    path = str(tmp_path / f"mm{ext}")
    if ext == ".npz":
        np.savez(path, **sd)
    elif ext == ".safetensors":
        ckpt_lib.save_safetensors(sd, path)
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    tree = load_motion_ckpt(path)
    assert_same_tree(tree, ref)
    mcfg = tmotion.MotionConfig(num_heads=2, norm_groups=8)
    motion = bridge.load(tmotion.MotionModules(tunet.UNetConfig(block_channels=(64,) * 4), mcfg),
                         tree)
    x = torch.randn(4, 64, 4, 4).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        assert torch.isfinite(motion.mid(x, 2)).all()


def test_bridge_round_trip(pair):
    """The bridge carries `init_motion_params`' tree into `MotionModules`
    (q, k, v fused into `qkv`) and `tree_state_dict` gives it back, leaf for
    leaf."""
    _, motion_p, _, motion = pair
    back = bridge.tree_state_dict(motion)
    ref = jflatten(motion_p)
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    assert isinstance(motion.mid.blocks[0].attn[0].qkv, tunet.FusedLinear)
    assert len(motion.down) == 4 and all(len(b) == 2 for b in motion.down)
    assert len(motion.up) == 4 and all(len(b) == 3 for b in motion.up)
