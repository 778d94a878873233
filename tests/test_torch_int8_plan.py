"""The int8 convolution's launch plan and its indexing, on the CPU.

`int8_conv_igemm` (`adaface_tpu_torch/csrc/int8_conv.cu`) runs only on the
card. What surrounds it is held here:
- `igemm_plan` at every int8 layer shape of one SD1.5 UNet call (with
  `quantize_dense`) at CFG batch 2 and at the 8-slot batcher's batch 16, the
  census `chip_smoke.check_int8` logs: the tile width against O, the step
  against I, the cluster split against the card and the steps, the shared
  memory a block asks for;
- `int8_conv2d_tiled` / `int8_dense_tiled`, the kernels' schedule in plain
  PyTorch (each tile and tap gathered as the TMA maps gather it, the
  reduction split over a cluster's ranks, the per-block maxima of the
  quantization folded): bit for bit against `int8_conv2d_plain` /
  `int8_dense_plain`, and its integer sums against JAX's `int8_conv2d`'s, at
  3x3/1, 3x3/2, 1x1 and dense shapes with ragged rows, channel tails and
  ragged tiles;
- `quantize_act_slots`, the quantization route's plain version, against
  `quantize_act` and JAX's `_quantize_act`, an all-zero tensor and a tensor
  with one extreme value included.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.ops import quant as jquant
from adaface_tpu_torch.ops import quant
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

SMS = 132  # an H100 SXM's SMs
SMEM = 227 * 1024  # shared memory a block may ask for
EPILOGUE_RTOL = 1e-6  # XLA may fuse the epilogue's multiply and add into one rounding

# every int8 layer of one SD1.5 UNet call with `quantize_dense`, at CFG batch
# 2 and at batch 16 (`chip_smoke.int8_label`)
PATH_SHAPES = [
    "conv 2x320x64x64 -> 320 3x3/1",
    "dense 2x1280 -> 320",
    "conv 2x320x64x64 -> 320 1x1/1",
    "dense 8192x320 -> 320",
    "dense 8192x320 -> 2560",
    "dense 8192x1280 -> 320",
    "conv 2x320x64x64 -> 320 3x3/2",
    "conv 2x320x32x32 -> 640 3x3/1",
    "dense 2x1280 -> 640",
    "conv 2x640x32x32 -> 640 3x3/1",
    "conv 2x320x32x32 -> 640 1x1/1",
    "conv 2x640x32x32 -> 640 1x1/1",
    "dense 2048x640 -> 640",
    "dense 2048x640 -> 5120",
    "dense 2048x2560 -> 640",
    "conv 2x640x32x32 -> 640 3x3/2",
    "conv 2x640x16x16 -> 1280 3x3/1",
    "dense 2x1280 -> 1280",
    "conv 2x1280x16x16 -> 1280 3x3/1",
    "conv 2x640x16x16 -> 1280 1x1/1",
    "conv 2x1280x16x16 -> 1280 1x1/1",
    "dense 512x1280 -> 1280",
    "dense 512x1280 -> 10240",
    "dense 512x5120 -> 1280",
    "conv 2x1280x16x16 -> 1280 3x3/2",
    "conv 2x1280x8x8 -> 1280 3x3/1",
    "conv 2x1280x8x8 -> 1280 1x1/1",
    "dense 128x1280 -> 1280",
    "dense 128x1280 -> 10240",
    "dense 128x5120 -> 1280",
    "conv 2x2560x8x8 -> 1280 3x3/1",
    "conv 2x2560x8x8 -> 1280 1x1/1",
    "conv 2x2560x16x16 -> 1280 3x3/1",
    "conv 2x2560x16x16 -> 1280 1x1/1",
    "conv 2x1920x16x16 -> 1280 3x3/1",
    "conv 2x1920x16x16 -> 1280 1x1/1",
    "conv 2x1280x32x32 -> 1280 3x3/1",
    "conv 2x1920x32x32 -> 640 3x3/1",
    "conv 2x1920x32x32 -> 640 1x1/1",
    "conv 2x1280x32x32 -> 640 3x3/1",
    "conv 2x1280x32x32 -> 640 1x1/1",
    "conv 2x960x32x32 -> 640 3x3/1",
    "conv 2x960x32x32 -> 640 1x1/1",
    "conv 2x640x64x64 -> 640 3x3/1",
    "conv 2x960x64x64 -> 320 3x3/1",
    "conv 2x960x64x64 -> 320 1x1/1",
    "conv 2x640x64x64 -> 320 3x3/1",
    "conv 2x640x64x64 -> 320 1x1/1",
    "conv 16x320x64x64 -> 320 3x3/1",
    "dense 16x1280 -> 320",
    "conv 16x320x64x64 -> 320 1x1/1",
    "dense 65536x320 -> 320",
    "dense 65536x320 -> 2560",
    "dense 65536x1280 -> 320",
    "conv 16x320x64x64 -> 320 3x3/2",
    "conv 16x320x32x32 -> 640 3x3/1",
    "dense 16x1280 -> 640",
    "conv 16x640x32x32 -> 640 3x3/1",
    "conv 16x320x32x32 -> 640 1x1/1",
    "conv 16x640x32x32 -> 640 1x1/1",
    "dense 16384x640 -> 640",
    "dense 16384x640 -> 5120",
    "dense 16384x2560 -> 640",
    "conv 16x640x32x32 -> 640 3x3/2",
    "conv 16x640x16x16 -> 1280 3x3/1",
    "dense 16x1280 -> 1280",
    "conv 16x1280x16x16 -> 1280 3x3/1",
    "conv 16x640x16x16 -> 1280 1x1/1",
    "conv 16x1280x16x16 -> 1280 1x1/1",
    "dense 4096x1280 -> 1280",
    "dense 4096x1280 -> 10240",
    "dense 4096x5120 -> 1280",
    "conv 16x1280x16x16 -> 1280 3x3/2",
    "conv 16x1280x8x8 -> 1280 3x3/1",
    "conv 16x1280x8x8 -> 1280 1x1/1",
    "dense 1024x1280 -> 1280",
    "dense 1024x1280 -> 10240",
    "dense 1024x5120 -> 1280",
    "conv 16x2560x8x8 -> 1280 3x3/1",
    "conv 16x2560x8x8 -> 1280 1x1/1",
    "conv 16x2560x16x16 -> 1280 3x3/1",
    "conv 16x2560x16x16 -> 1280 1x1/1",
    "conv 16x1920x16x16 -> 1280 3x3/1",
    "conv 16x1920x16x16 -> 1280 1x1/1",
    "conv 16x1280x32x32 -> 1280 3x3/1",
    "conv 16x1920x32x32 -> 640 3x3/1",
    "conv 16x1920x32x32 -> 640 1x1/1",
    "conv 16x1280x32x32 -> 640 3x3/1",
    "conv 16x1280x32x32 -> 640 1x1/1",
    "conv 16x960x32x32 -> 640 3x3/1",
    "conv 16x960x32x32 -> 640 1x1/1",
    "conv 16x640x64x64 -> 640 3x3/1",
    "conv 16x960x64x64 -> 320 3x3/1",
    "conv 16x960x64x64 -> 320 1x1/1",
    "conv 16x640x64x64 -> 320 3x3/1",
    "conv 16x640x64x64 -> 320 1x1/1",
]


def parse(label: str) -> tuple[int, int, int, int, int]:
    """(rows, i, o, k, stride) of a census label."""
    m = re.fullmatch(r"conv (\d+)x(\d+)x(\d+)x(\d+) -> (\d+) (\d)x\d/(\d)", label)
    if m:
        n, i, h, w, o, k, s = map(int, m.groups())
        pad = k // 2
        ho, wo = quant.conv_out_hw(h, w, k, s, pad)
        return n * ho * wo, i, o, k, s
    rows, i, o = map(int, re.fullmatch(r"dense (\d+)x(\d+) -> (\d+)", label).groups())
    return rows, i, o, 1, 1


@pytest.mark.parametrize("label", PATH_SHAPES)
def test_igemm_plan_at_path_shapes(label):
    rows, i, o, k, stride = parse(label)
    plan = quant.igemm_plan(rows, i, o, k, stride, SMS)
    steps = quant.igemm_steps(i, k, plan.step)
    assert plan.tile_n in quant.TILE_WIDTHS
    assert o % plan.tile_n == 0  # no ragged channel tile on the path
    # a tap's channel tail (320 and 960 in 128-byte steps) arrives zero-filled:
    # at most a fifth of the steps' bytes wasted
    waste = steps * plan.step / (k * k * i) - 1
    assert plan.step == quant.STEP and (i % plan.step == 0 or waste <= 0.2)
    assert 1 <= plan.split <= min(quant.MAX_PLAN_SPLIT, steps) and plan.split in quant.SPLITS
    assert 2 <= plan.stages <= quant.MAX_STAGES and quant.igemm_smem(plan) <= SMEM
    assert not plan.transpose or rows <= quant.TILE_ROWS
    tiles = quant.igemm_tiles(rows, o, plan.tile_n)
    # a split only where the tiles fall short of the fill of the two block slots an SM,
    # and never past them
    assert plan.split == 1 or (tiles < quant.SPLIT_FILL * 2 * SMS
                               and tiles * plan.split <= 2 * SMS)
    assert quant.igemm_plan(rows, i, o, k, stride, SMS) is plan  # cached


@pytest.mark.parametrize("rows,i,o,k,want_tiles,want_split", [
    (8192, 320, 320, 3, 128, 2),  # 2x320x64x64 -> 320 3x3: 128 tiles of 160, 27 steps
    (128, 1280, 1280, 3, 10, 8),  # 2x1280x8x8 -> 1280 3x3: 10 tiles of 128 and 90 steps
    (128, 1280, 1280, 1, 10, 4),  # its 1x1: 10 tiles (few) of 10 steps, 2 a block at the least
    (2048, 640, 640, 3, 64, 3),  # 2x640x32x32 -> 640 3x3: 64 tiles of 160
    (1024, 2560, 1280, 3, 64, 3),  # 16x2560x8x8 -> 1280 3x3 at batch 16
    (2, 1280, 1280, 1, 10, 4),  # time_emb_proj at CFG batch 2: two rows
])
def test_igemm_plan_split_at_path_shapes(rows, i, o, k, want_tiles, want_split):
    """The reduction split over a cluster at the SD1.5 UNet's shapes on 132
    SMs: unsplit where the tiles reach SPLIT_FILL of the two block slots an
    SM, otherwise the cluster size nearest the shortfall, MAX_PLAN_SPLIT at
    most and MIN_SPLIT_STEPS steps a block at the least (2 where the tiles
    are few)."""
    plan = quant.igemm_plan(rows, i, o, k, 1, SMS)
    tiles = quant.igemm_tiles(rows, o, plan.tile_n)
    assert tiles == want_tiles
    assert plan.split == want_split
    least = 2 if tiles < quant.FEW_TILES * SMS else quant.MIN_SPLIT_STEPS
    assert quant.igemm_steps(i, k) // plan.split >= least


@pytest.mark.parametrize("rows,o,k,want", [
    (65536, 320, 3, 160),  # 2048 tiles of 160: 128 does not divide 320
    (65536, 2560, 1, 160),  # 8192 tiles of 160 (many)
    (4096, 1280, 3, 160),  # 256 tiles
    (2048, 640, 1, 128),  # 64 tiles, a 1x1: 128
    (2048, 640, 3, 160),  # 64 tiles, a 3x3: 160
    (128, 1280, 3, 128),  # 8 tiles (few): 128
])
def test_igemm_plan_width_follows_the_work(rows, o, k, want):
    assert quant.igemm_plan(rows, 1280, o, k, 1, SMS).tile_n == want


def _x_w(rs, n, c, h, w, o, k, extreme=False):
    x = rs.randn(n, c, h, w).astype(np.float32) * 2.0
    if extreme:
        x[0, 0, 0, 0] = 1e4
    wt = rs.randn(o, c, k, k).astype(np.float32) / np.sqrt(k * k * c)
    w_q, scale = quant.quantize_weight(torch.from_numpy(wt))
    return (torch.from_numpy(x), w_q.permute(0, 2, 3, 1).contiguous(), scale,
            torch.from_numpy(0.1 * rs.randn(o).astype(np.float32)))


def jax_int8_sums(x, w_q, stride, pad):
    """JAX's `int8_conv2d` integer sums (its own `_quantize_act` of x):
    NCHW torch → NHWC int64 numpy."""
    x_q, _ = jquant._quantize_act(jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    y = jax.lax.conv_general_dilated(
        x_q, jnp.asarray(w_q.permute(1, 2, 3, 0).numpy()), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(y).astype(np.int64)


# (n, c, h, w, o, k, stride, plan): ragged rows (not a multiple of 128),
# boxes that cross rows and images, channel tails (c not a multiple of 64),
# ragged channel tiles (o below the tile), splits that do and do not divide
# the steps
TILED_CASES = [
    ("3x3/1", 3, 32, 9, 10, 24, 3, 1, quant.IgemmPlan(160, 128, 3, 1)),
    ("3x3/1 split 4", 2, 96, 5, 7, 40, 3, 1, quant.IgemmPlan(128, 128, 3, 4)),
    ("3x3/1 split 7", 1, 64, 6, 6, 16, 3, 1, quant.IgemmPlan(160, 128, 2, 7)),
    ("3x3/2", 3, 64, 9, 6, 24, 3, 2, quant.IgemmPlan(160, 128, 3, 1)),
    ("3x3/2 split 3", 2, 32, 20, 18, 136, 3, 2, quant.IgemmPlan(128, 128, 3, 3)),
    ("1x1", 2, 96, 9, 10, 24, 1, 1, quant.IgemmPlan(160, 128, 3, 2)),
    ("1x1 ragged tile", 3, 160, 7, 8, 264, 1, 1, quant.IgemmPlan(160, 128, 3, 1)),
    ("3x3/1 two steps a tap", 2, 160, 5, 6, 40, 3, 1, quant.IgemmPlan(160, 128, 3, 2)),
    ("3x3/2 split 3 a tap's tail", 2, 96, 7, 9, 24, 3, 2, quant.IgemmPlan(128, 128, 3, 3)),
    ("1x1 two and a half steps", 2, 320, 6, 5, 48, 1, 1, quant.IgemmPlan(128, 128, 3, 2)),
]


@pytest.mark.parametrize("case", TILED_CASES, ids=[c[0] for c in TILED_CASES])
def test_tiled_schedule_is_the_plain_conv_and_jaxs(case):
    _, n, c, h, w, o, k, stride, plan = case
    rs = np.random.RandomState(n * 100 + c + o)
    x, w_q, w_scale, bias = _x_w(rs, n, c, h, w, o, k)
    pad = k // 2
    out = quant.int8_conv2d_tiled(x, w_q, w_scale, bias, stride, pad, plan)
    ref = quant.int8_conv2d_plain(x, w_q, w_scale, bias, stride, pad)
    assert out.shape == ref.shape and torch.equal(out, ref)
    x_q, _ = quant.quantize_act(x)
    sums = quant.igemm_tiled_sums(x_q.permute(0, 2, 3, 1), w_q, k, stride, pad, plan)
    np.testing.assert_array_equal(sums.numpy(), jax_int8_sums(x, w_q, stride, pad))
    p = {"w_q": jnp.asarray(w_q.permute(1, 2, 3, 0).numpy()),
         "w_scale": jnp.asarray(w_scale.numpy()), "b": jnp.asarray(bias.numpy())}
    jref = np.asarray(jquant.int8_conv2d(p, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), stride,
                                         pad))
    scale = max(1.0, float(np.abs(jref).max()))
    assert np.abs(out.permute(0, 2, 3, 1).numpy() - jref).max() <= EPILOGUE_RTOL * scale


@pytest.mark.parametrize("rows,i,o,plan", [
    (2, 96, 40, quant.IgemmPlan(160, 128, 3, 2)),  # two rows, as time_emb_proj's at batch 2
    (300, 64, 48, quant.IgemmPlan(128, 128, 3, 1)),  # three row tiles, the last ragged
])
def test_tiled_dense_is_the_plain_dense_and_jaxs(rows, i, o, plan):
    rs = np.random.RandomState(rows + o)
    x = torch.from_numpy(rs.randn(rows, i).astype(np.float32))
    w_q, w_scale = quant.quantize_weight(torch.from_numpy(rs.randn(o, i).astype(np.float32)))
    bias = torch.from_numpy(rs.randn(o).astype(np.float32))
    out = quant.int8_dense_tiled(x, w_q, w_scale, bias, plan)
    assert torch.equal(out, quant.int8_dense_plain(x, w_q, w_scale, bias))
    p = {"w_q": jnp.asarray(w_q.T.numpy()), "w_scale": jnp.asarray(w_scale.numpy()),
         "b": jnp.asarray(bias.numpy())}
    jref = np.asarray(jquant.int8_dense(p, jnp.asarray(x.numpy())))
    assert np.abs(out.numpy() - jref).max() <= EPILOGUE_RTOL * max(1.0, float(np.abs(jref).max()))


def test_tiled_schedule_at_the_plans_own_choice():
    """`int8_conv2d_tiled` with `igemm_plan`'s plan for the shape (a split
    one: few tiles on 132 SMs)."""
    rs = np.random.RandomState(5)
    x, w_q, w_scale, bias = _x_w(rs, 2, 128, 4, 4, 160, 3)
    plan = quant.igemm_plan(32, 128, 160, 3, 1, SMS)
    assert plan.split > 1
    out = quant.int8_conv2d_tiled(x, w_q, w_scale, bias, 1, 1)
    assert torch.equal(out, quant.int8_conv2d_plain(x, w_q, w_scale, bias, 1, 1))


@pytest.mark.parametrize("what", ["random", "zeros", "one extreme", "bf16 ragged"])
@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_quantize_route_is_quantize_act_and_jaxs(what, blocks):
    rs = np.random.RandomState(blocks)
    x = torch.from_numpy(rs.randn(2, 40, 6, 7).astype(np.float32) * 3.0)
    if what == "zeros":
        x = torch.zeros(2, 40, 6, 7)
    elif what == "one extreme":
        x[1, 3, 2, 5] = -3e4
    elif what == "bf16 ragged":
        x = torch.from_numpy(rs.randn(5, 13, 11).astype(np.float32)).to(torch.bfloat16)
    x_q, scale, slots = quant.quantize_act_slots(x, blocks)
    ref_q, ref_scale = quant.quantize_act(x)
    assert torch.equal(x_q, ref_q) and scale.item() == ref_scale.item()
    assert slots.shape == (blocks,) and slots.max().item() == x.float().abs().max().item()
    jq, jscale = jquant._quantize_act(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)


def test_quant_blocks_follow_the_kernel():
    assert quant.quant_blocks(2 * 320 * 64 * 64, SMS) == 2 * SMS
    assert quant.quant_blocks(16, SMS) == 1
    assert quant.quant_blocks(2 * 1280, SMS) == 2
    assert quant.quant_blocks(10 ** 9, 600) == quant.QUANT_SLOTS  # a card of 600 SMs: the slots cap
