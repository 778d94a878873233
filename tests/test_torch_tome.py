"""Token merging (ToMe) of the PyTorch port against the JAX package, on the
CPU in fp32.

`adaface_tpu_torch/ops/tome.py` against `adaface_tpu/ops/tome.py`: the
partition (numpy on both sides: equal), the merge and unmerge of the same
tokens (1e-6: the same fp32 sums, a division), and the tiny UNet of
`tests/test_torch_models.py` with ToMe in its transformers against
`unet_apply(tome=...)` (1e-4 of the output's scale, `MODULE_RTOL`: the
module parity bar; `min_tokens` is lowered to the tiny maps' 256 and 64
tokens so that the merge runs where the SD1.5 UNet's 4096 would).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import unet as junet
from adaface_tpu.ops import tome as jtome
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.ops import tome as ttome
from tests.test_torch_models import D, UNET_KW, assert_close_rel, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

MERGE_ATOL = 1e-6
# (min_tokens, ratio, merge_crossattn, merge_mlp): level 0 (256 tokens) at
# the default ratio; levels 0 and 1 (64) with every op merged
UNET_TOME = [dict(min_tokens=256), dict(min_tokens=64, ratio=0.3, merge_crossattn=True,
                                        merge_mlp=True, rand_seed=None)]


@pytest.mark.parametrize("seed", [None, 0, 3])
@pytest.mark.parametrize("hw", [(16, 16), (9, 7), (64, 64)])
def test_partition_matches_jax(seed, hw):
    h, w = hw
    for a, b in zip(ttome._partition(h, w, 2, 2, seed), jtome._partition(h, w, 2, 2, seed)):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.int32


def test_config_defaults_match_jax():
    assert dataclasses.asdict(ttome.ToMeConfig()) == dataclasses.asdict(jtome.ToMeConfig())
    assert hash(ttome.ToMeConfig())


@pytest.mark.parametrize("r", [0, 7, 32, 48])
def test_merge_and_unmerge_match_jax(r):
    rs = np.random.RandomState(r)
    h, w, b = 8, 10, 2
    x = rs.randn(b, h * w, 16).astype(np.float32)
    # tokens close to token 0, so that several sources pick one target (apart
    # by more than fp32 rounding: a tie would be decided by the sums' order)
    x[:, 1::7] = x[:, 0:1] + 0.1 * rs.randn(b, len(range(1, h * w, 7)), 16)
    tokens = rs.randn(b, h * w, 24).astype(np.float32)
    jm, ju, jn = jtome.build_merge(jnp.asarray(x), h, w, r, 2, 2, rand_seed=3)
    tm, tu, tn = ttome.build_merge(torch.from_numpy(x), h, w, r, 2, 2, rand_seed=3)
    assert tn == jn == h * w - r
    merged_j = np.asarray(jm(jnp.asarray(tokens)))
    merged_t = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(merged_t, merged_j, atol=MERGE_ATOL, rtol=0)
    np.testing.assert_allclose(tu(torch.from_numpy(merged_j)).numpy(),
                               np.asarray(ju(jnp.asarray(merged_j))), atol=0, rtol=0)
    # the matching itself, against JAX's argsort / argmax
    merged_pos, kept_pos, tgt = ttome.match(torch.from_numpy(x), h, w, r, 2, 2, 3)
    assert merged_pos.shape == (b, r) and kept_pos.shape == (b, 60 - r) and tgt.shape == (b, r)


def test_unmerge_of_merge_of_ones_is_one():
    x = torch.randn(2, 64, 16, generator=torch.Generator().manual_seed(0))
    merge, unmerge, _ = ttome.build_merge(x, 8, 8, 32, rand_seed=3)
    ones = torch.ones(2, 64, 16)
    torch.testing.assert_close(unmerge(merge(ones)), ones, atol=1e-6, rtol=0)
    assert merge(ones).shape == (2, 32, 16)


def test_merge_is_the_same_bits_twice():
    """The merged sums are taken in a fixed order (`index_put_` with
    accumulate): two merges of the same tokens agree to the bit."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 256, 32, generator=g)
    x[:, 100:200] = x[:, :1]  # many sources on one target
    merge, _, _ = ttome.build_merge(x, 16, 16, 128, rand_seed=0)
    assert torch.equal(merge(x), merge(x))


@pytest.fixture(scope="module")
def unet_pair():
    cfg_j, cfg_t = junet.UNetConfig(**UNET_KW), tunet.UNetConfig(**UNET_KW)
    params = numpy_params(lambda k: junet.init_unet_params(k, cfg_j), 21)
    model = bridge.load(tunet.UNet2DConditionModel(cfg_t), params)
    rs = np.random.RandomState(21)
    inputs = (rs.randn(2, 4, 16, 16).astype(np.float32), np.array([801, 33], np.int32),
              rs.randn(2, 77, D).astype(np.float32))
    return cfg_j, params, model, inputs


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kw", UNET_TOME)
def test_unet_with_tome_matches_jax(unet_pair, kw):
    cfg_j, params, model, (x, t, ctx) = unet_pair
    ref = jax.jit(lambda p, x, t, c: junet.unet_apply(p, x, t, c, cfg_j,
                                                      tome=jtome.ToMeConfig(**kw))[0])(
        params, x, t, ctx)
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx), tome=ttome.ToMeConfig(**kw))
        plain = model(_t(x), _t(t).long(), _t(ctx))
    assert_close_rel(out.numpy(), ref)
    assert not torch.equal(out, plain)  # the merge ran


def test_tome_is_off_under_img_mask(unet_pair):
    """With an img_mask no transformer merges (`unet.py:625-628`): the output
    is the unmerged call's, bit for bit, and JAX's."""
    cfg_j, params, model, (x, t, ctx) = unet_pair
    mask = np.zeros((2, 1, 16, 16), np.float32)
    mask[:, :, 4:12, 3:13] = 1.0
    tome = dict(min_tokens=64, ratio=0.5)
    ref = jax.jit(lambda p, x, t, c, m: junet.unet_apply(
        p, x, t, c, cfg_j, img_mask=m, tome=jtome.ToMeConfig(**tome))[0])(params, x, t, ctx, mask)
    with torch.inference_mode():
        out = model(_t(x), _t(t).long(), _t(ctx), img_mask=_t(mask), tome=ttome.ToMeConfig(**tome))
        plain = model(_t(x), _t(t).long(), _t(ctx), img_mask=_t(mask))
    assert torch.equal(out, plain)
    assert_close_rel(out.numpy(), ref)


def test_cross_attention_merge_is_off_under_capture(unet_pair):
    """Under capture the captured cross-attentions run on every token
    (`unet.py:647-649`): the captures keep their full length and equal JAX's,
    while the self-attentions still merge."""
    cfg_j, params, model, (x, t, ctx) = unet_pair
    tome = dict(min_tokens=64, ratio=0.5, merge_crossattn=True)
    eps_j, cap_j = jax.jit(lambda p, x, t, c: junet.unet_apply(
        p, x, t, c, cfg_j, rt=junet.AttnRuntime(capture=True),
        tome=jtome.ToMeConfig(**tome)))(params, x, t, ctx)
    cap_t = {}
    with torch.inference_mode():
        eps_t = model(_t(x), _t(t).long(), _t(ctx), capture=cap_t,
                      rt=tunet.AttnRuntime(capture=True), tome=ttome.ToMeConfig(**tome))
        plain = model(_t(x), _t(t).long(), _t(ctx), capture={},
                      rt=tunet.AttnRuntime(capture=True))
    assert_close_rel(eps_t.numpy(), eps_j)
    assert not torch.equal(eps_t, plain)
    for key in ("attn", "q", "attn_out", "outfeat"):
        for label, val in cap_t[key].items():
            assert val.shape == tuple(cap_j[key][label].shape), (key, label)
            assert_close_rel(val.numpy(), cap_j[key][label])
