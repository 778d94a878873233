"""The port's GMA optical flow (`adaface_tpu_torch/models/gma.py`) against
`adaface_tpu.models.gma`, on the CPU in fp32.

One synthetic torch GMA checkpoint in the reference's key layout (weights
N(0, 2/fan_in) as `init_gma_params` draws them, biases, batch norms and the
aggregation's γ off their start) goes through both converters; JAX runs its
tree, the port runs it through `core.bridge.load`. Held at 1e-4 relative L2:
the warp utilities, the correlation pyramid and the lookup with its
transposed window, `_refine` and `est_flow_from_feats` (C 32, 8x8, 12
iterations), `make_latent_flow_fn`, and `gma_flow` (64x64, 3 iterations).
The converters are held leaf for leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import gma as jgma
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import gma as tgma
from tests.test_torch_models import one_torch_thread  # noqa: F401

REL_L2 = 1e-4


def rel_l2(out, ref) -> float:
    out = np.asarray(out, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(out - ref) / max(np.linalg.norm(ref), 1e-30))


def torch_gma_state_dict(seed: int = 0) -> dict:
    """A GMA checkpoint in the reference's layout (`module.` prefixed, as
    `gma-sintel.pth` is), numpy-drawn."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, cin, cout, kh, kw=None, bias=True):
        kw = kh if kw is None else kw
        sd[f"module.{name}.weight"] = torch.from_numpy(
            (rs.randn(cout, cin, kh, kw) * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32))
        if bias:
            sd[f"module.{name}.bias"] = torch.from_numpy((0.1 * rs.randn(cout)).astype(np.float32))

    def bn(name, c):
        for k, v in (("weight", 1 + 0.1 * rs.randn(c)), ("bias", 0.1 * rs.randn(c)),
                     ("running_mean", 0.1 * rs.randn(c)), ("running_var", 0.5 + rs.rand(c))):
            sd[f"module.{name}.{k}"] = torch.from_numpy(v.astype(np.float32))

    for enc, kind in (("fnet", "instance"), ("cnet", "batch")):
        conv(f"{enc}.conv1", 3, 64, 7)
        if kind == "batch":
            bn(f"{enc}.norm1", 64)
        for li, (cin, cout, stride) in enumerate([(64, 64, 1), (64, 96, 2), (96, 128, 2)], 1):
            for bi, (bc_in, s) in enumerate([(cin, stride), (cout, 1)]):
                name = f"{enc}.layer{li}.{bi}"
                conv(f"{name}.conv1", bc_in, cout, 3)
                conv(f"{name}.conv2", cout, cout, 3)
                if kind == "batch":
                    bn(f"{name}.norm1", cout)
                    bn(f"{name}.norm2", cout)
                if s != 1:
                    conv(f"{name}.downsample.0", bc_in, cout, 1)
                    if kind == "batch":
                        bn(f"{name}.downsample.1", cout)
        conv(f"{enc}.conv2", 128, 256, 1)
    conv("att.to_qk", 128, 256, 1, bias=False)
    u = "update_block"
    conv(f"{u}.encoder.convc1", tgma.CORR_PLANES, 256, 1)
    conv(f"{u}.encoder.convc2", 256, 192, 3)
    conv(f"{u}.encoder.convf1", 2, 128, 7)
    conv(f"{u}.encoder.convf2", 128, 64, 3)
    conv(f"{u}.encoder.conv", 256, 126, 3)
    conv(f"{u}.aggregator.to_v", 128, 128, 1, bias=False)
    sd[f"module.{u}.aggregator.gamma"] = torch.tensor([0.5])
    for k, (kh, kw) in (("z1", (1, 5)), ("r1", (1, 5)), ("q1", (1, 5)),
                        ("z2", (5, 1)), ("r2", (5, 1)), ("q2", (5, 1))):
        conv(f"{u}.gru.conv{k[0]}{k[1]}", 512, 128, kh, kw)
    conv(f"{u}.flow_head.conv1", 128, 256, 3)
    conv(f"{u}.flow_head.conv2", 256, 2, 3)
    conv(f"{u}.mask.0", 128, 256, 3)
    conv(f"{u}.mask.2", 256, 576, 1)
    # the relative position embedding the content-only attention drops
    sd["module.att.pos_emb.rel_height.weight"] = torch.zeros(127, 128)
    return sd


@pytest.fixture(scope="module")
def weights():
    sd = torch_gma_state_dict()
    jtree = jgma.convert_gma_state_dict({k: v.numpy() for k, v in sd.items()})
    ptree = tgma.convert_gma_state_dict(sd)
    return jax.tree_util.tree_map(jnp.asarray, jtree), bridge.load(tgma.GMA(), ptree), ptree


def test_convert_gma_state_dict_matches_jax(weights):
    """Leaf for leaf (names, shapes, values) against JAX's converter, in the
    tree of `init_gma_params`; the bridge's GMA module holds every leaf."""
    jtree, model, ptree = weights
    jl, jt = jax.tree_util.tree_flatten_with_path(jtree)
    pl, pt = jax.tree_util.tree_flatten_with_path(ptree)
    assert jt == pt
    ref_t = jax.tree_util.tree_structure(jax.eval_shape(jgma.init_gma_params,
                                                        jax.random.PRNGKey(0)))
    assert jt == ref_t
    for (path, a), (_, b) in zip(jl, pl):
        assert isinstance(b, np.ndarray), path
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))
    sd = model.state_dict()
    assert len(sd) == len(pl)
    np.testing.assert_array_equal(sd["update.gru.z1.weight"].numpy(),
                                  ptree["update"]["gru"]["z1"]["w"].transpose(3, 2, 0, 1))


def test_warp_utilities_match_jax():
    """`backward_warp_by_flow` (flows that leave the map), `flow2attn` (the
    scattered taps against JAX's dense warped identity, to the bit),
    `smooth_flow` with and without the small-motion threshold, and
    `flow_to_image`."""
    rs = np.random.RandomState(1)
    b, c, h, w = 2, 5, 7, 9
    img = rs.randn(b, c, h, w).astype(np.float32)
    flow = (rs.randn(b, 2, h, w) * 3).astype(np.float32)
    out = tgma.backward_warp_by_flow(torch.from_numpy(img), torch.from_numpy(flow))
    ref = jgma.backward_warp_by_flow(jnp.asarray(img), jnp.asarray(flow))
    assert rel_l2(out.numpy(), ref) <= 1e-6
    att = tgma.flow2attn(torch.from_numpy(flow), h, w)
    np.testing.assert_array_equal(att.numpy(), np.asarray(jgma.flow2attn(jnp.asarray(flow), h, w)))
    for thres in (0.0, 0.5):
        out = tgma.smooth_flow(torch.from_numpy(flow), 2.0, ignore_thres=thres)
        ref = jgma.smooth_flow(jnp.asarray(flow), 2.0, ignore_thres=thres)
        assert rel_l2(out.numpy(), ref) <= 1e-6
        assert (out.numpy() == 0).sum() == (np.asarray(ref) == 0).sum()
    hw2 = flow[0].transpose(1, 2, 0)
    np.testing.assert_array_equal(tgma.flow_to_image(hw2), jgma.flow_to_image(hw2))


def test_corr_pyramid_and_lookup_match_jax():
    """The four pooled levels, and the window lookup (zeros outside, the
    delta named dy added to x) at coordinates off the grid and off the map."""
    rs = np.random.RandomState(2)
    b, c, h, w = 2, 16, 8, 8
    f1 = rs.randn(b, c, h, w).astype(np.float32)
    f2 = rs.randn(b, c, h, w).astype(np.float32)
    tp, shape = tgma._corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    jp, jshape = jgma._corr_pyramid(jnp.asarray(f1.transpose(0, 2, 3, 1)),
                                    jnp.asarray(f2.transpose(0, 2, 3, 1)))
    assert shape == jshape and len(tp) == len(jp) == tgma.CORR_LEVELS
    for t, j in zip(tp, jp):
        assert rel_l2(t.numpy(), np.asarray(j)[..., 0]) <= 1e-6
    coords = (rs.rand(b, 2, h, w) * 12 - 2).astype(np.float32)
    out = tgma._corr_lookup(tp, shape, torch.from_numpy(coords))
    ref = jgma._corr_lookup(jp, jshape, jnp.asarray(coords.transpose(0, 2, 3, 1)))
    assert out.shape == (b, tgma.CORR_PLANES, h, w)
    assert rel_l2(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)) <= 1e-6


def feats(seed, b=2, c=32, h=8, w=8):
    rs = np.random.RandomState(seed)
    f1 = rs.randn(b, c, h * w).astype(np.float32)
    shifted = np.roll(f1.reshape(b, c, h, w), 1, axis=3).reshape(b, c, h * w)
    f2 = (shifted + 0.3 * rs.randn(b, c, h * w)).astype(np.float32)
    return f1, f2


def test_refine_and_latent_flow_match_jax(weights):
    """`_refine` (12 iterations, zero state) and `est_flow_from_feats` on C 32
    8x8 features, and `make_latent_flow_fn` with the small-motion zeroing."""
    jtree, model, _ = weights
    f1, f2 = feats(3)
    b, c, h, w = 2, 32, 8, 8
    with torch.no_grad():
        tp, shape = tgma._corr_pyramid(torch.from_numpy(f1).reshape(b, c, h, w),
                                       torch.from_numpy(f2).reshape(b, c, h, w), False)
        z = torch.zeros((b, tgma.HDIM, h, w))
        flow, mask = tgma._refine(model, tp, shape, z, z.clone(), 12)
    jref = jax.jit(lambda p, a, b_: jgma._refine(
        p, *jgma._corr_pyramid(a, b_, False), jnp.zeros((b, h, w, 128)),
        jnp.zeros((b, h, w, 128)), 12))
    jflow, jmask = jref(jtree, jnp.asarray(f1.reshape(b, c, h, w).transpose(0, 2, 3, 1)),
                        jnp.asarray(f2.reshape(b, c, h, w).transpose(0, 2, 3, 1)))
    assert rel_l2(flow.numpy(), np.asarray(jflow).transpose(0, 3, 1, 2)) <= REL_L2
    assert rel_l2(mask.numpy(), np.asarray(jmask).transpose(0, 3, 1, 2)) <= REL_L2
    assert np.abs(flow.numpy()).max() > 1e-3
    with torch.no_grad():
        out = tgma.est_flow_from_feats(model, torch.from_numpy(f1), torch.from_numpy(f2), h, w)
        fn = tgma.make_latent_flow_fn(model)
        smoothed = fn(torch.from_numpy(f1), torch.from_numpy(f2), h, w, 0.3)
    ref = jax.jit(lambda p, a, b_: jgma.est_flow_from_feats(p, a, b_, h, w))(jtree, f1, f2)
    assert rel_l2(out.numpy(), ref) <= REL_L2
    jfn = jgma.make_latent_flow_fn(jtree)
    sref = jax.jit(lambda a, b_: jfn(a, b_, h, w, 0.3))(f1, f2)
    assert rel_l2(smoothed.numpy(), sref) <= REL_L2
    assert (smoothed.numpy() == 0).any()


def test_gma_flow_matches_jax(weights):
    """The image path at 64x64 (8x8 features), 3 iterations: both encoders,
    the context split, the convex upsampling to full resolution."""
    jtree, model, _ = weights
    rs = np.random.RandomState(4)
    img1 = (rs.rand(1, 3, 64, 64) * 255).astype(np.float32)
    img2 = np.roll(img1, 2, axis=3)
    with torch.no_grad():
        out = tgma.gma_flow(model, torch.from_numpy(img1), torch.from_numpy(img2), num_iters=3)
    ref = jax.jit(lambda p, a, b_: jgma.gma_flow(p, a, b_, num_iters=3))(jtree, img1, img2)
    assert out.shape == (1, 2, 64, 64)
    assert rel_l2(out.numpy(), ref) <= REL_L2


def test_init_gma_weights_scales():
    """The seeded random GMA at `init_gma_params`' scales: conv weights of
    std √(2/fan_in), biases and γ 0, batch norms 1/0."""
    model = tgma.GMA()
    tgma.init_gma_weights_(model, torch.Generator().manual_seed(0))
    w = model.update["gru"]["z1"].weight
    assert abs(w.std().item() / np.sqrt(2.0 / (5 * 512)) - 1) < 0.05
    assert model.update["agg"].gamma.item() == 0 and not model.cnet.conv1.bias.any()
    assert (model.cnet.n1.weight == 1).all() and (model.cnet.n1.running_var == 1).all()
