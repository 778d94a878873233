"""The recon iteration's modules of the PyTorch port against the JAX package,
on the CPU: the ArcFace identity losses (`train/face_losses.py`), the host
face detector and the latent boxes (`train/face_detect.py`), the adversarial
gradient (`train/recon_multistep.py`), the decoder under autograd, and the
plain versions of the two backward kernels at the shapes this slice adds
(the flash backward at the VAE's head dim 512, the GroupNorm VJP at the VAE
decoder's channel counts).

The same numpy inputs go through both, in fp32; modules get the JAX params
through the bridge. Tolerances: values and gradients 1e-5 relative to the
largest magnitude; host detections and masks equal.

Gradients through a random ArcFace are not comparable elementwise: its
max-pools and PReLUs are kinks, and an fp32 rounding apart in an activation
flips which side of one a value falls on (the JAX gradient itself moves by
far more than 1e-5 when its input moves by 1e-7). So each loss is held twice:
with the random ArcFace on its values, and with `SmoothTower`, the same
smooth stand-in embedding on both sides (patched into the JAX module), on its
values and its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.models import arcface as jarc
from adaface_tpu.models import vae as jvae
from adaface_tpu.ops import attention as jattn
from adaface_tpu.ops import fused_gn as jgn
from adaface_tpu.train import face_detect as jdet
from adaface_tpu.train import face_losses as jfl
from adaface_tpu.train import recon_multistep as jrm
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import arcface as tarc
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops import attention as tattn
from adaface_tpu_torch.ops import fused_gn as tgn
from adaface_tpu_torch.train import face_detect as tdet
from adaface_tpu_torch.train import face_losses as tfl
from adaface_tpu_torch.train import recon_multistep as trm
from tests.test_torch_models import UNET_KW, VAE_KW, numpy_params

RTOL = 1e-5
PX = 64  # decoded images of the tiny VAE (16x16 latents)
# the recon tests' UNet: two levels, one resnet a block. At 16x16 latents its
# top level's transformers take the flash path (256 tokens) and the last up
# block's cross-attention is captured, at a fraction of the four-level tiny
# UNet's compile time in the JAX recon graphs (several UNet calls each)
RECON_UNET_KW = dict(UNET_KW, block_channels=(16, 32), layers_per_block=1,
                     down_has_attn=(True, False), up_has_attn=(False, True))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def arcface_params(seed: int, use_se: bool = False):
    """Numpy-seeded ArcFace params with batch-norm variances in [0.5, 1.5),
    means near 0 and PReLU slopes near 0.25."""
    rs = np.random.RandomState(seed + 1000)

    def fix(path, a):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name == "var":
            return jnp.asarray(rs.uniform(0.5, 1.5, a.shape).astype(np.float32))
        if name == "mean":
            return jnp.asarray((0.1 * rs.randn(*a.shape)).astype(np.float32))
        if name == "a":
            return jnp.asarray((0.25 + 0.05 * rs.randn(*a.shape)).astype(np.float32))
        return a

    return jax.tree_util.tree_map_with_path(
        fix, numpy_params(lambda k: jarc.init_arcface_params(k, use_se=use_se), seed))


@pytest.fixture(scope="module")
def arcface_pair():
    params = arcface_params(40)
    return params, bridge.load(tarc.ArcFace(use_se=False), params)


@pytest.fixture(scope="module")
def vae_pair():
    cfg = jvae.VAEConfig(**VAE_KW)
    params = numpy_params(lambda k: jvae.init_vae_params(k, cfg), 41)
    return cfg, params, bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)),
                                    bridge.vae_decoder_tree(params))


class SmoothTower(torch.nn.Module):
    """A smooth stand-in for ArcFace: [B, 1, 128, 128] → tanh(4x4-averaged
    pixels · W) [B, 512]. `jax_embed` is the same function for the JAX side."""

    def __init__(self, seed: int = 42):
        super().__init__()
        w = np.random.RandomState(seed).randn(32 * 32, 512).astype(np.float32) / 32.0
        self.w = torch.nn.Parameter(torch.from_numpy(w), requires_grad=False)
        self.w_np = w

    def forward(self, x):
        pooled = torch.nn.functional.avg_pool2d(x, 4).flatten(1)
        return torch.tanh(pooled @ self.w)

    def jax_embed(self, params, x):
        b = x.shape[0]
        pooled = x.reshape(b, 32, 4, 32, 4).mean(axis=(2, 4)).reshape(b, -1)
        return jnp.tanh(pooled @ jnp.asarray(self.w_np))


@pytest.fixture(params=["arcface", "smooth"])
def tower(request, monkeypatch, arcface_pair):
    """(JAX params, port module, whether gradients are held): the random
    ArcFace (values only), or `SmoothTower` patched into the JAX module."""
    if request.param == "arcface":
        return (*arcface_pair, False)
    smooth = SmoothTower()
    monkeypatch.setattr(jfl, "arcface_embed", smooth.jax_embed)
    return None, smooth, True


def _images(seed, b=2, px=PX):
    return np.clip(np.random.RandomState(seed).randn(b, 3, px, px) * 0.5, -1, 1).astype(
        np.float32)


BOXES = np.array([[8.0, 6.0, 40.0, 44.0], [0.0, 0.0, 64.0, 64.0]], np.float32)


def test_gradient_mask_matches_jax():
    rs = np.random.RandomState(0)
    x, mask, g = rs.randn(2, 1, 8, 8), (rs.rand(1, 1, 8, 8) > 0.5) * 1.0, rs.randn(2, 1, 8, 8)
    x, mask, g = (a.astype(np.float32) for a in (x, mask, g))
    out, vjp = jax.vjp(lambda a: jfl.gradient_mask(a, jnp.asarray(mask)), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    y = tfl.gradient_mask(tx, _t(mask))
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("boxes", [BOXES, np.array([[-5.0, 3.3, 30.7, 70.0],
                                                    [20.25, 10.5, 21.0, 11.0]], np.float32)])
def test_bilinear_crop_matches_jax_vjp(boxes):
    """Values and the gradient to the image, boxes inside, over the border
    (clipped) and smaller than a pixel."""
    img = _images(1)
    g = np.random.RandomState(2).randn(2, 3, 32, 32).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jfl.bilinear_crop(a, jnp.asarray(boxes), 32), jnp.asarray(img))
    ti = _t(img).requires_grad_()
    y = tfl.bilinear_crop(ti, _t(boxes), 32)
    y.backward(_t(g))
    assert _rel(y.detach().numpy(), out) <= RTOL
    assert _rel(ti.grad.numpy(), vjp(jnp.asarray(g))[0]) <= RTOL


def _jax_value_and_vjp(fn, x, grads: bool):
    """(fn(x), its vjp, or None where gradients are not held: the random
    ArcFace runs the forward alone)."""
    if grads:
        return jax.vjp(fn, jnp.asarray(x))
    return fn(jnp.asarray(x)), None


@pytest.mark.parametrize("ratios", [(1.0, 0.3), (0.9, 0.9), (-1.0, -1.0)])
def test_embed_face_crops_matches_jax(tower, ratios):
    """Both embeddings and (through `SmoothTower`) the image's gradient
    through the masked crops."""
    params, model, grads = tower
    img = _images(3)
    gc, gb = (np.random.RandomState(s).randn(2, 512).astype(np.float32) for s in (4, 5))
    (jc, jb), vjp = _jax_value_and_vjp(
        lambda a: jfl.embed_face_crops(params, a, jnp.asarray(BOXES), ratios), img, grads)
    ti = _t(img).requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        ec, eb = tfl.embed_face_crops(model, ti, _t(BOXES), ratios)
    assert _rel(ec.detach().numpy(), jc) <= RTOL and _rel(eb.detach().numpy(), jb) <= RTOL
    if grads:
        ((ec * _t(gc)).sum() + (eb * _t(gb)).sum()).backward()
        assert _rel(ti.grad.numpy(), vjp((jnp.asarray(gc), jnp.asarray(gb)))[0]) <= RTOL


def test_arcface_align_loss_matches_jax(tower):
    """The three losses, with background boxes, and (through `SmoothTower`)
    the generated images' gradient of their sum; an undetected instance is
    masked out."""
    params, model, grads = tower
    ref, gen = _images(6), _images(7)
    det = np.array([1.0, 0.0], np.float32)
    aligned = np.array([[4.0, 4.0, 50.0, 52.0], [10.0, 0.0, 60.0, 40.0]], np.float32)
    bg = np.array([[30.0, 30.0, 60.0, 60.0]], np.float32)
    idx = np.array([1])

    def fn(a):
        return jfl.calc_arcface_align_loss(
            params, jnp.asarray(ref), a, jnp.asarray(BOXES), jnp.asarray(aligned),
            jnp.asarray(det), jnp.asarray(bg), jnp.asarray(idx))

    jl, vjp = _jax_value_and_vjp(fn, gen, grads)
    tg = _t(gen).requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        tl = tfl.calc_arcface_align_loss(model, _t(ref), tg, _t(BOXES), _t(aligned), _t(det),
                                         _t(bg), _t(idx))
    for a, r in zip(tl, jl):
        assert _rel(a.item(), r) <= RTOL
    if grads:
        sum(tl).backward()
        assert _rel(tg.grad.numpy(), vjp(tuple(jnp.ones(()) for _ in jl))[0]) <= RTOL


@pytest.mark.parametrize("valid", [[[1.0, 0.0], [1.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]]])
def test_bg_faces_suppress_loss_matches_jax(tower, valid):
    params, model, grads = tower
    img = _images(8)
    boxes = np.random.RandomState(9).uniform(0, 30, (2, 2, 4)).astype(np.float32)
    boxes[..., 2:] += 30.0
    valid = np.asarray(valid, np.float32)
    fn = lambda a: jfl.calc_bg_faces_suppress_loss(params, a, jnp.asarray(boxes),  # noqa: E731
                                                   jnp.asarray(valid))
    (jl, jany), vjp = _jax_value_and_vjp(fn, img, grads)
    ti = _t(img).requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        tl, tany = tfl.calc_bg_faces_suppress_loss(model, ti, _t(boxes), _t(valid))
    assert tany.item() == float(jany)
    assert _rel(tl.item(), jl) <= RTOL or float(jl) == tl.item() == 0.0
    if grads:
        tl.backward()
        grad = np.asarray(vjp((jnp.ones(()), jnp.zeros(())))[0])
        if not grad.any():
            assert not ti.grad.any()
        else:
            assert _rel(ti.grad.numpy(), grad) <= RTOL


def _many_faces(img):
    """A detector of several faces whose boxes depend on the image only
    through its shape: ranked by area by the detector, one under min_size."""
    h, w = img.shape[:2]
    return [(np.array([2, 2, 14, 14], np.float32), 0.5),  # 12 px: under min_size 20
            (np.array([0, 0, 30, 25], np.float32), 0.7),
            (np.array([10, 12, w + 5, h - 1], np.float32), 0.9),  # past the right edge
            (np.array([5, 30, 40, 60], np.float32), 0.8),
            (np.array([20, 20, 45, 46], np.float32), 0.6)]


def _fails(img):
    raise RuntimeError("detector failure")


@pytest.mark.parametrize("detector_fn,max_bg", [(_many_faces, 2), (_many_faces, 3),
                                                (lambda img: [], 2), (_fails, 2),
                                                (lambda img: None, 2)])
def test_host_face_detector_matches_jax(detector_fn, max_bg):
    """Ranking by area, min_size, clipping to the image, the background
    slots; a detector that finds nothing or raises gives "no face, full
    box"; uint8 images and [-1, 1] floats."""
    img = _images(10)
    for images in (img, np.clip((img.transpose(0, 2, 3, 1) + 1) * 127.5, 0, 255).astype(np.uint8)):
        ref = jdet.HostFaceDetector(detector_fn=detector_fn, max_bg=max_bg)(images)
        got = tdet.HostFaceDetector(detector_fn=detector_fn, max_bg=max_bg)(images)
        for field in ("fg_bboxes", "detected", "confidences", "bg_bboxes", "bg_valid"):
            np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)


def test_detector_conversion_truncates_as_jax():
    """[-1, 1] floats to uint8 as the JAX detector converts them (clip, then
    truncation), at values whose scaled form lands just under and over
    whole numbers."""
    levels = (np.arange(256, dtype=np.float64) / 127.5 - 1.0)
    vals = np.concatenate([levels, levels + 1e-6, levels - 1e-6, [-1.5, 1.5]]).astype(np.float32)
    img = np.resize(vals, (1, 3, 8, 100)).astype(np.float32)
    seen = []
    tdet.HostFaceDetector(detector_fn=lambda a: seen.append(a) or [])(img)
    want = np.clip((img.transpose(0, 2, 3, 1) + 1) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.stack(seen), want)
    np.testing.assert_array_equal(tdet.to_uint8_nhwc(img), want)


def test_detector_without_a_backend_finds_no_face(monkeypatch):
    """No injected detector and no backend: "none", every image a full box
    and undetected, nothing raised; `detect_faces` hands the boxes back as
    tensors on the images' device."""
    det = tdet.HostFaceDetector()
    monkeypatch.setattr(det, "_pick_backend", lambda: "none")
    assert det.backend == "none"
    img = _t(_images(11))
    fg, found, conf, bgb, bgv = tdet.detect_faces(img, det)
    assert fg.device == img.device and fg.dtype == torch.float32
    np.testing.assert_array_equal(fg.numpy(), np.tile([[0, 0, PX, PX]], (2, 1)))
    assert not found.any() and not bgv.any() and tuple(bgb.shape) == (2, 2, 4)


def test_latent_boxes_match_jax():
    boxes = np.array([[8.0, 6.9, 40.0, 44.5], [0.0, 0.0, 64.0, 64.0], [63.0, 1.0, 64.0, 9.0]],
                     np.float32)
    det = np.array([1.0, 1.0, 0.0], np.float32)
    ref_lat = jdet.map_bboxes_to_latent(jnp.asarray(boxes), 64, 16)
    got_lat = tdet.map_bboxes_to_latent(_t(boxes), 64, 16)
    np.testing.assert_array_equal(got_lat.numpy(), np.asarray(ref_lat))
    ref = jdet.bbox_latent_mask(ref_lat, jnp.asarray(det), (16, 16))
    np.testing.assert_array_equal(tdet.bbox_latent_mask(got_lat, _t(det), (16, 16)).numpy(),
                                  np.asarray(ref))


def test_calc_arcface_adv_grad_matches_jax(monkeypatch, vae_pair):
    """The adversarial gradient through the decoder (recomputed in the
    backward), the masked crops and the dropout (JAX's uniforms handed over),
    masked to the latent box; the embedding `SmoothTower` on both sides (a
    gradient)."""
    model = SmoothTower()
    monkeypatch.setattr(jfl, "arcface_embed", model.jax_embed)
    params = None
    cfg, vae_params, decoder = vae_pair
    x = np.random.RandomState(12).randn(2, 4, 16, 16).astype(np.float32)
    lat = np.array([[2.0, 1.0, 10.0, 11.0], [0.0, 0.0, 16.0, 16.0]], np.float32)
    key = jax.random.PRNGKey(13)
    ref = jrm.calc_arcface_adv_grad(params, vae_params, jnp.asarray(x), jnp.asarray(lat),
                                    jnp.asarray(BOXES), key, dropout_p=0.3, vae_cfg=cfg)
    u = np.asarray(jax.random.uniform(key, (2, 512)))
    got = trm.calc_arcface_adv_grad(model, decoder, _t(x), _t(lat), _t(BOXES), _t(u), 0.3)
    assert np.asarray(ref).any()
    assert _rel(got.numpy(), ref) <= RTOL


def test_vae_decode_with_gradient_matches_jax(vae_pair):
    """The decoder under autograd (its activations recomputed in the
    backward), frozen weights: the image and the latent's gradient; without
    grad the same image."""
    cfg, params, decoder = vae_pair
    z = np.random.RandomState(14).randn(2, 4, 16, 16).astype(np.float32)
    g = np.random.RandomState(15).randn(2, 3, PX, PX).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jvae.vae_decode(params, a, cfg), jnp.asarray(z))
    tz = _t(z).requires_grad_()
    calls = []
    # a pre-hook: the recompute stops once it has what the backward needs
    hook = decoder.decoder.register_forward_pre_hook(lambda *a: calls.append(1))
    try:
        y = tvae.vae_decode(decoder, tz)
        y.backward(_t(g))
    finally:
        hook.remove()
    assert len(calls) == 2  # the forward, and its recompute in the backward
    assert y.dtype == torch.float32 and _rel(y.detach().numpy(), out) <= RTOL
    assert _rel(tz.grad.numpy(), vjp(jnp.asarray(g))[0]) <= RTOL
    assert not any(p.grad is not None for p in decoder.parameters())
    with torch.no_grad():
        assert torch.equal(tvae.vae_decode(decoder, _t(z)), y.detach())


@pytest.mark.parametrize("sq,sk,masked,causal", [(32, 40, False, False), (48, 40, True, False),
                                                 (32, 48, True, True)])
def test_flash_bwd_chunked_at_head_dim_512_matches_jax_vjp(monkeypatch, sq, sk, masked, causal):
    """`flash_bwd_chunked` at the VAE's head dim 512, the plain version of
    the wide backward kernel: against `jax.vjp` of the JAX flash attention
    (Pallas in interpret mode, its `_flash_bwd`), several query chunks."""
    monkeypatch.setattr(jattn, "_pick_bwd_chunk", lambda b, h, sq, sk: 8)
    monkeypatch.setattr(tattn, "_pick_bwd_chunk", lambda b, h, sq, sk: 8)
    rs = np.random.RandomState(16)
    q, k, v = (rs.randn(2, 1, n, 512).astype(np.float32) for n in (sq, sk, sk))
    g = rs.randn(2, 1, sq, 512).astype(np.float32)
    mask = None
    if masked:
        mask = (rs.rand(2, sk) > 0.3).astype(np.float32)
        mask[1, :4] = 0.0
    fn = lambda q, k, v: jattn.flash_attention(q, k, v, kv_mask=mask, causal=causal,  # noqa
                                               block_q=16, block_k=16, interpret=True)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    scale = 1.0 / np.sqrt(512)
    tm = None if mask is None else _t(mask)
    out = tattn.scaled_dot_product_attention(_t(q), _t(k), _t(v), kv_mask=tm, causal=causal,
                                             scale=scale)
    got = tattn.flash_bwd_chunked(_t(q), _t(k), _t(v), tm, out, _t(g), causal, scale)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert _rel(a.numpy(), r) <= RTOL, name
    # the wrapper takes D 512 with grad (on the card: the wide kernels)
    assert tattn._bwd_refusal(torch.empty(1, 1, 1, 512, dtype=torch.bfloat16)) is None


@pytest.mark.parametrize("c,silu", [(512, True), (512, False), (256, True), (128, True)])
def test_group_norm_vjp_at_vae_decoder_channels(c, silu):
    """The GroupNorm Function's backward (`gn_silu_bwd_plain` on the CPU) at
    the VAE decoder's channel counts, 32 groups, channels-last, against
    `jax.vjp` of the JAX GroupNorm."""
    rs = np.random.RandomState(c + silu)
    x = (rs.randn(2, 8, 8, c) * 2.0 + 0.5).astype(np.float32)  # NHWC, as JAX
    scale, bias = (rs.randn(c) + 1.0).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    fn = lambda x, s, b: jgn.fused_group_norm_silu(x, s, b, 32, 1e-6, apply_silu=silu,  # noqa
                                                   use_pallas=False)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (x, scale, bias)))
    ref_dx, ref_ds, ref_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx = _t(x).permute(0, 3, 1, 2).requires_grad_()
    ts, tb = _t(scale).requires_grad_(), _t(bias).requires_grad_()
    tgn.group_norm_silu(tx, ts, tb, 32, 1e-6, apply_silu=silu).backward(_t(g).permute(0, 3, 1, 2))
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), ref_dx) <= RTOL
    assert _rel(ts.grad.numpy(), ref_ds) <= RTOL and _rel(tb.grad.numpy(), ref_db) <= RTOL


@pytest.mark.parametrize("ext", [".safetensors", ".npz"])
def test_ckpt_lib_matches_jax(tmp_path, ext):
    """`flatten_tree` and `cast_fp16` of a nested tree with lists as the JAX
    package's; a file either package writes, the other reads back equal."""
    from adaface_tpu.tools import ckpt_lib as jckpt
    from adaface_tpu_torch.tools import ckpt_lib as tckpt

    rs = np.random.RandomState(17)
    tree = {"a": {"w": rs.randn(3, 4).astype(np.float32), "b": None},
            "layers": [{"k": rs.randn(2).astype(np.float32)},
                       {"k": np.arange(3, dtype=np.int64)}]}
    flat, ref = tckpt.flatten_tree(tree), jckpt.flatten_tree(tree)
    assert sorted(flat) == sorted(ref) == ["a.w", "layers.0.k", "layers.1.k"]
    half, jhalf = tckpt.cast_fp16(flat), jckpt.cast_fp16(ref)
    for k in ref:
        assert half[k].dtype == jhalf[k].dtype and np.array_equal(half[k], jhalf[k])
    for write, read in ((tckpt.save_state_dict, jckpt.load_state_dict),
                        (jckpt.save_state_dict, tckpt.load_state_dict)):
        path = str(tmp_path / f"x{ext}")
        write(half, path)
        back = read(path)
        assert sorted(back) == sorted(half)
        assert all(back[k].dtype == half[k].dtype and np.array_equal(back[k], half[k])
                   for k in half)
