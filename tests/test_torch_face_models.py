"""The face models of the PyTorch port against the JAX package, on the CPU.

ArcFace resnet_face18 and RetinaFace mobilenet0.25 (`adaface_tpu_torch/
models/arcface.py`, `retinaface.py`) get params in the JAX initialisers'
tree layout from numpy seeds (`tests/test_torch_models.py:numpy_params`,
with batch-norm statistics drawn positive), carried over by the bridge,
and the same numpy inputs on both sides, in fp32. Both checkpoint
converters are held against the JAX ones on synthetic torch state dicts.
The port's OpenCV-free image operations (`utils/image.py`) are held against
OpenCV itself, and the face backends against the JAX package's.

Tolerances: network outputs 1e-4 relative to their largest magnitude; the
converters equal; grey and bilinear resize equal to OpenCV; bicubic resize
at most 1 level per pixel with at most 1e-3 of the values off (measured
about 1e-5 against OpenCV 5.0: its float sums round a few ties the other
way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.id2ada import face_backends as jbackends
from adaface_tpu.id2ada.face_id_to_ada_prompt import clip_preprocess as jclip_preprocess
from adaface_tpu.models import arcface as jarc
from adaface_tpu.models import retinaface as jret
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.id2ada import face_backends as tbackends
from adaface_tpu_torch.id2ada.face_id_to_ada_prompt import CLIP_MEAN, CLIP_STD, clip_preprocess
from adaface_tpu_torch.models import arcface as tarc
from adaface_tpu_torch.models import retinaface as tret
from adaface_tpu_torch.utils import image as timage
from tests.test_torch_models import assert_close_rel, numpy_params

cv2 = pytest.importorskip("cv2")

CUBIC_OFF_SHARE = 1e-3


def face_params(init, seed: int):
    """`numpy_params` with batch-norm variances in [0.5, 1.5), means near 0
    and PReLU slopes near 0.25."""
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

    return jax.tree_util.tree_map_with_path(fix, numpy_params(init, seed))


@pytest.fixture(scope="module")
def arcface_pair():
    params = face_params(lambda k: jarc.init_arcface_params(k), 30)
    return params, bridge.load(tarc.ArcFace(), params)


@pytest.fixture(scope="module")
def retinaface_pair():
    params = face_params(jret.init_retinaface_params, 31)
    return params, bridge.load(tret.RetinaFace(), params)


def images(seed: int, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, s).astype(np.uint8) for s in shapes]


SIZES = [(512, 512), (64, 64), (100, 37), (224, 224), (300, 500), (17, 250)]


@pytest.mark.parametrize("hw", SIZES)
def test_image_ops_match_opencv(hw):
    (im,) = images(40, (*hw, 3))
    gray = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(timage.rgb_to_gray(im), gray)
    s = min(hw)
    for src in (gray, gray[:s, :s]):
        np.testing.assert_array_equal(timage.resize_linear(src, (128, 128)),
                                      cv2.resize(src, (128, 128)))
    cubic = timage.resize_cubic(im, (224, 224)).astype(int)
    ref = cv2.resize(im, (224, 224), interpolation=cv2.INTER_CUBIC).astype(int)
    off = np.abs(cubic - ref)
    assert off.max() <= 1 and (off > 0).mean() <= CUBIC_OFF_SHARE, (off.max(), (off > 0).mean())


@pytest.mark.parametrize("hw", [(256, 256), (96, 200)])
def test_clip_preprocess_matches_jax(hw):
    """The port's CLIP input against the JAX package's (cv2) in uint8 levels."""
    ims = images(41, (*hw, 3), (*hw, 3))
    out, ref = clip_preprocess(ims), jclip_preprocess(ims)
    assert out.shape == ref.shape == (2, 3, 224, 224) and out.dtype == np.float32
    level = lambda x: np.rint((x.transpose(0, 2, 3, 1) * CLIP_STD + CLIP_MEAN) * 255)
    off = np.abs(level(out) - level(ref))
    assert off.max() <= 1 and (off > 0).mean() <= CUBIC_OFF_SHARE, (off.max(), (off > 0).mean())


def test_arcface_matches_jax(arcface_pair):
    params, model = arcface_pair
    x = np.random.RandomState(42).uniform(-1, 1, (2, 1, 128, 128)).astype(np.float32)
    ref = jax.jit(jarc.arcface_embed)(params, x)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert out.shape == (2, 512)
    assert_close_rel(out.numpy(), ref)


def torch_state_dict(tree, rename) -> dict:
    """A JAX tree as the torch checkpoint would hold it: `rename` maps the
    bridge's names onto the checkpoint's; PReLU slopes as [1] weights."""
    return {rename(k): v.numpy() for k, v in bridge.state_dict(tree).items()}


def _arcface_name(key: str) -> str:
    key = key[:-2] + ".weight" if key.endswith(".a") else key
    for old, new in ((".se.fc1.", ".se.fc.0."), (".se.prelu.", ".se.fc.1."),
                     (".se.fc2.", ".se.fc.2."), (".downsample.conv.", ".downsample.0."),
                     (".downsample.bn.", ".downsample.1.")):
        key = key.replace(old, new)
    if key.startswith("layers."):
        _, stage, rest = key.split(".", 2)
        key = f"layer{int(stage) + 1}.{rest}"
    return key


def _retinaface_name(key: str) -> str:
    parts = key.split(".")
    if parts[0] == "body":
        sub = {"conv": "0", "bn": "1"} if parts[3] in ("conv", "bn") else None
        if sub:  # stage1.0: conv_bn
            return ".".join(parts[:3] + [sub[parts[3]]] + parts[4:])
        idx = {("dw", "conv"): "0", ("dw", "bn"): "1", ("pw", "conv"): "3", ("pw", "bn"): "4"}
        return ".".join(parts[:3] + [idx[(parts[3], parts[4])]] + parts[5:])
    if parts[0] == "fpn":
        return ".".join(parts[:2] + [{"conv": "0", "bn": "1"}[parts[2]]] + parts[3:])
    if parts[0] == "ssh":
        name = {"conv3x3": "conv3X3", "conv5x5_1": "conv5X5_1", "conv5x5_2": "conv5X5_2",
                "conv7x7_2": "conv7X7_2", "conv7x7_3": "conv7x7_3"}[parts[2]]
        return ".".join([f"ssh{int(parts[1]) + 1}", name,
                         {"conv": "0", "bn": "1"}[parts[3]]] + parts[4:])
    head = {"class": "ClassHead", "bbox": "BboxHead", "landmark": "LandmarkHead"}[parts[1]]
    return f"{head}.{parts[2]}.conv1x1.{parts[-1]}"


@pytest.mark.parametrize("which", ["arcface", "retinaface"])
def test_converters_match_jax(which, arcface_pair, retinaface_pair):
    """A synthetic torch checkpoint through the port's converter and through
    the JAX converter + bridge: the same state dict, and it loads strictly."""
    if which == "arcface":
        (params, model), rename = arcface_pair, _arcface_name
        convert_j, convert_t = jarc.convert_arcface_state_dict, tarc.convert_arcface_state_dict
    else:
        (params, model), rename = retinaface_pair, _retinaface_name
        convert_j = jret.convert_retinaface_state_dict
        convert_t = tret.convert_retinaface_state_dict
    sd = torch_state_dict(params, rename)
    out = convert_t(sd)
    ref = bridge.state_dict(convert_j(sd))
    assert sorted(out) == sorted(ref) == sorted(model.state_dict())
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), ref[k].numpy(), err_msg=k)
    fresh = type(model)()
    fresh.load_state_dict(out, strict=True)


def test_retinaface_matches_jax(retinaface_pair):
    params, model = retinaface_pair
    x = (np.random.RandomState(43).randn(2, 3, 96, 128) * 60).astype(np.float32)
    ref = jax.jit(jret.retinaface_forward)(params, x)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    anchors = len(jret.prior_boxes((96, 128)))
    np.testing.assert_array_equal(tret.prior_boxes((96, 128)), jret.prior_boxes((96, 128)))
    for o, r, k in zip(out, ref, (4, 2, 10)):
        assert o.shape == (2, anchors, k)
        assert_close_rel(o.numpy(), r)


def test_retinaface_client_keeps_the_jax_boxes(retinaface_pair):
    """detect_faces on both sides: the same kept boxes, largest first, and
    crop_faces' protocol."""
    params, model = retinaface_pair
    jclient, tclient = jret.RetinaFaceClient(params), tret.RetinaFaceClient(model)
    (im,) = images(44, (160, 192, 3))
    for thres in (0.5, 0.6):
        ref, out = jclient.detect_faces(im, conf_thres=thres), tclient.detect_faces(im, thres)
        assert len(out) == len(ref) > 0
        for f, g in zip(out, ref):
            np.testing.assert_allclose(f["bbox"], g["bbox"], rtol=1e-4, atol=1e-3)
            assert abs(f["score"] - g["score"]) <= 1e-4
    batch = np.random.RandomState(45).uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    for o, r in zip(tclient.crop_faces(batch), jclient.crop_faces(batch)):
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-3)
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32)
    assert tret.nms(boxes, np.asarray([0.9, 0.8, 0.7], np.float32)) == [0, 2]


@pytest.mark.parametrize("backend", ["arcface", "retinaface+arcface"])
def test_backends_match_jax(backend, arcface_pair, retinaface_pair):
    """Embeddings of the port's backends against the JAX package's (cv2
    grey and resize there): 1e-4 relative per embedding."""
    (arc_p, arc_m), (ret_p, ret_m) = arcface_pair, retinaface_pair
    if backend == "arcface":
        jb, tb = jbackends.ArcFaceJAXBackend(arc_p), tbackends.ArcFaceBackend(arc_m)
    else:
        jb = jbackends.RetinaFaceArcFaceBackend(ret_p, arc_p)
        tb = tbackends.RetinaFaceArcFaceBackend(ret_m, arc_m)
    for im in images(46, (160, 192, 3), (200, 120, 3), (256, 256, 3)):
        ref, out = jb.detect_and_embed(im), tb.detect_and_embed(im)
        assert ref is not None and out.shape == (512,)
        assert abs(np.linalg.norm(out) - 1.0) < 1e-5
        assert_close_rel(out, ref)
    assert tbackends.DeterministicBackend(always_detect=False).detect_and_embed(
        np.zeros((8, 8, 3), np.uint8)) is None


def test_random_init_builds_the_backend_on_the_cpu():
    b = tbackends.RetinaFaceArcFaceBackend.random_init(torch.Generator().manual_seed(0), "cpu")
    (im,) = images(47, (128, 128, 3))
    emb = b.detect_and_embed(im)
    assert emb is None or (emb.shape == (512,) and np.isfinite(emb).all())
    assert all(not p.requires_grad for p in b.arc.arcface.parameters())


@pytest.mark.parametrize("which", ["arcface", "retinaface", "clip_vision"])
def test_face_models_convolve_without_tf32(which, arcface_pair, retinaface_pair):
    """Each face model's forward turns cuDNN's TF32 off for its
    convolutions and restores the caller's setting after."""
    from adaface_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel

    if which == "arcface":
        model, x = arcface_pair[1], torch.zeros(1, 1, 128, 128)
    elif which == "retinaface":
        model, x = retinaface_pair[1], torch.zeros(1, 3, 64, 64)
    else:
        model = CLIPVisionModel(CLIPVisionConfig(hidden_size=32, num_layers=1, num_heads=2,
                                                 intermediate_size=64, patch_size=32))
        x = torch.zeros(1, 3, 224, 224)
    conv = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d)) \
        if which != "clip_vision" else None
    seen = []
    record = lambda *_: seen.append(torch.backends.cudnn.allow_tf32)
    hook = (conv.register_forward_pre_hook(record) if conv is not None
            else model.layers[0].register_forward_pre_hook(record))
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with torch.inference_mode():
            model(x)
        assert seen == [False] and torch.backends.cudnn.allow_tf32 is True
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32 = saved
