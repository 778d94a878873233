"""Int8 serving through the PyTorch port's pipeline and wrapper, against
the JAX package on the CPU.

The pipeline with `quantize_unet=True` and `deepcache_interval=2` against
JAX's (pixels at `IMAGE_ATOL`: an int8 value rounding the other way on one
side moves the later layers, measured 5.9e-3 after 4 int8 DDIM steps), and
`AdaFaceWrapper(quantize_unet=True)`: its pipeline and its batchers serve
the int8 UNet, the modules it was given keep theirs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.pipeline import DiffusionPipeline as JPipeline
from adaface_tpu_torch.inference.pipeline import DiffusionPipeline
from adaface_tpu_torch.inference.wrapper import AdaFaceWrapper
from adaface_tpu_torch.ops import quant
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_serving import HW
from tests.test_torch_slice import NEGATIVE, make_wrapper_pair

IMAGE_ATOL = 1e-2  # pixels in [0, 1] after 4 int8 DDIM steps (measured 5.9e-3)
PROMPT = "a photo of a person"


@pytest.fixture(scope="module")
def wrappers():
    return make_wrapper_pair(steps=3)


def test_int8_with_deepcache_through_the_pipeline_matches_jax(wrappers):
    jw, tw = wrappers
    jp = JPipeline(jw.pipeline.m, dtype=jnp.float32, quantize_unet=True)
    tp = DiffusionPipeline(tw.pipeline.m, dtype=torch.float32, quantize_unet=True)
    assert isinstance(tp.m.unet.conv_in, torch.nn.Conv2d)
    assert isinstance(tp.m.unet.down_blocks[0].resnets[0].conv1, quant.Int8Conv2d)
    assert isinstance(tw.pipeline.m.unet.down_blocks[0].resnets[0].conv1, torch.nn.Conv2d)
    lat = np.random.RandomState(61).randn(1, 4, HW // 4, HW // 4).astype(np.float32)
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=4, guidance_scale=4.0, height=HW,
              width=HW, deepcache_interval=2)
    img_j = np.asarray(jp([PROMPT], latents=jnp.asarray(lat), **kw))
    img_t = tp([PROMPT], latents=torch.from_numpy(lat), **kw).numpy()
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)


def test_wrapper_serves_the_quantized_unet(wrappers):
    """`AdaFaceWrapper(quantize_unet=True)`: its pipeline and the batchers it
    makes run the int8 UNet (the pipeline's images equal an int8
    `DiffusionPipeline`'s, held to JAX in the test above); the modules it was
    given keep theirs."""
    _, tw = wrappers
    m = tw.pipeline.m
    wq = AdaFaceWrapper("text2img", m, tw.id2ada_prompt_encoder, num_inference_steps=3,
                        dtype=torch.float32, quantize_unet=True)
    assert isinstance(wq.pipeline.m.unet.down_blocks[0].resnets[0].conv1, quant.Int8Conv2d)
    assert isinstance(m.unet.down_blocks[0].resnets[0].conv1, torch.nn.Conv2d)
    assert wq.make_batcher(num_slots=2).m.unet is wq.pipeline.m.unet
    lat = np.random.RandomState(62).randn(1, 4, HW // 4, HW // 4).astype(np.float32)
    prompt = wq.update_prompt(PROMPT)
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=3, guidance_scale=4.0,
              height=HW, width=HW)
    img = wq.pipeline([prompt], latents=torch.from_numpy(lat), **kw)
    ref = DiffusionPipeline(m, dtype=torch.float32, quantize_unet=True)(
        [prompt], latents=torch.from_numpy(lat), **kw)
    plain = tw.pipeline([prompt], latents=torch.from_numpy(lat), **kw)
    assert torch.equal(img, ref) and not torch.equal(img, plain)
    via_forward = wq(PROMPT, negative_prompt=NEGATIVE, guidance_scale=4.0, height=HW, width=HW,
                     generator=torch.Generator().manual_seed(0))
    assert via_forward.shape == (1, 3, HW, HW)
