"""The port's continuous batcher against the JAX package's, on the CPU.

The four cases of `tests/test_serving.py` run through both batchers on the
same tiny fp32 weights (`tests/test_torch_slice.py:make_wrapper_pair`): the
JAX batcher draws a request's initial latents from `PRNGKey(seed)`, which
torch cannot repeat, so the test makes the same draw and hands it to the
port in `Request.latents`. Every port image is held to the JAX batcher's at
1e-4 (pixels in [0, 1]), the bar `tests/test_serving.py` sets between the
JAX batcher and the JAX pipeline; the port's batcher is also held to the
port's own one-shot pipeline at that bar. Injected prompt embeddings are
held to the table write's at 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.serving import Request as JRequest
from adaface_tpu_torch.inference.serving import ContinuousBatcher, Request, SlotState
from tests.test_torch_slice import make_wrapper_pair
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
HW = 64  # pixels; 16x16 latents at the tiny VAE's scale of 4
IMAGE_ATOL = 1e-4
COND_ATOL = 1e-5


@pytest.fixture(scope="module")
def wrappers():
    return make_wrapper_pair(steps=STEPS)


def jax_latents(seed: int) -> np.ndarray:
    """The JAX batcher's initial latents for a request with this seed."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (4, HW // 4, HW // 4),
                                      jnp.float32))


def drain_both(jw, tw, specs, num_slots=2):
    """`specs`: dicts of Request fields (prompt, seed, guidance, ada as a
    (JAX, port) pair). → (port images, JAX images, the port's batcher)."""
    jb = jw.make_batcher(num_slots=num_slots, height=HW, width=HW)
    tb = tw.make_batcher(num_slots=num_slots, height=HW, width=HW)
    jreqs, treqs = [], []
    for spec in specs:
        spec = dict(spec)
        ada_j, ada_t = spec.pop("ada", (None, None))
        jreqs.append(jw.make_request(ada_embs=ada_j, **spec))
        treqs.append(tw.make_request(ada_embs=ada_t, **spec,
                                     latents=torch.from_numpy(jax_latents(spec["seed"]))))
    out_j = jb.generate_all(jreqs)
    out_t = {rid: img.numpy() for rid, img in tb.generate_all(treqs).items()}
    return out_t, out_j, tb


def subject_pair(jw, tw, seed: int):
    fid = np.random.RandomState(seed).randn(1, 512).astype(np.float32)
    return (jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(fid),
                                          update_text_encoder=False),
            tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(fid),
                                          update_text_encoder=False))


def test_single_request_matches_jax_and_pipeline(wrappers):
    jw, tw = wrappers
    out_t, out_j, _ = drain_both(jw, tw, [dict(prompt="a photo of a cat", seed=7)])
    assert list(out_t) == [0] and out_t[0].shape == (3, HW, HW)
    np.testing.assert_allclose(out_t[0], out_j[0], atol=IMAGE_ATOL)
    ref = tw.pipeline([tw.update_prompt("a photo of a cat")], negative_prompt="",
                      num_inference_steps=STEPS, guidance_scale=6.0, height=HW, width=HW,
                      latents=torch.from_numpy(jax_latents(7))[None])[0]
    np.testing.assert_allclose(out_t[0], ref.numpy(), atol=IMAGE_ATOL)


def test_mixed_batch_slots_are_isolated(wrappers):
    """5 requests through 2 slots (refills mid-flight), each with its own
    prompt, seed and guidance scales: every image equals the JAX batcher's,
    and its own one-shot pipeline run."""
    jw, tw = wrappers
    specs = [dict(prompt=f"prompt number {i}", seed=10 + i, guidance_scale=2.0 + i,
                  guidance_scale_min=1.0 if i % 2 else None) for i in range(5)]
    out_t, out_j, _ = drain_both(jw, tw, specs)
    assert sorted(out_t) == [0, 1, 2, 3, 4]
    for i, spec in enumerate(specs):
        np.testing.assert_allclose(out_t[i], out_j[i], atol=IMAGE_ATOL, err_msg=f"req {i}")
        ref = tw.pipeline([tw.update_prompt(spec["prompt"])], negative_prompt="",
                          num_inference_steps=STEPS, guidance_scale=spec["guidance_scale"],
                          guidance_scale_min=spec["guidance_scale_min"], height=HW, width=HW,
                          latents=torch.from_numpy(jax_latents(spec["seed"]))[None])[0]
        np.testing.assert_allclose(out_t[i], ref.numpy(), atol=IMAGE_ATOL, err_msg=f"req {i}")


def test_ada_injection_matches_table_write(wrappers):
    """Per-request injection gives the prompt embeddings the table write
    gives, and the JAX batcher's."""
    jw, tw = wrappers
    ada_j, ada_t = subject_pair(jw, tw, 40)
    tw.update_text_encoder_subj_embeddings(ada_t)
    prompt = tw.update_prompt("portrait of")
    m = tw.pipeline.m
    ids = torch.as_tensor(m.tokenizer([prompt], max_length=77), dtype=torch.long)
    with torch.inference_mode():
        table_cond = m.text_encoder(ids)
    tb = tw.make_batcher(num_slots=1)
    tb._admit(0, tw.make_request("portrait of", ada_embs=ada_t))
    np.testing.assert_allclose(tb._state.cond[0].numpy(), table_cond[0].numpy(),
                               atol=COND_ATOL)
    jb = jw.make_batcher(num_slots=1)
    jb._admit(0, jw.make_request("portrait of", ada_embs=ada_j))
    np.testing.assert_allclose(tb._state.cond[0].numpy(), np.asarray(jb._state.cond[0]),
                               atol=COND_ATOL)
    np.testing.assert_allclose(tb._state.uncond[0].numpy(), np.asarray(jb._state.uncond[0]),
                               atol=COND_ATOL)


def test_multi_subject_requests(wrappers):
    """Two subjects in flight at once, same prompt and latents: the images
    differ, and each equals the JAX batcher's. A third request with CLIP-skip
    weights goes through both as well."""
    jw, tw = wrappers
    a, b = subject_pair(jw, tw, 41), subject_pair(jw, tw, 42)
    out_t, out_j, _ = drain_both(jw, tw, [
        dict(prompt="portrait", ada=a, seed=5),
        dict(prompt="portrait", ada=b, seed=5),
        dict(prompt="portrait", ada=a, seed=5, skip_weights=[0.25, 0.75])])
    assert len(out_t) == 3
    for rid, img in out_t.items():
        assert img.shape == (3, HW, HW) and np.isfinite(img).all()
        assert 0.0 <= img.min() and img.max() <= 1.0
        np.testing.assert_allclose(img, out_j[rid], atol=IMAGE_ATOL, err_msg=f"req {rid}")
    assert np.abs(out_t[0] - out_t[1]).max() > 1e-4
    assert np.abs(out_t[0] - out_t[2]).max() > 1e-4


def test_slot_state_keeps_its_buffers(wrappers):
    """The step and admission write the pool's state in place: over a drain
    with refills every buffer keeps its address, and the state object is the
    one the batcher was built with."""
    _, tw = wrappers
    tb = tw.make_batcher(num_slots=2, height=HW, width=HW)
    state = tb._state
    assert isinstance(state, SlotState) and len(state.tensors()) == 6
    ptrs = [t.data_ptr() for t in state.tensors()]
    assert state.cond.data_ptr() == state.ctx[2:].data_ptr()  # views of the UNet's context
    out = tb.generate_all([tw.make_request(f"p {i}", seed=i) for i in range(5)])
    assert len(out) == 5 and tb._state is state
    assert [t.data_ptr() for t in state.tensors()] == ptrs
    assert state.active.tolist() == [0, 0] and (tb._remaining == 0).all()


def test_step_reads_nothing_back(wrappers):
    """A step never asks the device for a value: with every conversion of a
    tensor to a host value made to raise, it still runs, and advances only
    the active slots."""
    _, tw = wrappers
    tb = tw.make_batcher(num_slots=2, height=HW, width=HW)
    tb._admit(1, tw.make_request("a portrait", seed=3))
    before = tb._state.latents.clone()
    refuse = mock.Mock(side_effect=AssertionError("a host read inside the step"))
    reads = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")
    with mock.patch.multiple(torch.Tensor, **{name: refuse for name in reads}):
        tb._step()
        tb._step()
    assert tb._state.step.tolist() == [0, 2]
    assert torch.equal(tb._state.latents[0], before[0])
    assert not torch.equal(tb._state.latents[1], before[1])
    for _ in range(3):  # past the end of a trajectory the index stays on the table
        tb._step()
    assert tb._state.step.tolist() == [0, STEPS - 1]


def test_request_latents_and_seed(wrappers):
    _, tw = wrappers
    tb = tw.make_batcher(num_slots=1, height=HW, width=HW)
    with pytest.raises(ValueError, match="request latents"):
        tb._admit(0, tw.make_request("p", latents=torch.zeros(4, 8, 8)))
    # without latents the draw comes from a generator seeded with `seed`
    imgs = tb.generate_all([Request("p", seed=1), Request("p", seed=1), Request("p", seed=2)])
    assert torch.equal(imgs[0], imgs[1]) and not torch.equal(imgs[0], imgs[2])
    # make_request carries the wrapper's guidance scale unless one is given
    assert tw.make_request("p").guidance_scale == tw.guidance_scale
    assert tw.make_request("p", guidance_scale=2.5).guidance_scale == 2.5
    assert isinstance(tw.make_batcher(), ContinuousBatcher)
    assert JRequest("p").guidance_scale == Request("p").guidance_scale
