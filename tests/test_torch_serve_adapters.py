"""Serving what the port's trainers write, on the CPU against the JAX
package: the pipeline with the UNet's trained attention and FFN DoRA
adapters, the weighted UNet ensemble, the continuous batcher with adapters,
and `AdaFaceWrapper.load_unet_lora_weights` from a checkpoint of the port's
trainer.

Both sides run the same tiny fp32 weights (`tests/test_torch_slice.py:
make_wrapper_pair`) and the same adapter trees, every part live
(`tests/test_torch_comp.py:lora_trees`: B non-zero, magnitudes off 1), at
rank 4, carried into the port by `core/bridge.py`. Images are held to JAX's
at 1e-4 (pixels in [0, 1]), the bar of `tests/test_torch_serving.py`. The
JAX batcher's draws from `PRNGKey(seed)` are handed to the port in
`Request.latents`. The port's side runs on one intra-op thread.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.inference.pipeline import DiffusionPipeline as JPipeline
from adaface_tpu.inference.serving import Request as JRequest
from adaface_tpu.models import unet as junet
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.inference.pipeline import DiffusionPipeline
from adaface_tpu_torch.inference.serving import Request
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt, save_adaface_ckpt
from adaface_tpu_torch.train.train_step import lora_state_dicts
from tests.test_torch_comp import lora_trees
from tests.test_torch_models import UNET_KW, numpy_params
from tests.test_torch_serving import HW, IMAGE_ATOL, STEPS, jax_latents
from tests.test_torch_slice import NEGATIVE, make_wrapper_pair
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)

RANK = 4
PROMPT = "a portrait at the beach"
# the adapted image's distance from the plain one, in relative L2, at the least
ADAPTED_REL_L2 = 1e-3


@pytest.fixture(scope="module")
def setup():
    """(JAX wrapper, port wrapper, JAX adapter trees, the port's AttnLoRA and
    FFNLoRA) on one set of weights."""
    jw, tw = make_wrapper_pair(steps=STEPS)
    cfg_j = junet.UNetConfig(**UNET_KW, lora_rank=RANK)
    attn, ffn = lora_trees(cfg_j, 300)
    cfg_t = tunet.UNetConfig(**UNET_KW, lora_rank=RANK)
    t_attn = bridge.load_lora(tunet.AttnLoRA(cfg_t), attn).requires_grad_(False)
    t_ffn = bridge.load_lora(tunet.FFNLoRA(cfg_t), ffn).requires_grad_(False)
    return jw, tw, (attn, ffn), (t_attn, t_ffn)


def pipelines(setup, ffn_adapter="comp_distill", **kw):
    """A JAX and a port pipeline over the wrappers' modules with the
    adapters (and `kw`, e.g. an ensemble) swapped in."""
    jw, tw, (attn, ffn), (t_attn, t_ffn) = setup
    jm = dataclasses.replace(jw.pipeline.m, attn_lora=attn, ffn_lora=ffn,
                             ffn_adapter=ffn_adapter, **kw.get("jax", {}))
    tm = dataclasses.replace(tw.pipeline.m, attn_lora=t_attn, ffn_lora=t_ffn,
                             ffn_adapter=ffn_adapter, **kw.get("port", {}))
    return JPipeline(jm, dtype=jnp.float32), DiffusionPipeline(tm, dtype=torch.float32)


def latents(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(1, 4, HW // 4, HW // 4).astype(np.float32)


def run_both(jp, tp, lat, jit=False, **kw):
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=STEPS, guidance_scale=4.0,
              height=HW, width=HW, **kw)
    # the non-DDIM loops call `_unet_eps` from Python: one XLA program a call
    with (mock.patch.object(jp, "_unet_eps", jax.jit(jp._unet_eps)) if jit
          else contextlib.nullcontext()):
        img_j = np.asarray(jp([PROMPT], latents=jnp.asarray(lat), **kw))
    img_t = tp([PROMPT], latents=torch.from_numpy(lat), **kw).numpy()
    return img_t, img_j


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("scheduler", ["ddim", "dpm++"])
def test_pipeline_with_adapters_matches_jax(setup, scheduler):
    """Non-zero attention and FFN adapters under DDIM and DPM-Solver++: the
    images equal JAX's to 1e-4 and stand apart from the unadapted ones."""
    _, tw, _, _ = setup
    jp, tp = pipelines(setup)
    lat = latents(31)
    img_t, img_j = run_both(jp, tp, lat, jit=scheduler != "ddim", scheduler=scheduler)
    assert img_t.shape == (1, 3, HW, HW) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)
    plain = tw.pipeline([PROMPT], latents=torch.from_numpy(lat), negative_prompt=NEGATIVE,
                        num_inference_steps=STEPS, guidance_scale=4.0, height=HW, width=HW,
                        scheduler=scheduler).numpy()
    assert rel_l2(img_t, plain) > ADAPTED_REL_L2


def test_adapters_run_in_the_unet_call(setup):
    """The runtime the pipeline builds (`_unet_eps`): the FFN adapter by its
    name, none of them without the modules; the unused q adapter is not
    computed outside a capture (XLA drops it as well)."""
    _, tw, _, (t_attn, t_ffn) = setup
    _, tp = pipelines(setup, ffn_adapter="recon_loss")
    rt = tp.m.runtime()
    assert (rt.use_attn_lora, rt.use_ffn_lora, rt.ffn_adapter) == (True, True, "recon_loss")
    assert tw.pipeline.m.runtime() == tunet.AttnRuntime()
    calls = []
    with mock.patch.object(tunet.DoRALinear, "forward", autospec=True,
                           side_effect=lambda *a: calls.append(a[0]) or a[1](a[2])):
        ctx = torch.zeros(2, 77, tp.m.text_encoder.cfg.hidden_size)
        tp.m.unet_eps(torch.zeros(2, 4, 8, 8), torch.tensor([10, 10]), ctx)
    assert sorted(id(m) for m in calls) == sorted(id(t_attn[k].out) for k in t_attn)


@pytest.mark.parametrize("weights", [(0.3, 0.7), None])
def test_ensemble_matches_jax(setup, weights):
    """Two UNets (the base and a second draw) weighted (0.3, 0.7), and at
    None (1/2 each), with the adapters: the DDIM images equal JAX's."""
    jw, tw, _, _ = setup
    unet2 = numpy_params(lambda k: junet.init_unet_params(k, jw.pipeline.m.unet_cfg), 301)
    unet2["conv_out"]["w"] = unet2["conv_out"]["w"] * 0.1
    t_unet2 = bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), unet2)
    jp, tp = pipelines(setup, jax=dict(unet=[jw.pipeline.m.unet, unet2], unet_weights=weights),
                       port=dict(unet=[tw.pipeline.m.unet, t_unet2], unet_weights=weights))
    img_t, img_j = run_both(jp, tp, latents(32))
    np.testing.assert_allclose(img_t, img_j, atol=IMAGE_ATOL)
    # the weighted sum of each UNet's prediction, in fp32
    x, t = torch.from_numpy(latents(33)), torch.tensor([500])
    ctx = torch.randn(1, 77, tw.pipeline.m.text_encoder.cfg.hidden_size,
                      generator=torch.Generator().manual_seed(0))
    w = np.asarray(weights or (0.5, 0.5), np.float32)
    w = w / w.sum()
    one = [dataclasses.replace(tp.m, unet=u).unet_eps(x, t, ctx) for u in tp.m.unet]
    np.testing.assert_allclose(tp.m.unet_eps(x, t, ctx).numpy(),
                               (w[0] * one[0] + w[1] * one[1]).numpy(), rtol=1e-6, atol=1e-7)


def test_ensemble_at_weights_one_and_zero_is_the_first_unet(setup):
    """At weights (1, 0) the weighted sum adds an exact 0: the image equals
    the first UNet's alone, bit for bit."""
    _, tw, _, _ = setup
    _, single = pipelines(setup)
    _, ens = pipelines(setup, port=dict(unet=[tw.pipeline.m.unet, tw.pipeline.m.unet],
                                        unet_weights=(1.0, 0.0)))
    kw = dict(negative_prompt=NEGATIVE, num_inference_steps=STEPS, height=HW, width=HW)
    lat = torch.from_numpy(latents(34))
    assert torch.equal(ens([PROMPT], latents=lat, **kw), single([PROMPT], latents=lat, **kw))


def batcher_pair(setup):
    jw, tw, (attn, ffn), (t_attn, t_ffn) = setup
    jm = dataclasses.replace(jw.pipeline.m, attn_lora=attn, ffn_lora=ffn)
    tm = dataclasses.replace(tw.pipeline.m, attn_lora=t_attn, ffn_lora=t_ffn)
    with mock.patch.object(jw.pipeline, "m", jm), mock.patch.object(tw.pipeline, "m", tm):
        return (jw.make_batcher(num_slots=2, height=HW, width=HW),
                tw.make_batcher(num_slots=2, height=HW, width=HW))


def test_batcher_with_adapters_matches_jax(setup):
    """Three requests (two subjects and a plain prompt) through 2 slots with
    the adapters: each image equals the JAX batcher's, and the port's
    one-shot pipeline with the same adapters."""
    jw, tw, _, _ = setup
    jb, tb = batcher_pair(setup)
    fids = np.random.RandomState(35).randn(2, 1, 512).astype(np.float32)
    adas = [(jw.prepare_adaface_embeddings(face_id_embs=jnp.asarray(f), update_text_encoder=False),
             tw.prepare_adaface_embeddings(face_id_embs=torch.from_numpy(f),
                                           update_text_encoder=False)) for f in fids]
    specs = [dict(prompt=PROMPT, seed=7, ada=adas[0]), dict(prompt="a cat", seed=8),
             dict(prompt=PROMPT, seed=9, ada=adas[1], guidance_scale=4.0)]
    jreqs, treqs = [], []
    for spec in specs:
        lat = torch.from_numpy(jax_latents(spec["seed"]))
        if "ada" not in spec:  # a plain prompt, no placeholder tokens
            jreqs.append(JRequest(**spec))
            treqs.append(Request(latents=lat, **spec))
            continue
        ada_j, ada_t = spec.pop("ada")
        jreqs.append(jw.make_request(ada_embs=ada_j, **spec))
        treqs.append(tw.make_request(ada_embs=ada_t, latents=lat, **spec))
    out_j = jb.generate_all(jreqs)
    out_t = tb.generate_all(treqs)
    _, tp = pipelines(setup)
    for i, req in enumerate(treqs):
        np.testing.assert_allclose(out_t[i].numpy(), out_j[i], atol=IMAGE_ATOL)
        if req.ada_embs is not None:
            tw.update_text_encoder_subj_embeddings(req.ada_embs)
        one = tp([req.prompt], negative_prompt="", num_inference_steps=STEPS,
                 guidance_scale=req.guidance_scale, height=HW, width=HW,
                 latents=req.latents[None])[0]
        np.testing.assert_allclose(out_t[i].numpy(), one.numpy(), atol=IMAGE_ATOL)


def test_batcher_step_with_adapters_reads_nothing_back(setup):
    """`test_step_reads_nothing_back` with the adapters: a step asks the
    device for no value, and advances only the active slot; the state
    buffers stay where they are."""
    _, tw, _, _ = setup
    _, tb = batcher_pair(setup)
    assert tb.m.attn_lora is not None and tb.m.ffn_lora is not None
    tb._admit(1, tw.make_request("a portrait", seed=3))
    before = tb._state.latents.clone()
    ptrs = [t.data_ptr() for t in tb._state.tensors()]
    refuse = mock.Mock(side_effect=AssertionError("a host read inside the step"))
    reads = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")
    with mock.patch.multiple(torch.Tensor, **{name: refuse for name in reads}):
        tb._step()
        tb._step()
    assert tb._state.step.tolist() == [0, 2]
    assert torch.equal(tb._state.latents[0], before[0])
    assert not torch.equal(tb._state.latents[1], before[1])
    assert [t.data_ptr() for t in tb._state.tensors()] == ptrs


def test_batcher_refuses_an_ensemble(setup):
    _, tw, _, _ = setup
    m = dataclasses.replace(tw.pipeline.m, unet=[tw.pipeline.m.unet] * 2)
    with mock.patch.object(tw.pipeline, "m", m), pytest.raises(ValueError, match="ensemble"):
        tw.make_batcher(num_slots=1, height=HW, width=HW)


def write_ckpt(path, t_attn, t_ffn, with_lora=True) -> str:
    """A checkpoint as the port's trainer writes it (`Trainer.save`:
    `lora_state_dicts` under `unet_lora_modules`)."""
    lora = lora_state_dicts({"attn_lora": t_attn, "ffn_lora": t_ffn}) if with_lora else None
    return save_adaface_ckpt(str(path), 7, {"joint": {}}, unet_lora_params=lora)


def test_load_unet_lora_weights_from_a_port_checkpoint(setup, tmp_path):
    """The wrapper loads the adapters the trainer wrote: fp32, frozen, on
    the pipeline's device, equal to the modules handed in; the batcher made
    after carries them; an absent FFN adapter name leaves the FFN adapters
    out; a checkpoint without `unet_lora_modules` raises."""
    _, tw, _, (t_attn, t_ffn) = setup
    m = tw.pipeline.m
    with mock.patch.object(tw.pipeline, "m", dataclasses.replace(m)):
        tw.load_unet_lora_weights(write_ckpt(tmp_path / "a", t_attn, t_ffn),
                                  ffn_adapter="unet_distill")
        got = tw.pipeline.m
        assert got.ffn_adapter == "unet_distill"
        for mine, ref in ((got.attn_lora, t_attn), (got.ffn_lora, t_ffn)):
            sd, want = mine.state_dict(), ref.state_dict()
            assert sorted(sd) == sorted(want)
            assert all(torch.equal(sd[k], want[k]) and sd[k].dtype == torch.float32 for k in sd)
            assert not any(p.requires_grad for p in mine.parameters())
        b = tw.make_batcher(num_slots=1, height=HW, width=HW)
        assert b.m.attn_lora is got.attn_lora and b.m.ffn_lora is got.ffn_lora

        ffn = t_ffn.state_dict()
        only = {k: v for k, v in ffn.items() if not k.startswith("comp_distill.")}
        state, _ = load_adaface_ckpt(str(tmp_path / "a"))
        state["unet_lora_modules"]["ffn_lora"] = only
        tw.pipeline.m = dataclasses.replace(m)
        save_adaface_ckpt(str(tmp_path / "b"), 7, {"joint": {}},
                          unet_lora_params=state["unet_lora_modules"])
        tw.load_unet_lora_weights(str(tmp_path / "b"))
        assert tw.pipeline.m.attn_lora is not None and tw.pipeline.m.ffn_lora is None
        with pytest.raises(ValueError, match="no unet_lora_modules"):
            tw.load_unet_lora_weights(write_ckpt(tmp_path / "c", t_attn, t_ffn, with_lora=False))
    assert tw.pipeline.m is m and m.attn_lora is None
