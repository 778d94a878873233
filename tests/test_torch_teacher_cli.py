"""`scripts/test_img_prompt_model_torch.py`'s teacher chain against
`scripts/test_img_prompt_model.py` run in-process, fp32, at tiny widths:
the JAX script's `main` with its towers' configs and initialisers patched
to tiny numpy-drawn trees (carried into the port by `core/bridge.py`), its
encoder factory to the tiny Arc2Face of `tests/test_torch_id2ada.py`, its
bfloat16 to float32, and its image writer to a recorder. The port's
`teacher_images` takes JAX's draws of the same seed in the script's order
(the random-ID path's embedding, x_start, the noise, the teacher's chain).
Image prompts and decoded images to 1e-4 relative L2, through the
random-ID path and through a subject's photos (the hash face backend on
both sides).
"""

from __future__ import annotations

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adaface_tpu.id2ada import face_id_to_ada_prompt as jfid
from adaface_tpu.models import unet as junet
from adaface_tpu.models import vae as jvae
from adaface_tpu_torch.core import bridge
from adaface_tpu_torch.models import unet as tunet
from adaface_tpu_torch.models import vae as tvae
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.utils.image import write_png
from adaface_tpu_torch.utils.tensor import Draws
from tests.test_torch_eval_cli import REPO, jax_script
from tests.test_torch_id2ada import encoders  # noqa: F401 (fixture)
from tests.test_torch_models import UNET_KW, VAE_KW, numpy_params
from tests.test_torch_models import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import _teacher_draws, rel_l2

sys.path.insert(0, str(REPO / "scripts"))
import test_img_prompt_model_torch as twin  # noqa: E402

N, STEPS, SIZE, SEED = 2, 3, 64, 5


class Float32Numpy(types.ModuleType):
    """`jax.numpy` with `bfloat16` standing for float32."""

    def __init__(self):
        super().__init__("jnp_fp32")
        self.bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def towers():
    ucfg, vcfg = junet.UNetConfig(**UNET_KW), jvae.VAEConfig(**VAE_KW)
    up = numpy_params(lambda k: junet.init_unet_params(k, ucfg), 71)
    vp = numpy_params(lambda k: jvae.init_vae_params(k, vcfg), 72)
    unet = bridge.load(tunet.UNet2DConditionModel(tunet.UNetConfig(**UNET_KW)), up)
    vae = bridge.load(tvae.VAEDecoder(tvae.VAEConfig(**VAE_KW)), bridge.vae_decoder_tree(vp))
    return (ucfg, vcfg, up, vp), (unet, vae)


def run_jax_script(monkeypatch, towers, jarc, argv):
    (ucfg, vcfg, up, vp), _ = towers
    mod = jax_script("test_img_prompt_model")
    monkeypatch.setattr(junet, "SD15_UNET", ucfg)
    monkeypatch.setattr(junet, "init_unet_params", lambda key, cfg: up)
    monkeypatch.setattr(jvae, "SD_VAE", vcfg)
    monkeypatch.setattr(jvae, "init_vae_params", lambda key, cfg: vp)
    monkeypatch.setattr(jfid, "create_id2ada_prompt_encoder", lambda name, key: jarc)
    monkeypatch.setattr(mod, "jnp", Float32Numpy())
    seen = {}

    def record(img, out_dir, prefix="sample"):
        seen["images"] = np.asarray(img)
        return [f"{out_dir}/{prefix}_{i:03d}.png" for i in range(len(img))]

    monkeypatch.setattr(mod, "save_images", record)
    monkeypatch.setattr(sys, "argv", ["test_img_prompt_model.py", *argv])
    mod.main()
    return seen["images"]


@pytest.mark.parametrize("source", ["randface", "subject"])
def test_teacher_chain_matches_jax_script(monkeypatch, tmp_path, encoders, towers, source):
    (jarc, _), (tarc, _) = encoders
    _, (unet, vae) = towers
    argv = ["--num_images", str(N), "--num_steps", str(STEPS), "--size", str(SIZE),
            "--seed", str(SEED), "--out_dir", str(tmp_path / "out")]
    photos = None
    if source == "randface":
        argv.append("--randface")
    else:
        rs = np.random.RandomState(73)
        photos = [rs.randint(0, 256, (48, 48, 3), np.uint8) for _ in range(2)]
        (tmp_path / "subj").mkdir()
        for i, p in enumerate(photos):
            write_png(str(tmp_path / "subj" / f"{i}.png"), p)
        argv += ["--subject", str(tmp_path / "subj")]
    want = run_jax_script(monkeypatch, towers, jarc, argv)

    key = jax.random.PRNGKey(SEED)
    s = SIZE // 8
    handed = [np.asarray(jax.random.normal(jax.random.split(key)[0], (N, 512)))] \
        if source == "randface" else []
    k1, k2, k3 = jax.random.split(key, 3)
    handed += [np.asarray(jax.random.normal(k1, (N, 4, s, s))),
               np.asarray(jax.random.normal(k2, (N, 4, s, s)))]
    handed += _teacher_draws(k3, STEPS, N, (N, 4, s, s))
    draws = Draws(handed=handed)
    embs, got = twin.teacher_images(tarc, unet, vae, DiffusionSchedule.create(), draws, N,
                                    STEPS, SIZE, photos)
    assert not draws._handed  # every draw taken, in order
    jembs = jarc.get_img_prompt_embs(
        id_batch_size=N, rng=key, **({} if photos is None else dict(
            images=photos, avg_at_stage="id_emb")))[2]
    assert rel_l2(embs.numpy(), np.asarray(jembs)) <= 1e-4
    hw = s * vae.cfg.spatial_scale
    assert got.shape == want.shape == (N, 3, hw, hw)
    assert np.isfinite(got.numpy()).all() and got.numpy().std() > 0
    assert rel_l2(got.numpy(), want) <= 1e-4
