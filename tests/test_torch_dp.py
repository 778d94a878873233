"""Data parallelism of the port on the CPU (`parallel/mesh.py`, sync-BN):
two gloo ranks, one process each (one `torch.multiprocessing` spawn for the
file, `tests/torch_dp_workers.py`).

- `shard_batch` against the placements of JAX's `shard_batch` on a 4-device
  CPU mesh, the step-major keys and the replicated leaves included, and the
  port's split of the prompt blocks;
- sync-BN (`fused_bn_act(group=)`) against JAX's `shard_map` case
  (`tests/test_fused_norm.py:67-79`) at 2 ranks, and its gradients against
  the autodiff of the full batch's forward (the ranks' scale and bias
  gradients summed), slope 0.01 and 0;
- `Trainer.fit` through `train_torch.build_trainer` (Stage 1, tiny widths,
  `trainer.dp=2`, batch 4 split over the ranks, accumulation 2) on a
  subject folder that mixes PNG, JPEG and BMP photos read through the
  native item pipeline, against the same fit in one process: the ranks'
  losses and parameters equal to each other bit for bit and to the single
  process's to 1e-5 after 4 micro-steps (2 updates);
- `make_mesh(tp=2)` and `make_mesh` outside `torchrun` raise.
The train steps are in `tests/test_torch_dp_distill.py` and
`tests/test_torch_dp_recon.py`.
"""

from __future__ import annotations

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaface_tpu.ops import fused_norm as jnorm
from adaface_tpu.parallel import mesh as jmesh
from adaface_tpu_torch.parallel import mesh as tmesh
from adaface_tpu_torch.utils.image import write_png
from tests.test_torch_models import UNET_KW, VAE_KW
from tests.test_torch_train import TRAIN_TEXT_KW, assert_rel
from tests.torch_dp_workers import dp_cases, fit_case, run_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "data" / "images"
FIT_STEPS = 4

BN_SLOPES = {"bn_leaky": 0.01, "bn_relu": 0.0}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sync-BN and both ranks' results of each case, one spawn."""
    refs, payload = {}, {}
    rs = np.random.RandomState(5)
    for name, slope in BN_SLOPES.items():
        x = rs.randn(16, 32).astype(np.float32) * 2 + 0.5
        scale = rs.uniform(0.5, 1.5, 32).astype(np.float32)
        bias = rs.randn(32).astype(np.float32) * 0.3
        g = rs.randn(16, 32).astype(np.float32)
        refs[name] = jax_sync_bn(x, scale, bias, g, slope)
        payload[name] = {"kind": "bn", "slope": slope, **{
            k: torch.from_numpy(v) for k, v in (("x", x), ("scale", scale), ("bias", bias),
                                                ("g", g))}}
    tmp = tmp_path_factory.mktemp("dp")
    fit = {"kind": "fit", "config": str(REPO / "configs/stage1-distill-arc2face.yaml"),
           "data": mixed_photos(tmp / "photos"), "log": str(tmp / "log"), "steps": FIT_STEPS,
           "text_kw": TRAIN_TEXT_KW, "unet_kw": UNET_KW, "vae_kw": VAE_KW,
           "overrides": ["trainer.image_size=64", "trainer.prefetch=0"]}
    payload["fit"] = fit
    ranks = run_ranks(dp_cases, payload, str(tmp))
    refs["fit"] = fit_case(dict(fit, log=str(tmp / "log_single")))
    return refs, ranks


def mixed_photos(root: pathlib.Path) -> str:
    """One subject of 64x64-or-smaller photos in three formats: two JPEG
    and two BMP fixtures, two PNGs."""
    d = root / "subject"
    d.mkdir(parents=True)
    for name in ("baseline_420.jpg", "progressive_444.jpg", "rgb24.bmp", "paletted8.bmp"):
        shutil.copy(FIXTURES / name, d / name)
    rs = np.random.RandomState(3)
    for i in range(2):
        write_png(d / f"p{i}.png", rs.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    return str(root)


def jax_sync_bn(x, scale, bias, g, slope):
    """JAX's sync-BN over a 2-device axis (`shard_map`, as
    `tests/test_fused_norm.py:67-79`), and the gradients of the full batch's
    forward by autodiff."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))

    def local(xl):
        return jnorm.fused_bn_act(xl, jnp.asarray(scale), jnp.asarray(bias), slope=slope,
                                  axis_name="dp", use_pallas=False)

    y = shard_map(local, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))(jnp.asarray(x))

    def plain(x_, s_, b_):
        mean = x_.mean(0)
        var = (x_ * x_).mean(0) - mean * mean
        z = (x_ - mean) * jax.lax.rsqrt(var + 1e-5) * s_ + b_
        return jnp.where(z >= 0, z, z * slope)

    _, vjp = jax.vjp(plain, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(jnp.asarray(g))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dscale": np.asarray(ds),
            "dbias": np.asarray(db)}


@pytest.mark.parametrize("name", sorted(BN_SLOPES))
def test_sync_bn_2_ranks_match_jax_shard_map(runs, name):
    refs, ranks = runs
    ref = refs[name]
    y = torch.cat([ranks[0][name]["y"], ranks[1][name]["y"]]).numpy()
    np.testing.assert_allclose(y, ref["y"], atol=1e-5, rtol=1e-5)
    dx = torch.cat([ranks[0][name]["dx"], ranks[1][name]["dx"]]).numpy()
    np.testing.assert_allclose(dx, ref["dx"], atol=1e-5, rtol=1e-5)
    for key in ("dscale", "dbias"):
        total = (ranks[0][name][key] + ranks[1][name][key]).numpy()
        np.testing.assert_allclose(total, ref[key], atol=1e-4, rtol=1e-5)


def test_trainer_fit_2_ranks_matches_one_process(runs):
    refs, ranks = runs
    ref, r0, r1 = refs["fit"], ranks[0]["fit"], ranks[1]["fit"]
    assert len(ref["losses"]) == FIT_STEPS
    assert r0["losses"] == r1["losses"]
    assert all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"]))
    assert_rel(r0["losses"], ref["losses"], what="losses")
    for i, (p, q) in enumerate(zip(r0["params"], ref["params"])):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"parameter {i}")
    update = lambda r: torch.cat([(p - b).ravel() for p, b in zip(r["params"], r["before"])])  # noqa: E731
    assert update(ref).norm() > 0
    assert (update(r0) - update(ref)).norm() <= 1e-4 * update(ref).norm()


def test_sync_bn_single_rank_is_plain_bn():
    """Without a group the Function is the plain BN it was."""
    from adaface_tpu_torch.ops.fused_norm import fused_bn_act, fused_bn_act_plain

    x = torch.randn(12, 8, generator=torch.Generator().manual_seed(0))
    s, b = torch.rand(8) + 0.5, torch.randn(8)
    assert torch.equal(fused_bn_act(x, s, b), fused_bn_act_plain(x, s, b))


def test_shard_batch_matches_jax_placements():
    """Each leaf's slice on each of 4 ranks against the shard JAX places on
    device r of a dp=4 mesh: leading axis, the step-major axis 1, the
    phase-A eps on axis 1, and replication where an axis does not divide."""
    rs = np.random.RandomState(0)
    leaves = {
        "x_start": rs.randn(8, 4, 2, 2), "t": rs.randint(0, 9, (8,)),
        "teacher_x_ts": rs.randn(3, 8, 4, 2), "teacher_ts": rs.randint(0, 9, (3, 8)),
        "teacher_noise_preds": rs.randn(2, 8, 3), "teacher_noise_pred": rs.randn(8, 4, 2),
        "odd": rs.randn(6, 2), "step_major_odd": None, "clip_skip_weights": rs.rand(3),
        "scalar": np.float32(0.5), "nested": {"a": rs.randn(4, 2), "b": rs.randn(5)},
        "recon_phase_a": {"eps_pred": rs.randn(2, 8, 3), "x0": rs.randn(8, 3),
                          "eps_odd": rs.randn(2, 6)},
    }
    leaves["teacher_ts"] = rs.randint(0, 9, (3, 6))  # 6 % 4: replicated
    del leaves["step_major_odd"]
    leaves = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32 if np.asarray(a).dtype.kind == "f" else np.int32),
        leaves)
    devices = jax.devices()[:4]
    mesh = jmesh.make_mesh(dp=4, tp=1, devices=devices)
    jplaced = jmesh.shard_batch(jax.tree_util.tree_map(jnp.asarray, leaves), mesh)
    tbatch = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), leaves)
    for rank in range(4):
        mine = tmesh.shard_batch(tbatch, rank, 4)

        def check(path, jarr, tval):
            shard = [s for s in jarr.addressable_shards if s.device == devices[rank]][0]
            np.testing.assert_array_equal(np.asarray(tval), np.asarray(shard.data),
                                          err_msg=f"rank {rank} {path}")

        for key, val in jplaced.items():
            if isinstance(val, dict):
                for k2, v2 in val.items():
                    check(f"{key}/{k2}", v2, mine[key][k2])
            else:
                check(key, val, mine[key])


def test_shard_train_batch_splits_prompt_blocks():
    """The port's train batch: each of the 4 prompt blocks split on its own,
    the named leaves whole."""
    ids = torch.arange(8 * 3).reshape(8, 3)  # 4 blocks of a batch of 2
    batch = {"x_start": torch.zeros(2, 1), "prompt_ids": ids,
             "clip_skip_weights": torch.ones(2), "uncond_ids": torch.ones(1, 3)}
    mesh = tmesh.Mesh(dp=2, rank=1, local_rank=1)
    out = tmesh.shard_train_batch(batch, mesh)
    assert torch.equal(out["prompt_ids"], ids[1::2])
    assert torch.equal(out["clip_skip_weights"], batch["clip_skip_weights"])
    assert out["x_start"].shape == (1, 1)


def test_make_mesh_refuses_tensor_parallelism_and_no_group(monkeypatch):
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tmesh.make_mesh(dp=2, tp=2)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.make_mesh(dp=2)


@pytest.mark.parametrize("shape", [(1000, 64), (802816 // 64, 64), (16, 128)])
def test_bn_sums_mode_plain_version(shape):
    """`bn_stats`' sums mode in plain PyTorch (`bn_sums_chunked`): its fp64
    sums folded to mean and rstd are `bn_stats_chunked`'s bits, and the sums
    are x's; the kernel's wrapper takes no CPU tensor."""
    from adaface_tpu_torch.ops import fused_norm as N

    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1)) * 2 + 0.5
    plan = N.bn_plan(shape[0], shape[1], torch.float32, 132)
    sums = N.bn_sums_chunked(x, plan)
    assert sums.dtype == torch.float64 and sums.shape == (2, shape[1])
    mean, rstd = N.bn_finalize_sums(sums, shape[0], 1e-5)
    want = N.bn_stats_chunked(x, 1e-5, plan)
    assert torch.equal(mean, want[0]) and torch.equal(rstd, want[1])
    xd = x.double()
    np.testing.assert_allclose(sums.numpy(), torch.stack([xd.sum(0), (xd * xd).sum(0)]).numpy(),
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        N.bn_stats_sums(x)
