"""The ranks of the port's data- and tensor-parallel CPU tests: `run_ranks`
spawns `world` processes (`torch.multiprocessing`), joins them in a gloo
group through a file in the test's temporary directory, runs
`work(rank, payload)` in each and returns what each rank returned
(`start_ranks` / `join_ranks`: the same in two halves).

No JAX here: the ranks import only torch and the port; the tests compute
the JAX references in the parent process.
"""

from __future__ import annotations

import contextlib
import copy
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, work, tmp: str, world: int) -> None:
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=world)
    try:
        torch.save(work(rank, payload), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(work, payload, tmp: str, world: int = 2):
    """`run_ranks` without the wait: the caller computes beside the ranks,
    then `join_ranks`. The payload reaches the ranks through a file (each
    loads its own copy: handing hundreds of tensors to each process in
    shared memory took tens of seconds)."""
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    return mp.spawn(_entry, args=(work, str(tmp), world), nprocs=world, join=False)


def join_ranks(ctx, tmp: str, world: int) -> list:
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_ranks(work, payload, tmp: str, world: int = 2) -> list:
    return join_ranks(start_ranks(work, payload, tmp, world), tmp, world)


def _step_case(case: dict, mesh) -> dict:
    """One train step of `case` on this rank's slice of its global batch →
    the metrics, the gradients the optimizer was given and the parameters
    after the update, by module."""
    from adaface_tpu_torch.ops.schedules import DiffusionSchedule
    from adaface_tpu_torch.parallel.mesh import shard_train_batch
    from adaface_tpu_torch.train import optimizers as topt
    from adaface_tpu_torch.train import train_step as tstep

    params, frozen = case["params"], case["frozen"]
    opt = topt.make_optimizer("cadamw", tstep.trainable_parameters(params), case["lr"],
                              warmup_steps=0, total_steps=10)
    grads = {}
    real_step = opt.step

    def capture():
        for part in params:
            grads[part] = {n: p.grad.clone() for n, p in params[part].named_parameters()
                           if p.grad is not None}
        return real_step()

    opt.step = capture
    step = tstep.make_train_step(make_loss_fn(case), frozen, DiffusionSchedule.create(),
                                 case["cfg"], mesh=mesh)
    batch = case["batch"] if mesh is None else shard_train_batch(case["batch"], mesh)
    draws = case.get("draws")
    if isinstance(draws, int):
        draws = torch.Generator().manual_seed(draws)
    state, metrics = step(tstep.init_state(params, opt), batch, draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "params": {part: {n: t.detach().clone() for n, t in m.state_dict().items()}
                       for part, m in state.params.items()}}


class SmoothFace(torch.nn.Module):
    """`tests/test_torch_recon.py:SmoothTower` without its JAX half: a
    smooth stand-in for ArcFace, [B, 1, 128, 128] → tanh(4x4-averaged
    pixels · W) [B, 512] (a random ArcFace's kinks would move the gradients
    of two fp32 summation orders apart by about 1e-4)."""

    def __init__(self, seed: int = 42):
        super().__init__()
        import numpy as np

        w = np.random.RandomState(seed).randn(32 * 32, 512).astype(np.float32) / 32.0
        self.w = torch.nn.Parameter(torch.from_numpy(w), requires_grad=False)

    def forward(self, x):
        return torch.tanh(torch.nn.functional.avg_pool2d(x, 4).flatten(1) @ self.w)


def fixed_faces(img):
    """Three faces whatever the pixels (`tests/test_torch_recon_step.py`)."""
    import numpy as np

    return [(np.array([8, 6, 52, 50], np.float32), 0.9),
            (np.array([0, 30, 24, 62], np.float32), 0.8),
            (np.array([40, 0, 63, 20], np.float32), 0.7)]


def confident_faces(img):
    """A confident foreground face and a background one, whatever the pixels
    (`tests/test_torch_comp.py:fixed_faces`)."""
    import numpy as np

    return [(np.array([8, 6, 52, 50], np.float32), 1.0),
            (np.array([0, 30, 24, 62], np.float32), 0.8)]


def make_loss_fn(case: dict):
    from adaface_tpu_torch.train import recon_step as trecon
    from adaface_tpu_torch.train import train_step as tstep
    from adaface_tpu_torch.train.face_detect import HostFaceDetector

    kind = case["loss"]
    if kind == "unet_distill":
        return tstep.unet_distill_loss_fn
    if kind == "recon":
        return tstep.recon_loss_fn
    if kind == "recon_v2":
        return trecon.make_recon_loss_fn(case["rcfg"], HostFaceDetector(detector_fn=fixed_faces))
    if kind == "comp":
        from adaface_tpu_torch.train import comp_step as tcomp

        return tcomp.make_comp_loss_fn(case["ccfg"], HostFaceDetector(detector_fn=confident_faces))
    raise ValueError(kind)


def adv_noise_case(case: dict, mesh) -> torch.Tensor:
    """`recon_step._adv_attacked_noise` on this rank's slice of the case's
    batch and next-step noise (the whole of both where `mesh` is None) →
    the adjusted noise rows."""
    from adaface_tpu_torch.parallel.collectives import data_parallel
    from adaface_tpu_torch.parallel.mesh import shard_batch
    from adaface_tpu_torch.train import recon_step as trecon

    batch, noise = case["batch"], case["noise"]
    if mesh is not None:
        batch = shard_batch(batch, mesh.dp_rank, mesh.dp)
        noise = shard_batch(noise, mesh.dp_rank, mesh.dp)
    with data_parallel(mesh):
        return trecon._adv_attacked_noise(case["frozen"], batch, case["rand"], noise,
                                          case["rcfg"], noise.shape[-1])


def _bn_case(case: dict, rank: int, world: int) -> dict:
    from adaface_tpu_torch.ops.fused_norm import fused_bn_act

    n = case["x"].shape[0] // world
    x = case["x"][rank * n:(rank + 1) * n].clone().requires_grad_(True)
    scale = case["scale"].clone().requires_grad_(True)
    bias = case["bias"].clone().requires_grad_(True)
    y = fused_bn_act(x, scale, bias, case["slope"], group=dist.group.WORLD)
    y.backward(case["g"][rank * n:(rank + 1) * n])
    return {"y": y.detach(), "dx": x.grad, "dscale": scale.grad, "dbias": bias.grad}


@contextlib.contextmanager
def tiny_stack(text_kw: dict, unet_kw: dict, vae_kw: dict):
    """`train_torch.build_trainer` at tiny widths within, as
    `tests/test_torch_cli.py` patches it: the towers' constructors, the
    Arc2Face encoder's configs and the tokenizer; restored after."""
    from adaface_tpu_torch.id2ada import face_id_to_ada_prompt as fid
    from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig
    from adaface_tpu_torch.models import clip as tclip
    from adaface_tpu_torch.models import unet as tunet
    from adaface_tpu_torch.models import vae as tvae
    from adaface_tpu_torch.text import tokenizer

    text_cfg = tclip.CLIPTextConfig(**text_kw)
    real_enc, real_unet = fid.create_id2ada_prompt_encoder, tunet.UNet2DConditionModel
    real_clip, real_vae = tclip.CLIPTextModel, tvae.VAEEncoder
    real_tok = tokenizer.default_tokenizer
    fid.create_id2ada_prompt_encoder = lambda name, gen, tok, device, **kw: real_enc(
        name, gen, tok, device, text_cfg=text_cfg, sbg_cfg=SubjBasisConfig(clip=text_cfg), **kw)
    tunet.UNet2DConditionModel = lambda: real_unet(tunet.UNetConfig(**unet_kw))
    tclip.CLIPTextModel = lambda: real_clip(text_cfg)
    tvae.VAEEncoder = lambda: real_vae(tvae.VAEConfig(**vae_kw))
    tokenizer.default_tokenizer = tokenizer.CLIPTokenizer.character_fallback
    try:
        yield
    finally:
        fid.create_id2ada_prompt_encoder, tunet.UNet2DConditionModel = real_enc, real_unet
        tclip.CLIPTextModel, tvae.VAEEncoder = real_clip, real_vae
        tokenizer.default_tokenizer = real_tok


def fit_case(case: dict) -> dict:
    """`train_torch.build_trainer` and `Trainer.fit` at tiny widths on the
    CPU, with `trainer.dp` set where a process group is up → the losses
    and the trainable parameters after."""
    import train_torch

    argv = ["--base", case["config"], "--data_roots", case["data"], "--log_dir", case["log"],
            "--device", "cpu", "--max_steps", str(case["steps"]), *case["overrides"]]
    if dist.is_initialized():
        argv.append(f"trainer.dp={dist.get_world_size()}")
    cfg, args = train_torch.parse_args(argv)
    with tiny_stack(case["text_kw"], case["unet_kw"], case["vae_kw"]):
        trainer, dataset, start = train_torch.build_trainer(cfg, args)
    losses = []
    post = trainer._post_step

    def watch(step, flags, metrics):
        losses.append(float(metrics["loss"]))
        post(step, flags, metrics)

    trainer._post_step = watch
    before = [p.detach().clone() for p in trainer.state.optimizer.params]
    trainer.fit(dataset, num_steps=case["steps"], start_step=start)
    return {"losses": losses, "before": before,
            "params": [p.detach().clone() for p in trainer.state.optimizer.params]}


def dp_cases(rank: int, payload: dict) -> dict:
    """Every case of `payload` on this rank (its own copy, loaded from the
    file `start_ranks` wrote): train steps on the mesh of the group, and
    sync-BN calls on the group."""
    from adaface_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size())
    out = {}
    for name, case in payload.items():
        if case["kind"] == "step":
            out[name] = _step_case(case, mesh)
        elif case["kind"] == "adv_noise":
            out[name] = adv_noise_case(case, mesh)
        elif case["kind"] == "fit":
            case["log"] = os.path.join(case["log"], f"rank{rank}")
            out[name] = fit_case(case)
        else:
            out[name] = _bn_case(case, rank, mesh.dp)
    return out


def tp_cases(rank: int, payload: dict) -> dict:
    """Every case of `payload` on this rank: the case's dp × tp mesh of the
    group (the world holds dp · tp ranks), its frozen UNet and text encoder
    cut by `shard_params`, a "comp_unet" state dict cut by the UNet's map and
    loaded into it, one train step; a case's "fault" (`chip_compare.tp_fault`)
    planted around the cut and the step. A case without "tp": its step in
    one process, the "comp_unet" weights loaded whole."""
    import chip_compare
    from adaface_tpu_torch.parallel.mesh import make_mesh, shard_params

    out = {}
    for name, case in payload.items():
        case = copy.deepcopy(case)  # its own towers: a cut is in place
        if case.get("tp") is None:
            if "comp_unet" in case:
                case["frozen"]["unet"].load_state_dict(case["comp_unet"])
            out[name] = _step_case(case, None)
            continue
        mesh = make_mesh(case["dp"], case["tp"])
        with chip_compare.tp_fault(case.get("fault")):
            frozen = case["frozen"]
            for part in ("unet", "text_encoder"):
                shard_params(frozen[part], mesh)
            if "comp_unet" in case:
                shard_params(case["comp_unet"], mesh, like=frozen["unet"])
                frozen["unet"].load_state_dict(case["comp_unet"])
            out[name] = _step_case(case, mesh)
    return out
