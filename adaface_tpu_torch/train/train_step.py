"""The training step, the unet-distill loss and the single-step recon loss.

Counterpart of `adaface_tpu/train/train_step.py`. The unet-distill
iteration (`calc_unet_distill_loss`, `ddpm.py:2984-3184`): the
SubjBasisGenerator(s) map the teacher's image-prompt embeddings to ada
embeddings, which are spliced into the 4-block prompts (ss ‖ sc ‖ cs ‖ cc)
and encoded by the frozen CLIP text tower; the student UNet denoises the
teacher's x_t (one step, or the S steps of the teacher's chain folded into
the batch) with the subject-single context and is held to the teacher's
noise predictions, plus the prompt-embedding delta loss. `recon_loss_fn` is
the single-step recon loss (`calc_normal_recon_loss` without the identity
losses); the multi-step recon iteration is `recon_step.recon_loss_fn_v2`.

- The trainable state is the SubjBasisGenerator(s): a module, or a list for
  the joint encoder (one per sub-encoder, ada tokens concatenated). Their
  prompt2token_proj token and position tables are frozen, as the JAX
  package keeps them in the buffers. With `unfreeze_unet` (full-UNet
  finetuning, `v1-finetune-unet.yaml`) the UNet joins it as `params["unet"]`
  and the loss functions take it in place of `frozen["unet"]`. The UNet's
  adapters (`models.unet.AttnLoRA`, `FFNLoRA`) join it as
  `params["attn_lora"]` / `params["ffn_lora"]`: the unet-distill loss runs
  the FFN adapter "unet_distill", the single-step recon loss both adapters
  ("recon_loss"). The CLIP text tower stays frozen; gradients flow through
  it, not into it.
- Compute dtype: the unet-distill loss and `recon_loss_fn` follow the UNet's
  weights (bf16 on the card: the flash and GroupNorm Functions' backward
  kernels run there); the recon iteration computes in its configured dtype,
  and `unet_runner` casts a trained UNet's fp32 weights to it once per
  evaluation, differentiably, as the JAX package casts each weight at use.
  The SubjBasisGenerator and the CLIP text tower stay fp32.
- `make_train_step` runs the loss, `backward`, the gradient's global norm
  and the optimizer (`optimizers.MultiSteps`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from adaface_tpu_torch.core.device import fp32_convolutions
from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models.clip import CLIP_L_TEXT, CLIPTextConfig
from adaface_tpu_torch.models.unet import AttnRuntime, UNetConfig
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.parallel.collectives import data_parallel, gmean
from adaface_tpu_torch.parallel.mesh import ShardedDraws, all_reduce_grads, all_reduce_metrics
from adaface_tpu_torch.text.embedding_manager import (apply_merge_map,
                                                      distribute_embedding_to_M_tokens,
                                                      splice_ada_embeddings)
from adaface_tpu_torch.train.losses import (calc_prompt_emb_delta_loss,
                                            calc_recon_and_suppress_losses)
from adaface_tpu_torch.train.optimizers import MultiSteps, global_norm
from adaface_tpu_torch.utils.tensor import anneal_perturb_embedding, as_draws

Params = dict[str, Any]
# the prompt2token_proj tables that are buffers, not parameters, in the JAX
# SubjBasisGenerator
FROZEN_SBG_PARAMS = ("clip.token_embedding", "clip.position_embedding")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    unet: UNetConfig = UNetConfig()
    sbg: SubjBasisConfig | tuple = SubjBasisConfig()
    clip_text: CLIPTextConfig = CLIP_L_TEXT
    recon_bg_pixel_weight: float = 0.1
    prompt_emb_delta_weight: float = 1e-4
    mb_suppress_weight: float = 0.1
    unet_distill_weight: float = 8.0
    clip_skip_weights: tuple = (0.25, 0.75)  # last-2-layer CLIP skip
    training_perturb_std_range: tuple = (0.05, 0.1)
    training_perturb_prob: float = 0.5


@dataclasses.dataclass
class State:
    params: Params  # {"sbg": a SubjBasisGenerator or a list; optional "unet", "attn_lora",
    #                  "ffn_lora"}
    optimizer: MultiSteps
    step: int = 0


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


LORA_KEYS = ("attn_lora", "ffn_lora")


def trainable_parameters(params: Params) -> list[nn.Parameter]:
    """The parameters the optimizer moves, in a fixed order: the
    SubjBasisGenerators' (their frozen tables left out), then the UNet's
    where it trains, then the attention and the FFN adapters'; marks them
    trainable and the frozen tables not."""
    out = []
    for sbg in _as_list(params["sbg"]):
        for name, p in sbg.named_parameters():
            p.requires_grad_(name not in FROZEN_SBG_PARAMS)
            if p.requires_grad:
                out.append(p)
    for key in ("unet", *LORA_KEYS):
        if key in params:
            out.extend(p.requires_grad_(True) for p in params[key].parameters())
    return out


def trainable_state_dicts(params: Params):
    """The trainable parameters of each SubjBasisGenerator as a state dict
    (a list of them for a joint encoder), as checkpoints hold them."""
    dicts = [{name: p.detach() for name, p in sbg.named_parameters()
              if name not in FROZEN_SBG_PARAMS} for sbg in _as_list(params["sbg"])]
    return dicts if isinstance(params["sbg"], (list, tuple)) else dicts[0]


def lora_state_dicts(params: Params) -> dict | None:
    """The adapters' state dicts by kind (`unet_lora_modules` of a
    checkpoint), or None where none trains."""
    out = {key: {n: t.detach() for n, t in params[key].state_dict().items()}
           for key in LORA_KEYS if key in params}
    return out or None


def compute_ada_embs(params: Params, img_prompt_embs: torch.Tensor, cfg: TrainConfig,
                     out_id_embs_cfg_scale: float = 1.0,
                     enable_static_img_suffix_embs: bool = False) -> torch.Tensor:
    """Image-prompt embeddings [B, ΣK_i, D] → ada embeddings through the
    SubjBasisGenerator(s), each on its own token segment, concatenated."""
    outs, off = [], 0
    for sbg in _as_list(params["sbg"]):
        n = sbg.cfg.num_id_vecs
        outs.append(sbg(img_prompt_embs[:, off:off + n],
                        out_id_embs_cfg_scale=out_id_embs_cfg_scale, is_face=True,
                        enable_static_img_suffix_embs=enable_static_img_suffix_embs))
        off += n
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _encode_prompts_with_ada(frozen: Params, ada_embs: torch.Tensor, batch: Params,
                             cfg: TrainConfig, return_extras: bool = False):
    """Embed the 4-block prompts with the ada embeddings spliced into the
    subject blocks, through the frozen CLIP text tower; the class blocks get
    the merged class embedding distributed over the subject's positions
    against the unconditional prompt. With `return_extras` also the class
    blocks before distribution and the unconditional context."""
    te = frozen["text_encoder"]
    ids = batch["prompt_ids"].long()
    splice_map = batch["splice_map"]
    table = te.token_embedding
    # ids of added placeholder tokens lie past the table: clamped, as a JAX
    # gather clamps (the ada embeddings replace them anyway)
    base = table[ids.clamp(max=table.shape[0] - 1)]
    zeros = torch.zeros_like(ada_embs)
    embs = splice_ada_embeddings(base, torch.cat([ada_embs, ada_embs, zeros, zeros]), splice_map)
    if batch.get("merge_map") is not None:
        embs = apply_merge_map(embs, batch["merge_map"])
    skip_w = batch.get("clip_skip_weights")
    if skip_w is None:
        skip_w = torch.tensor(cfg.clip_skip_weights, device=embs.device)
    ctx = te(ids, input_embs=embs, skip_weights=skip_w)
    extras = {}
    if batch.get("uncond_ids") is not None:
        uncond = te(batch["uncond_ids"].long(), skip_weights=skip_w)
        # both class blocks take the subject-single block's positions
        ss_map = splice_map.chunk(4)[0]
        ss, sc, cs, cc = ctx.chunk(4)
        extras = {"cs_raw": cs, "cc_raw": cc, "uncond": uncond}
        ctx = torch.cat([ss, sc, distribute_embedding_to_M_tokens(cs, ss_map, uncond),
                         distribute_embedding_to_M_tokens(cc, ss_map, uncond)])
    return (ctx, extras) if return_extras else ctx


def _params_dtype(module: nn.Module) -> torch.dtype:
    """The floating dtype of a module's parameters (the UNet's compute
    dtype follows its weights)."""
    for p in module.parameters():
        if p.is_floating_point():
            return p.dtype
    return torch.float32


def unet_runner(params: Params, frozen: Params, dtype: torch.dtype):
    """The loss's UNet (`params["unet"]` where it trains, else
    `frozen["unet"]`) as a callable computing in `dtype`. Where its weights
    are of another dtype (the fp32 masters of a finetuned UNet), each is
    cast once for all the calls of this evaluation and the module runs on the
    casts (`torch.func.functional_call`); the casts are differentiable, so
    the gradients reach the masters."""
    unet = params.get("unet", frozen["unet"])
    if _params_dtype(unet) == dtype:
        return unet
    cast = {name: p.to(dtype) for name, p in unet.named_parameters()}
    return lambda *a, **kw: torch.func.functional_call(unet, cast, a, kw)


def recon_loss_fn(params: Params, frozen: Params, batch: Params, schedule: DiffusionSchedule,
                  cfg: TrainConfig, draws=None):
    """The single-step recon loss (`recon_loss_fn`, `calc_normal_recon_loss`
    without the identity losses) → (loss, metrics). batch: x_start, noise
    [B, 4, h, w], t [B]; img_prompt_embs [B, K, D]; prompt_ids, splice_map,
    prompt_emb_mask [4B, …]; img_mask, fg_mask [B, 1, h, w]; face_detected
    [B]. The subject-single context conditions the denoise (the last up
    block's cross-attention probabilities captured for the mb-suppress loss),
    the class-single one a no-grad prediction for the background. Draws:
    the ada embeddings' perturbation (three, when `training_perturb_prob` >
    0)."""
    ada = compute_ada_embs(params, batch["img_prompt_embs"], cfg)
    if cfg.training_perturb_prob > 0:
        ada = anneal_perturb_embedding(as_draws(draws, ada.device), ada, 0.0,
                                       tuple(cfg.training_perturb_std_range), None,
                                       cfg.training_perturb_prob)
    ctx4 = _encode_prompts_with_ada(frozen, ada, batch, cfg)
    b = batch["x_start"].shape[0]
    x_t = schedule.q_sample(batch["x_start"], batch["t"], batch["noise"])
    subj_mask = (batch["splice_map"][:b] >= 0).float()
    unet = params.get("unet", frozen["unet"])
    dt = _params_dtype(unet)
    cap: dict = {}
    # the iteration's named adapters (`train_step.py:209-211` of the JAX package)
    rt = AttnRuntime(capture=True, use_attn_lora="attn_lora" in params,
                     use_ffn_lora="ffn_lora" in params, ffn_adapter="recon_loss")
    eps_pred = unet(x_t.to(dt), batch["t"], ctx4[:b].to(dt), img_mask=batch.get("img_mask"),
                    capture=cap, rt=rt, subj_mask=subj_mask, attn_lora=params.get("attn_lora"),
                    ffn_lora=params.get("ffn_lora")).to(x_t.dtype)
    with torch.no_grad():
        eps_cls = unet(x_t.to(dt), batch["t"], ctx4[2 * b:3 * b].to(dt)).to(x_t.dtype)
    loss_recon, loss_recon_cls, loss_mb = calc_recon_and_suppress_losses(
        batch["noise"], eps_pred, eps_cls, batch.get("face_detected"), cap.get("attn", {}),
        subj_mask, batch.get("img_mask"), batch.get("fg_mask"), cfg.recon_bg_pixel_weight)
    loss_mb = loss_mb.to(eps_pred.device)
    loss_delta = calc_prompt_emb_delta_loss(ctx4, batch.get("prompt_emb_mask"))
    loss = (loss_recon + 0.1 * loss_recon_cls + cfg.mb_suppress_weight * loss_mb
            + cfg.prompt_emb_delta_weight * loss_delta)
    return loss, {"loss": loss, "loss_recon": loss_recon, "loss_recon_cls": loss_recon_cls,
                  "loss_mb_suppress": loss_mb, "loss_prompt_emb_delta": loss_delta}


def unet_distill_loss_fn(params: Params, frozen: Params, batch: Params,
                         schedule: DiffusionSchedule, cfg: TrainConfig, draws=None):
    """→ (loss, metrics). batch: x_start [B, 4, h, w] and, from the teacher,
    either teacher_x_ts [S, B, 4, h, w], teacher_ts [S, B] and
    teacher_noise_preds [S, B, 4, h, w] (the S steps fold into one UNet call
    of batch S·B), or noise, t [B] and teacher_noise_pred; prompt_ids,
    splice_map [4B, 77] and prompt_emb_mask [4B, 77, 1]; uncond_ids."""
    ada = compute_ada_embs(params, batch["img_prompt_embs"], cfg,
                           enable_static_img_suffix_embs=True)
    ctx4 = _encode_prompts_with_ada(frozen, ada, batch, cfg)
    b = batch["x_start"].shape[0]
    unet = params.get("unet", frozen["unet"])
    dt = _params_dtype(unet)
    # the FFN adapter "unet_distill" where the adapters train (JAX `:302`, `:322`)
    lora = dict(rt=AttnRuntime(use_ffn_lora="ffn_lora" in params, ffn_adapter="unet_distill"),
                ffn_lora=params.get("ffn_lora"))
    if "teacher_x_ts" in batch:
        x_ts, ts = batch["teacher_x_ts"], batch["teacher_ts"]
        s = x_ts.shape[0]
        eps = unet(x_ts.reshape(s * b, *x_ts.shape[2:]).to(dt), ts.reshape(s * b),
                   ctx4[:b].repeat(s, 1, 1).to(dt), **lora)
        target = batch["teacher_noise_preds"].reshape(s * b, *x_ts.shape[2:])
    else:
        x_t = schedule.q_sample(batch["x_start"], batch["t"], batch["noise"])
        eps = unet(x_t.to(dt), batch["t"], ctx4[:b].to(dt), **lora)
        target = batch["teacher_noise_pred"]
    loss_distill = gmean((eps.float() - target.detach().float()) ** 2)
    loss_delta = calc_prompt_emb_delta_loss(ctx4, batch.get("prompt_emb_mask"))
    loss = cfg.unet_distill_weight * loss_distill + cfg.prompt_emb_delta_weight * loss_delta
    return loss, {"loss": loss, "loss_unet_distill": loss_distill,
                  "loss_prompt_emb_delta": loss_delta}


def make_train_step(loss_fn: Callable, frozen: Params, schedule: DiffusionSchedule,
                    cfg: TrainConfig, mesh=None):
    """→ step(state, batch, draws) → (state, metrics): the loss, its
    backward into the trainable parameters, their gradient's global norm
    (before accumulation and clipping), and one `MultiSteps.step()`. The
    state's modules and optimizer are updated in place.

    With a `parallel.mesh.Mesh` of dp > 1 ranks, `batch` is this rank's
    slice (`shard_train_batch`) and the step is the single-device step on
    the global batch: the loss's means are global (`data_parallel`), its
    draws are taken for the global batch and sliced (`ShardedDraws`), and
    the gradients are summed over the ranks before the norm and the
    optimizer, so every rank moves its parameters alike."""

    def step(state: State, batch: Params, draws=None):
        params = trainable_parameters(state.params)
        for p in params:
            p.grad = None
        if mesh is not None and mesh.dp > 1:
            draws = ShardedDraws(as_draws(draws, batch["x_start"].device), mesh)
        with data_parallel(mesh):
            loss, metrics = loss_fn(state.params, frozen, batch, schedule, cfg, draws)
        # the backward of the face models' fp32 convolutions (ArcFace in the
        # recon loss) without TF32, as their forward runs; bf16 ones are unmoved
        with fp32_convolutions():
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None and mesh.dp > 1:
            all_reduce_grads(params, mesh)
            metrics = all_reduce_metrics(metrics, mesh)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics["grad_norm"] = global_norm(grads)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def init_state(params: Params, optimizer: MultiSteps) -> State:
    return State(params, optimizer, 0)
