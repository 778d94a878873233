"""The unet-distill training step (stage 1).

Counterpart of `adaface_tpu/train/train_step.py` for unet-distill
iterations (`calc_unet_distill_loss`, `ddpm.py:2984-3184`): the
SubjBasisGenerator(s) map the teacher's image-prompt embeddings to ada
embeddings, which are spliced into the 4-block prompts (ss ‖ sc ‖ cs ‖ cc)
and encoded by the frozen CLIP text tower; the frozen student UNet denoises
the teacher's x_t (one step, or the S steps of the teacher's chain folded
into the batch) with the subject-single context and is held to the
teacher's noise predictions, plus the prompt-embedding delta loss.

- The trainable state is the SubjBasisGenerator(s): a module, or a list for
  the joint encoder (one per sub-encoder, ada tokens concatenated). Their
  prompt2token_proj token and position tables are frozen, as the JAX
  package keeps them in the buffers. The UNet and the CLIP text tower are
  frozen modules in `frozen`; gradients flow through them, not into them.
- Compute dtype follows the UNet's weights (bf16 on the card: the flash and
  GroupNorm Functions' backward kernels run there); the SubjBasisGenerator
  and the CLIP text tower stay fp32.
- `make_train_step` runs the loss, `backward`, the gradient's global norm
  and the optimizer (`optimizers.MultiSteps`). The recon iteration's loss
  waits for the recon slice (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from adaface_tpu_torch.id2ada.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaface_tpu_torch.models.clip import CLIP_L_TEXT, CLIPTextConfig
from adaface_tpu_torch.models.unet import UNetConfig
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.text.embedding_manager import (apply_merge_map,
                                                      distribute_embedding_to_M_tokens,
                                                      splice_ada_embeddings)
from adaface_tpu_torch.train.losses import calc_prompt_emb_delta_loss
from adaface_tpu_torch.train.optimizers import MultiSteps, global_norm

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
    params: Params  # {"sbg": SubjBasisGenerator or a list of them}
    optimizer: MultiSteps
    step: int = 0


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def trainable_parameters(params: Params) -> list[nn.Parameter]:
    """The SubjBasisGenerators' parameters the optimizer moves, in a fixed
    order; marks them trainable and the frozen tables not."""
    out = []
    for sbg in _as_list(params["sbg"]):
        for name, p in sbg.named_parameters():
            p.requires_grad_(name not in FROZEN_SBG_PARAMS)
            if p.requires_grad:
                out.append(p)
    return out


def trainable_state_dicts(params: Params):
    """The trainable parameters of each SubjBasisGenerator as a state dict
    (a list of them for a joint encoder), as checkpoints hold them."""
    dicts = [{name: p.detach() for name, p in sbg.named_parameters()
              if name not in FROZEN_SBG_PARAMS} for sbg in _as_list(params["sbg"])]
    return dicts if isinstance(params["sbg"], (list, tuple)) else dicts[0]


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
    unet = frozen["unet"]
    dt = _params_dtype(unet)
    if "teacher_x_ts" in batch:
        x_ts, ts = batch["teacher_x_ts"], batch["teacher_ts"]
        s = x_ts.shape[0]
        eps = unet(x_ts.reshape(s * b, *x_ts.shape[2:]).to(dt), ts.reshape(s * b),
                   ctx4[:b].repeat(s, 1, 1).to(dt))
        target = batch["teacher_noise_preds"].reshape(s * b, *x_ts.shape[2:])
    else:
        x_t = schedule.q_sample(batch["x_start"], batch["t"], batch["noise"])
        eps = unet(x_t.to(dt), batch["t"], ctx4[:b].to(dt))
        target = batch["teacher_noise_pred"]
    loss_distill = ((eps.float() - target.detach().float()) ** 2).mean()
    loss_delta = calc_prompt_emb_delta_loss(ctx4, batch.get("prompt_emb_mask"))
    loss = cfg.unet_distill_weight * loss_distill + cfg.prompt_emb_delta_weight * loss_delta
    return loss, {"loss": loss, "loss_unet_distill": loss_distill,
                  "loss_prompt_emb_delta": loss_delta}


def make_train_step(loss_fn: Callable, frozen: Params, schedule: DiffusionSchedule,
                    cfg: TrainConfig):
    """→ step(state, batch, draws) → (state, metrics): the loss, its
    backward into the trainable parameters, their gradient's global norm
    (before accumulation and clipping), and one `MultiSteps.step()`. The
    state's modules and optimizer are updated in place."""

    def step(state: State, batch: Params, draws=None):
        params = trainable_parameters(state.params)
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(state.params, frozen, batch, schedule, cfg, draws)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def init_state(params: Params, optimizer: MultiSteps) -> State:
    return State(params, optimizer, 0)
