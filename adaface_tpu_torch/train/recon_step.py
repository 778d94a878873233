"""The recon iteration with the ArcFace identity losses.

Counterpart of `adaface_tpu/train/recon_step.py` (the reference's
`calc_normal_recon_loss`, `ddpm.py:2593-2883`, with `recon_multistep_denoise`,
`ddpm.py:1753-1917`), in its single-graph form:

1. a multi-step denoise (2 steps; 4 priming steps before them on pure
   noise) with CFG against the unconditional context. On images every step
   restarts from the input latents; on pure noise the steps chain with
   gradient. Each step also runs a no-grad denoise on the undistributed
   class context, whose prediction anchors the background.
2. each active step decodes its x0 prediction through the VAE decoder with
   gradient (the decoder's activations recomputed in the backward), detects
   faces on the host on a detached copy (`face_detect.detect_faces`: one
   read-back of the image a step), and takes the identity losses on the
   face crops: ArcFace alignment to the input's face, kept where it is
   under `recon_face_align_loss_thres`, the background faces' suppression,
   0.1-weighted undetected instances, and the detected box ∧ fg mask for
   the recon loss.
3. the sum as the reference weighs it: recon and recon_cls scaled by the
   per-step 0.1 no-face discount, mb-suppress ×0.2, the ArcFace alignment
   ×0.01 (×4 on pure noise), the background faces ×2 (×8 on pure noise).

The adversarial branch (`_adv_attacked_noise`) subtracts a scaled ArcFace
gradient of the input's decode from the next step's noise; its probability
is 0 in the reference's defaults.

Data-dependent gates stay tensors ({0, 1} weights), as in the JAX graph: the
host reads back only the decoded images for detection.

The same iteration also runs split in two phases (JAX `:148-180`,
`:550-687`): `recon_loss_fn_v2(collect_mode=True)` runs the denoise without
gradient, the subject, class and unconditional rows in one UNet call at
batch 3B, and returns each active step's decode downsized to
`collect_px_size` as uint8 NHWC frames, with the class and unconditional
predictions (and on pure noise the state after priming); the host detects
on the frames; the train phase reads the detections
(`batch["recon_face_dets"]`) and the predictions (`batch["recon_phase_a"]`)
in place of the inline detection and of two of its three UNet calls a
step. `make_two_phase_recon_step` runs the two in sequence;
`make_pipelined_recon_runner` overlaps them across steps (collect(N+1) is
issued before train(N), and the detection of step N runs on a worker thread
while the main thread issues train(N - 1) and collect(N + 1)), which is
`TrainerConfig.overlap_recon_collect`.

With the attention adapters trained (Stage 2) every UNet call of an
iteration on images runs them, gated by the batch's `recon_attn_lora_gate`
(the planner's 50% draw) on the subject and class rows and off on the
unconditional ones; on pure noise they stay off, and the FFN adapters are
never on (`recon_uses_ffn_lora` is False), as in JAX (`:226-248`, `:327`).

The UNet computes in `ReconStepConfig.compute_dtype` (bf16 on the card):
`train_step.unet_runner` casts a trained UNet's fp32 weights once per
evaluation. Random draws come from `Draws` in this order: the ada
embeddings' perturbation (three, when `training_perturb_prob` > 0), then
`sample_recon_rand`'s; a batch may carry `recon_rand` instead. None of them
is read back to the host. The two phases of a step take the same draws, as
JAX hands both the same key: the collect pass draws from a fork of the
step's stream (`Draws.fork`), the train phase from the stream itself.

Under data parallelism (`make_train_step(mesh=)`) the batch is a rank's
slice: the draws are the global batch's, sliced by their `batch_axis`; the
face gates and every mean are the global batch's (`parallel.collectives`),
and the adversarial branch attacks the global batch's first instances
(`_adv_attacked_noise`). Under tensor parallelism the tp ranks of a dp rank
run the same slice on the split towers; each detects faces on the host on
its own copy of the decoded images, checked equal bit for bit first
(`face_detect.detect_faces`).
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from adaface_tpu_torch.models.unet import AttnRuntime
from adaface_tpu_torch.models.vae import vae_decode
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.parallel.collectives import (active_mesh, gall, global_batch_size, gmax,
                                                    gmean, gsum)
from adaface_tpu_torch.train.face_detect import (FaceDetections, HostCopy, HostFaceDetector,
                                                 bbox_latent_mask, detect_faces, detect_frames,
                                                 map_bboxes_to_latent)
from adaface_tpu_torch.train.face_losses import (calc_arcface_align_loss,
                                                 calc_bg_faces_suppress_loss)
from adaface_tpu_torch.train.losses import (calc_prompt_emb_delta_loss,
                                            calc_recon_and_suppress_losses)
from adaface_tpu_torch.train.recon_multistep import calc_arcface_adv_grad
from adaface_tpu_torch.train.train_step import (TrainConfig, _encode_prompts_with_ada,
                                                compute_ada_embs, make_train_step, unet_runner)
from adaface_tpu_torch.utils.tensor import Draws, anneal_perturb_embedding, as_draws

Params = dict[str, Any]
ARCFACE_DIM = 512


@dataclasses.dataclass(frozen=True)
class ReconStepConfig:
    """Static knobs of the recon iteration (reference ctor defaults,
    `ddpm.py:86-140`)."""

    num_denoising_steps: int = 2
    num_priming_steps: int = 4  # only on pure noise
    on_pure_noise: bool = False
    cfg_scale: float = 2.0
    arcface_align_loss_weight: float = 0.01
    recon_face_align_loss_thres: float = 0.8
    recon_subj_mb_suppress_loss_weight: float = 0.2
    recon_bg_pixel_weight: float = 0.025
    recon_cls_weight: float = 1.0
    do_adv_attack: bool = False
    adv_bs: int = 2
    recon_adv_mod_mag_range: tuple[float, float] = (0.001, 0.003)
    max_bg_faces: int = 2
    # the collect pass's detection frames: each decode downsized to this
    # size (0: the decode's own) before the host reads it back; the
    # identity losses of the train phase still take the full decode
    collect_px_size: int = 256
    compute_dtype: str = "bfloat16"  # the UNet's; tests set float32

    @property
    def total_steps(self) -> int:
        return self.num_denoising_steps + (self.num_priming_steps if self.on_pure_noise else 0)


def sample_recon_rand(draws: Draws, x_start: torch.Tensor, schedule: DiffusionSchedule,
                      cfg: ReconStepConfig) -> Params:
    """The iteration's random draws, in this order: t0 [B] in [0.5, 0.8)·T
    ([0.7, 0.9)·T on pure noise), the steps' noises [S, B, 4, h, w], the
    relative timestep draws [S - 1, B], the pure-noise start [B, 4, h, w],
    the adversarial magnitude draw, and the adversarial dropout's uniforms
    [min(adv_bs, B), 512]."""
    b, dev = x_start.shape[0], x_start.device
    t_total, s = schedule.num_timesteps, cfg.total_steps
    lo, hi = (0.7, 0.9) if cfg.on_pure_noise else (0.5, 0.8)
    return {
        "t0": draws.integers((b,), int(t_total * lo), int(t_total * hi), dev, batch_axis=0),
        "noises": draws.normal((s, *x_start.shape), dev, batch_axis=1),
        "rel_ts": draws.uniforms((max(s - 1, 0), b), dev, batch_axis=1),
        "x_start0": draws.normal(x_start.shape, dev, batch_axis=0),
        "adv_uniform": draws.uniforms((), dev),
        # the first min(adv_bs, B) instances of the global batch
        "adv_dropout_u": draws.uniforms((min(cfg.adv_bs, global_batch_size(b)), ARCFACE_DIM),
                                        dev),
    }


def _next_t(t: torch.Tensor, rel: torch.Tensor, total_steps: int) -> torch.Tensor:
    """Power-law earlier-timestep chain (`ddpm.py:1853-1869`)."""
    p = float(np.power(max(total_steps - 1, 1), -0.3))
    tf = t.float()
    t_lb, t_ub = tf * (0.5 ** p), tf * (0.7 ** p)
    return ((t_ub - t_lb) * rel + t_lb).to(torch.int32).long()


def _stack_mean(xs: list) -> torch.Tensor:
    return torch.stack(xs).mean()


def resize_frames(px: torch.Tensor, size: int) -> torch.Tensor:
    """Images [B, C, H, W] resized to [B, C, size, size] in fp32 as
    `jax.image.resize(..., "linear")` resizes them (a triangle filter
    widened by the scale when it shrinks: bilinear with antialiasing), where
    H is larger than `size` (0: never)."""
    px = px.float()
    if size and px.shape[-1] > size:
        px = F.interpolate(px, size=(size, size), mode="bilinear", align_corners=False,
                           antialias=True)
    return px


def downsize_frames(px: torch.Tensor, size: int) -> torch.Tensor:
    """Decoded images [B, 3, H, W] in [-1, 1] → detection frames [B, size,
    size, 3] uint8 (JAX `:371-377`): `resize_frames`, then clipped to
    [0, 255] and truncated as `astype` does."""
    px = resize_frames(px, size)
    return torch.clamp((px.permute(0, 2, 3, 1) + 1.0) * 127.5, 0, 255).to(torch.uint8)


def recon_loss_fn_v2(params: Params, frozen: Params, batch: Params, schedule: DiffusionSchedule,
                     cfg: TrainConfig, draws=None, rcfg: ReconStepConfig = ReconStepConfig(),
                     detector: HostFaceDetector | None = None, collect_mode: bool = False):
    """The recon iteration's loss → (loss, metrics); with `collect_mode`,
    the collect pass → (0, {"recon_px": [S, B, ps, ps, 3] uint8 frames,
    "eps_cls", "eps_un": [S, B, 4, h, w], "decode_px": the decode's size,
    and on pure noise "x_primed", "t_primed"}), S the active steps; run it
    under `torch.no_grad()`.

    params: {"sbg", optional "unet", "attn_lora"}; frozen: {"unet", "text_encoder", and
    for the identity losses "vae" (a `VAEDecoder`) and "arcface"}. batch:
    x_start [B, 4, h, w]; img_prompt_embs [B, K, D]; prompt_ids, splice_map,
    prompt_emb_mask [4B, …]; uncond_ids [1, S]; img_mask, fg_mask
    [B, 1, h, w]; ref_images [B, 3, H, W] (the input pixels); ref_face_bboxes
    [B, 4] and ref_face_detected [B], host-detected on the inputs;
    recon_attn_lora_gate (0 or 1); optional recon_rand (see
    `sample_recon_rand`). The train phase of the two-phase step adds
    recon_face_dets ({fg [S, B, 4], det, conf [S, B], bgb [S, B, max_bg, 4],
    bgv [S, B, max_bg]}, read in place of the inline detection) and
    recon_phase_a (the collect pass's predictions, read in place of the
    class and unconditional calls and of the priming chain)."""
    x_start_in = batch["x_start"]
    dev, b, hw = x_start_in.device, x_start_in.shape[0], x_start_in.shape[-1]
    draws = as_draws(draws, dev)
    ada = compute_ada_embs(params, batch["img_prompt_embs"], cfg)
    if cfg.training_perturb_prob > 0:
        ada = anneal_perturb_embedding(draws, ada, 0.0, tuple(cfg.training_perturb_std_range),
                                       None, cfg.training_perturb_prob)
    ctx4, extras = _encode_prompts_with_ada(frozen, ada, batch, cfg, return_extras=True)
    ctx_subj = ctx4[:b]
    # the recon cls denoise takes the undistributed class context
    # (`extra_info['cls_single_emb']`, `ddpm.py:1545,2341`)
    ctx_cls = extras.get("cs_raw", ctx4[2 * b:3 * b])
    uncond = extras.get("uncond")
    if uncond is None:
        uncond = torch.zeros_like(ctx_subj[:1])
    uncond_b = uncond[:1].expand_as(ctx_subj)

    rand = batch.get("recon_rand") or sample_recon_rand(draws, x_start_in, schedule, rcfg)
    on_noise = rcfg.on_pure_noise
    n_prime = rcfg.num_priming_steps if on_noise else 0
    s_total = rcfg.total_steps
    x0 = rand["x_start0"] if on_noise else x_start_in
    img_mask = None if on_noise else batch.get("img_mask")
    fg_mask = torch.ones_like(batch["fg_mask"]) if on_noise else batch["fg_mask"]
    subj_mask = (batch["splice_map"][:b] >= 0).float()
    dt = getattr(torch, rcfg.compute_dtype)
    pre_dets = batch.get("recon_face_dets")
    have_arcface = ("arcface" in frozen and "vae" in frozen and not collect_mode
                    and rcfg.arcface_align_loss_weight > 0
                    and (detector is not None or pre_dets is not None))
    unet = unet_runner(params, frozen, dt)
    # the attention adapters' gate (the planner's draw), off on pure noise
    # and on the unconditional rows; no FFN adapter in recon (`:226-248`)
    use_attn_lora = "attn_lora" in params and not on_noise
    a_lora = params.get("attn_lora")
    gate = torch.as_tensor(batch.get("recon_attn_lora_gate", 0.0), dtype=torch.float32,
                           device=dev).expand(b)
    gate2 = torch.cat([gate, torch.zeros_like(gate)])
    rt_grad = AttnRuntime(capture=True, use_attn_lora=use_attn_lora)
    rt_nograd = AttnRuntime(use_attn_lora=use_attn_lora)

    def denoise_nograd(x_t, t, ctx, mask):
        with torch.no_grad():
            return unet(x_t.to(dt), t, ctx.to(dt), img_mask=mask, rt=rt_nograd,
                        attn_lora=a_lora,
                        attn_lora_gate=gate2 if use_attn_lora else None).to(x_t.dtype)

    align_contribs, align_keeps, stat_contribs, stat_gates = [], [], [], []
    bg_contribs, bg_gates, det_fracs = [], [], []
    recon_steps, recon_cls_steps, scale_steps, mb_steps, pred_l2s = [], [], [], [], []
    collected_px, collected_cls, collected_un = [], [], []
    decode_px = None
    # the collect pass's no-grad predictions, read in place of the class
    # and unconditional call (JAX `:260-279`); on pure noise its state after
    # the priming chain, which is no-grad throughout
    phase_a = batch.get("recon_phase_a")
    n_active = 0
    ones_b = torch.ones((b,), device=dev)
    x, t = x0, rand["t0"]
    start_i, primed = 0, None
    if phase_a is not None and n_prime > 0 and "x_primed" in phase_a:
        x, t, start_i = phase_a["x_primed"].detach(), phase_a["t_primed"], n_prime
    noise_next_adj = None  # the adversarially attacked noise of the next step
    for i in range(start_i, s_total):
        if collect_mode and on_noise and i == n_prime:
            primed = (x, t)
        noise_i = rand["noises"][i] if noise_next_adj is None else noise_next_adj
        noise_next_adj = None
        x_t = schedule.q_sample(x, t, noise_i)
        if i < n_prime:
            # priming alternates the cls and subject contexts, no grad (`:1783-1789`)
            ctx_p = ctx_cls if i % 2 == 0 else ctx_subj
            eps_p, eps_un = denoise_nograd(torch.cat([x_t, x_t]), torch.cat([t, t]),
                                           torch.cat([ctx_p, uncond_b]), None).chunk(2)
            x = schedule.predict_start_from_noise(
                x_t, t, eps_p * rcfg.cfg_scale - eps_un * (rcfg.cfg_scale - 1))
            if i < s_total - 1:
                t = _next_t(t, rand["rel_ts"][i], s_total)
            continue

        cap: dict = {}
        if collect_mode:
            # one no-grad call of [subject, class, unconditional] (JAX `:306-321`)
            with torch.no_grad():
                m3 = (torch.cat([img_mask, img_mask, torch.ones_like(img_mask)])
                      if img_mask is not None else None)
                eps3 = unet(torch.cat([x_t] * 3).to(dt), torch.cat([t] * 3),
                            torch.cat([ctx_subj, ctx_cls, uncond_b]).to(dt), img_mask=m3,
                            rt=rt_nograd, attn_lora=a_lora,
                            attn_lora_gate=torch.cat([gate2[:b], gate2])
                            if use_attn_lora else None).to(x_t.dtype)
            eps_subj, eps_cls, eps_un = eps3.chunk(3)
            collected_cls.append(eps_cls)
            collected_un.append(eps_un)
        else:
            # the subject-conditioned denoise, with gradient and capture
            eps_subj = unet(x_t.to(dt), t, ctx_subj.to(dt), img_mask=img_mask, capture=cap,
                            rt=rt_grad, subj_mask=subj_mask, attn_lora=a_lora,
                            attn_lora_gate=gate if use_attn_lora else None).to(x.dtype)
            if phase_a is not None:
                eps_cls = phase_a["eps_cls"][n_active].detach()
                eps_un = phase_a["eps_un"][n_active].detach()
            else:
                m2 = (torch.cat([img_mask, torch.ones_like(img_mask)]) if img_mask is not None
                      else None)
                eps_cls, eps_un = denoise_nograd(torch.cat([x_t, x_t]), torch.cat([t, t]),
                                                 torch.cat([ctx_cls, uncond_b]), m2).chunk(2)
        n_active += 1
        if rcfg.cfg_scale > 1 and (s_total > 1 or on_noise):
            s_ = rcfg.cfg_scale
            eps_subj_cfg = eps_subj * s_ - eps_un * (s_ - 1.0)
            eps_cls_cfg = eps_cls * s_ - eps_un * (s_ - 1.0)
        else:
            eps_subj_cfg, eps_cls_cfg = eps_subj, eps_cls
        x_recon = schedule.predict_start_from_noise(x_t, t, eps_subj_cfg)
        pred_l2s.append(gmean(eps_subj_cfg.float() ** 2))

        if collect_mode and "vae" in frozen:
            # the detection frames, downsized on the device (JAX `:360-377`)
            with torch.no_grad():
                px_full = vae_decode(frozen["vae"], x_recon)
            decode_px = px_full.shape[-1]
            collected_px.append(downsize_frames(px_full, rcfg.collect_px_size))
        if have_arcface:
            # identity losses on the decoded recon (`:2700-2789`)
            recon_px = vae_decode(frozen["vae"], x_recon)
            if pre_dets is not None:
                k = len(det_fracs)  # the active step's index
                fg_bb, det = pre_dets["fg"][k], pre_dets["det"][k]
                bg_bb, bg_val = pre_dets["bgb"][k], pre_dets["bgv"][k]
            else:
                fg_bb, det, _conf, bg_bb, bg_val = detect_faces(recon_px, detector,
                                                                rcfg.max_bg_faces)
            det = det * batch.get("ref_face_detected", ones_b)
            la, _lfg, _ = calc_arcface_align_loss(
                frozen["arcface"], batch["ref_images"], recon_px, batch["ref_face_bboxes"],
                fg_bb, det, fg_faces_grad_mask_ratios=(1.0, 0.3))
            lbg, bg_any = calc_bg_faces_suppress_loss(frozen["arcface"], recon_px, bg_bb,
                                                      bg_val)
            g_any = (gsum(det.sum()) > 0).float()
            thres = rcfg.recon_face_align_loss_thres
            keep = g_any if thres <= 0 else g_any * (la < thres).float()
            align_contribs.append(la * keep)
            align_keeps.append(keep)
            stat_contribs.append(la * g_any)
            stat_gates.append(g_any)
            bg_contribs.append(lbg)
            bg_gates.append(bg_any)
            det_fracs.append(gmean(det))
            # instance weight 0.1 where undetected; the whole step's 0.1 when
            # nothing was (`:2736-2768`)
            found = g_any > 0
            inst_w = torch.where(found, torch.where(det > 0, 1.0, 0.1), torch.ones_like(det))
            scale_steps.append(torch.where(found, 1.0, 0.1))
            bb_mask = bbox_latent_mask(map_bboxes_to_latent(fg_bb, recon_px.shape[-1], hw),
                                       det, (hw, hw))
            fg2 = torch.where(found, fg_mask * bb_mask, fg_mask)
        else:
            inst_w = ones_b
            scale_steps.append(torch.ones((), device=dev))
            fg2 = fg_mask
        if not collect_mode:
            # img_mask None: the blank augmentation pixels are regularized as
            # background (`ddpm.py:2770-2775`)
            lr, lrc, lmb = calc_recon_and_suppress_losses(
                noise_i, eps_subj_cfg, eps_cls_cfg, inst_w, cap.get("attn", {}), subj_mask,
                None, fg2, rcfg.recon_bg_pixel_weight, on_noise)
            recon_steps.append(lr)
            recon_cls_steps.append(lrc)
            mb_steps.append(lmb.to(dev))

        if i < s_total - 1:  # chain to the next step (`:1815-1827`)
            t_next = _next_t(t, rand["rel_ts"][i], s_total)
            if rcfg.do_adv_attack and not on_noise and "arcface" in frozen and "vae" in frozen:
                noise_next_adj = _adv_attacked_noise(frozen, batch, rand, rand["noises"][i + 1],
                                                     rcfg, hw)
            x = x_recon if on_noise else x_start_in
            t = t_next

    if collect_mode:
        empty = torch.zeros((0,), device=dev)
        out = {"recon_px": torch.stack(collected_px) if collected_px else empty,
               "eps_cls": torch.stack(collected_cls) if collected_cls else empty,
               "eps_un": torch.stack(collected_un) if collected_un else empty,
               "decode_px": decode_px}
        if primed is not None:
            out["x_primed"], out["t_primed"] = primed
        return torch.zeros((), device=dev), out

    arc_scale = 4.0 if on_noise else 1.0  # `:2804-2808`
    loss = torch.zeros((), device=dev)
    metrics: Params = {}
    if have_arcface:
        keeps = torch.stack(align_keeps)
        loss_align = (torch.stack(align_contribs).sum() / (keeps.sum() + 1e-6)) \
            * (keeps.sum() > 0)
        loss = loss + loss_align * rcfg.arcface_align_loss_weight * arc_scale
        gates = torch.stack(stat_gates)
        metrics["loss_arcface_align_recon"] = torch.stack(stat_contribs).sum() / (gates.sum()
                                                                                  + 1e-6)
        bgg = torch.stack(bg_gates)
        loss_bg = (torch.stack(bg_contribs).sum() / (bgg.sum() + 1e-6)) * (bgg.sum() > 0)
        # ×2 (×8 on pure noise), not times the ArcFace weight (`:2826-2834`)
        loss = loss + loss_bg * 2.0 * arc_scale
        metrics["loss_bg_faces_suppress"] = loss_bg
        metrics["recon_face_detected_frac"] = _stack_mean(det_fracs)
        metrics["recon_face_align_kept_frac"] = keeps.mean()
    scales = torch.stack(scale_steps)
    loss_mb = _stack_mean(mb_steps)
    if not on_noise:
        loss = loss + (torch.stack(recon_steps) * scales).mean()
        loss = loss + loss_mb * rcfg.recon_subj_mb_suppress_loss_weight
        metrics["loss_recon"] = _stack_mean(recon_steps)
    # recon_cls is added on pure noise too (`:2871-2879`)
    loss = loss + (torch.stack(recon_cls_steps) * scales).mean() * rcfg.recon_cls_weight
    metrics["loss_recon_cls"] = _stack_mean(recon_cls_steps)
    metrics["loss_mb_suppress"] = loss_mb
    metrics["pred_l2"] = _stack_mean(pred_l2s)
    loss_delta = calc_prompt_emb_delta_loss(ctx4, batch.get("prompt_emb_mask"))
    loss = loss + cfg.prompt_emb_delta_weight * loss_delta
    metrics["loss_prompt_emb_delta"] = loss_delta
    metrics["loss"] = loss
    return loss, metrics


def _adv_attacked_noise(frozen: Params, batch: Params, rand: Params, noise_next: torch.Tensor,
                        rcfg: ReconStepConfig, hw: int) -> torch.Tensor:
    """The next step's noise minus the adversarial ArcFace gradient of the
    input's decode (`ddpm.py:1879-1907`) on the global batch's first
    nb = min(adv_bs, B) instances, masked to the face box, scaled so its
    magnitude lands in recon_adv_mod_mag_range (at most ×10); nothing when a
    face of those inputs went undetected (`:2545-2548`).

    Under data parallelism a rank attacks the first nb instances it holds
    (perhaps none: it still joins every reduction). The magnitude's max,
    the fg-masked mean and the detection gate are the nb instances'
    (`gmax`, `gsum`, `gall`), and the gradient is that of the mean over all
    nb embeddings, so each rank adjusts the rows the single process would."""
    b = batch["x_start"].shape[0]
    nb = min(rcfg.adv_bs, global_batch_size(b))
    mesh = active_mesh()
    lo = mesh.dp_rank * b if mesh is not None else 0
    n = min(max(nb - lo, 0), b)  # this rank's attacked rows
    dev = noise_next.device
    ok = gall(batch.get("ref_face_detected", torch.ones((b,), device=dev))[:n])
    if n > 0:
        bb_px = batch["ref_face_bboxes"][:n]
        bb_lat = map_bboxes_to_latent(bb_px, batch["ref_images"].shape[-1], hw)
        adv = calc_arcface_adv_grad(frozen["arcface"], frozen["vae"], batch["x_start"][:n],
                                    bb_lat, bb_px, rand["adv_dropout_u"][lo:lo + n],
                                    dropout_p=0.3,
                                    count=None if mesh is None else nb * ARCFACE_DIM).detach()
    else:
        adv = noise_next[:0]
    fg = batch["fg_mask"][:n]
    fg_mean = gsum((adv.abs() * fg).sum()) / (gsum(fg.sum()) * noise_next.shape[1] + 1e-6)
    adv_mag = torch.sqrt(gmax(adv.abs()) * fg_mean)
    # the magnitude's draw stays on the device: in fp64, as on the host
    lo_mag, hi_mag = rcfg.recon_adv_mod_mag_range
    u = torch.as_tensor(rand["adv_uniform"], device=dev).double()
    mod_mag = (lo_mag + (hi_mag - lo_mag) * u).float()
    scale = torch.clamp((adv_mag + 1e-6).reciprocal() * mod_mag, max=10.0)
    return torch.cat([noise_next[:n] - adv * scale * ok.to(adv.dtype), noise_next[n:]])


def make_recon_loss_fn(rcfg: ReconStepConfig, detector: HostFaceDetector | None):
    """The recon loss with its static config and host detector bound, in
    `make_train_step`'s calling convention."""

    def loss_fn(params, frozen, batch, schedule, cfg, draws=None):
        return recon_loss_fn_v2(params, frozen, batch, schedule, cfg, draws, rcfg=rcfg,
                                detector=detector)

    return loss_fn


def detections_to_batch(dets: FaceDetections, s_steps: int, b: int, max_bg: int = 2,
                        device=None) -> Params:
    """Host detections over the [S·B] flattened frames → the
    `recon_face_dets` batch entry ([S, B, ...] fp32 tensors on `device`; to
    the card through pinned memory without a wait)."""
    arrays = {"fg": (dets.fg_bboxes, (s_steps, b, 4)), "det": (dets.detected, (s_steps, b)),
              "conf": (dets.confidences, (s_steps, b)),
              "bgb": (dets.bg_bboxes, (s_steps, b, max_bg, 4)),
              "bgv": (dets.bg_valid, (s_steps, b, max_bg))}
    dev = torch.device(device if device is not None else "cpu")
    out = {}
    for key, (a, shape) in arrays.items():
        host = torch.from_numpy(np.ascontiguousarray(a, np.float32).reshape(shape))
        out[key] = (host.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda"
                    else host.to(dev))
    return out


def make_two_phase_recon_step(rcfg: ReconStepConfig, detector, frozen: Params,
                              schedule: DiffusionSchedule, cfg: TrainConfig, progress=None):
    """The recon step in two phases (JAX `:570-637`): the collect pass
    (no gradient), host detection on its frames, and the train step
    (`make_train_step`) on the batch with the detections and the collect's
    predictions. → run(state, batch, draws) → (state, metrics), with the
    phases as `run.collect(state, batch, draws)` → the collect's output (its
    frames' host copy started), `run.detect_on(out, batch)` → the train
    phase's batch, and `run.train(state, batch, draws)`; collect and train
    are handed the same draws and take the same values from them. The
    result equals the inline step's where the decode is no larger than
    `collect_px_size` (the frames are then the inline detection's pixels)."""
    def loss_fn(params, frozen_, batch, schedule_, cfg_, draws=None):
        return recon_loss_fn_v2(params, frozen_, batch, schedule_, cfg_, draws, rcfg=rcfg)

    step = make_train_step(loss_fn, frozen, schedule, cfg)  # detections from the batch
    note = progress if progress is not None else (lambda msg: None)

    def collect(state, batch, draws=None):
        forked = as_draws(draws, batch["x_start"].device).fork()
        with torch.no_grad():
            _, out = recon_loss_fn_v2(state.params, frozen, batch, schedule, cfg, forked,
                                      rcfg=rcfg, detector=None, collect_mode=True)
        out["recon_px"] = HostCopy(out["recon_px"])
        return out

    def detect_on(out, batch):
        """Host detection on the collect's frames → the train phase's batch,
        the boxes scaled back to the decode's size."""
        frames = out["recon_px"].numpy()  # [S, B, ps, ps, 3] uint8
        s_steps, b = frames.shape[0], frames.shape[1]
        dets = detect_frames(detector, frames.reshape(s_steps * b, *frames.shape[2:]),
                             out["decode_px"] / frames.shape[2])
        phase_a = {k: out[k] for k in ("eps_cls", "eps_un", "x_primed", "t_primed") if k in out}
        return dict(batch, recon_phase_a=phase_a,
                    recon_face_dets=detections_to_batch(dets, s_steps, b,
                                                        getattr(detector, "max_bg", 2),
                                                        batch["x_start"].device))

    def run(state, batch, draws=None):
        draws = as_draws(draws, batch["x_start"].device)
        out = collect(state, batch, draws)
        note("collect done (recon denoise decoded)")
        return step(state, detect_on(out, batch), draws)

    run.collect, run.detect_on, run.train = collect, detect_on, step
    return run


class PipelinedReconRunner:
    """The two-phase recon step pipelined across consecutive iterations
    (JAX `make_pipelined_recon_runner`, `:640-687`): `push(state, batch,
    draws)` issues collect(N+1), hands its detection to a worker thread,
    then trains step N on its detections and returns N's (state, metrics)
    (None at the first push); `flush(state)` trains the last pending step.
    collect(N+1) is issued before train(N), so it reads the parameters from
    before N's update: the detections, and where the attention adapters or
    the UNet train the no-grad anchors, lag one optimizer step. At a
    learning rate of 0 the results are the sequential step's.

    The detection of step N waits on its frames' CUDA event on the worker
    (OpenCV releases the GIL while it detects) while the main thread issues
    train(N - 1) and collect(N + 1): the detection's readback drains
    nothing. A train phase that raises leaves its step pending. `close()`
    ends the worker."""

    def __init__(self, two_phase_run):
        self.run = two_phase_run
        self._pending = None  # (the detection's future, draws)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="recon-detect")

    def push(self, state, batch, draws=None):
        draws = as_draws(draws, batch["x_start"].device)
        out = self.run.collect(state, batch, draws)
        nxt = (self._pool.submit(self.run.detect_on, out, batch), draws)
        result = self._train(state, self._pending) if self._pending is not None else None
        self._pending = nxt
        return result

    def flush(self, state):
        if self._pending is None:
            return None
        result = self._train(state, self._pending)
        self._pending = None
        return result

    def _train(self, state, pending):
        future, draws = pending
        # a fork, so that a train phase run again after an interrupt draws alike
        return self.run.train(state, future.result(), draws.fork())

    def close(self) -> None:
        """Drop the pending step and end the worker (after its detection)."""
        self._pending = None
        self._pool.shutdown(wait=True)


def make_pipelined_recon_runner(two_phase_run) -> PipelinedReconRunner:
    """`PipelinedReconRunner` over a `make_two_phase_recon_step` step."""
    return PipelinedReconRunner(two_phase_run)
