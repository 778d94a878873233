"""The Stage-2 compositional-distillation iteration.

Counterpart of `adaface_tpu/train/comp_step.py` (the reference's comp
branch of `p_losses`, `ddpm.py:1923-2092` and `:3190-3600`), at
`stage="full"`:

1. `encode_comp_prompts`: the 5-block prompt batch [ss ‖ sc ‖ sc_rep ‖ cs ‖
   cc] through the frozen CLIP text tower with the ada embeddings of the
   batch's first instance spliced into the subject blocks (sc_rep with the
   fixed CLIP-skip weights), the distributed class contexts of the delta
   loss, and the unconditional context.
2. `prime_comp_x_start`: no-gradient priming of a subject-single and a
   class-mix start (mix 0.5 + r / 2) from fresh noise at t in [0.7, 0.9)·T,
   3 or 4 CFG steps at a scale drawn from [2, 4).
3. `comp_distill_denoise`: 4 steps of the 4-block batch [ss ‖ sc ‖ sc_rep ‖
   mc] (mc = sc·(1 − r) + cc·r) from t in [0.45, 0.65)·T, CFG 2.5 against
   the unconditional context, the chain through detached recons. Only the
   sc block carries gradients (`_gate4` detaches the others); the
   attention adapters run on ss / sc / sc_rep, the comp FFN adapter on a
   step's draw; the cross-attention normalization on sc / sc_rep; each
   step's conditional UNet call is recomputed in the backward
   (`torch.utils.checkpoint`), without which the 4-block × 4-step backward
   does not fit.
4. `comp_distill_loss_fn`: the identity family on the decoded recons
   (`comp_face_align.comp_identity_losses`, with ArcFace, the VAE decoder
   and a host detector), else its fallback on the batch's boxes; then per
   step the elastic-matching preservation (with `use_face_flow`, its flow
   candidate from the GMA in `frozen["flow"]`), the rep distillation and the
   cross-step attention monitor; the attention-norm monitor and the prompt
   delta loss.

Random draws come from `Draws` (`sample_comp_rand`'s, then the
re-denoise's two), or ride in the batch (`comp_rand`, `redenoise_rand`) as
the CPU tests hand over JAX's. The JAX package's collect phases and
three-phase runner (`comp_detections_to_batch`, `make_three_phase_comp_step`)
work around backends without host callbacks and are not ported: detection
runs inline, as in the recon iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from adaface_tpu_torch.models.gma import make_latent_flow_fn
from adaface_tpu_torch.models.unet import AttnRuntime
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.text.embedding_manager import (apply_merge_map,
                                                      distribute_embedding_to_M_tokens,
                                                      splice_ada_embeddings)
from adaface_tpu_torch.train.comp_face_align import comp_identity_losses
from adaface_tpu_torch.train.comp_losses import (calc_comp_subj_bg_preserve_loss,
                                                 calc_dyn_loss_scale,
                                                 calc_sc_rep_attn_distill_loss,
                                                 calc_subj_attn_cross_t_diff_loss)
from adaface_tpu_torch.train.losses import (calc_attn_norm_loss, calc_prompt_emb_delta_loss,
                                            calc_subj_masked_bg_suppress_loss)
from adaface_tpu_torch.train.train_step import TrainConfig, compute_ada_embs, unet_runner
from adaface_tpu_torch.utils.tensor import Draws, as_draws

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CompDistillConfig:
    """The comp iteration's knobs (`CompDistillConfig`, `comp_step.py:68-132`;
    the reference's ctor defaults). The collect phases' `vae_cfg` and
    `collect_px_size` have no counterpart: the decoder module carries its
    config and detection runs on the full decode."""

    num_priming_steps: int = 4  # the planner alternates 4 / 3 (`ddpm.py:2388`)
    num_denoising_steps: int = 4
    priming_t_range: tuple[float, float] = (0.7, 0.9)
    denoise_t_range: tuple[float, float] = (0.45, 0.65)
    cls_subj_mix_ratio: float = 0.6  # mc = sc·0.4 + cc·0.6; priming 0.5 + r/2
    priming_cfg_scale_range: tuple[float, float] = (2.0, 4.0)
    denoise_cfg_scale: float = 2.5
    normalize_cross_attn: bool = True
    mix_sc_mc_attn: bool = False
    use_attn_lora: bool = True
    use_ffn_lora: bool = True
    p_comp_ffn_lora: float = 0.5  # the comp FFN adapter's per-step draw
    res_hidden_gradscale: float = 0.5
    attn_norm_weight: float = 0.0  # a monitor in the reference
    rep_distill_weight: float = 1.0
    fg_bg_preserve_weight: float = 1.0
    cross_t_diff_weight: float = 0.0  # a monitor in the reference
    mb_suppress_weight: float = 0.1
    prompt_emb_delta_weight: float = 1e-4
    p_init_fg_from_training_image: float = 0.0
    # the GMA latent flow candidate of the elastic matching; frozen["flow"]
    # holds the `GMA` module (`--use_face_flow_for_sc_matching_loss`)
    use_face_flow: bool = False
    small_motion_ignore_thres: float = 0.3
    compute_dtype: str = "bfloat16"  # the UNet's and the decoder's; tests set float32
    arcface_align_loss_weight: float = 0.01
    comp_sc_face_align_loss_thres: float = 0.7
    comp_ss_face_confidence_thres: float = 0.99
    comp_sc_subj_mb_suppress_loss_weight: float = 0.2
    sc_fg_face_suppress_mask_shrink_ratio: float = 0.3
    comp_sc_fg_mask_percent_range: tuple[float, float] = (0.0225, 0.36)
    redenoise_crop_mix_weights: tuple = (0.5, 0.25, 0.25)
    lap_vars_tolerance: float = 0.3
    max_arcface_align_loss_count: int = 3
    rep_dist_fg_bounds: tuple = (0.1, 0.20, 0.25)
    max_bg_faces: int = 2


def _chain_power(num_steps: int) -> float:
    """p with the next timestep in t·[0.5^p, 0.7^p] (`unet_teachers.py:162-175`)."""
    return float(np.power(max(num_steps - 1, 1), -0.3))


def _next_t(t: torch.Tensor, rel, p: float) -> torch.Tensor:
    tf = t.float()
    return ((tf * 0.7 ** p - tf * 0.5 ** p) * rel + tf * 0.5 ** p).to(torch.int32).long()


def sample_comp_rand(draws: Draws, noise: torch.Tensor, schedule: DiffusionSchedule,
                     cfg: CompDistillConfig) -> Params:
    """The iteration's draws, in this order: the priming start [B, 4, h, w],
    its timestep and CFG scale, the priming noises after the first (the
    first is `noise[:1]`) [1, 4, h, w] each, the priming relative timesteps
    [Np − 1], the denoise's timesteps [B], noises [Nd, B, 4, h, w], relative
    timesteps [Nd − 1, B], and the comp FFN adapter's per-step uniforms
    [Nd]."""
    b, sh, dev = noise.shape[0], tuple(noise.shape[1:]), noise.device
    total, n_p, n_d = schedule.num_timesteps, cfg.num_priming_steps, cfg.num_denoising_steps
    lo, hi = cfg.priming_cfg_scale_range
    rand = {"prime_x0": draws.normal(noise.shape, dev),
            "prime_t0": draws.integers((), int(cfg.priming_t_range[0] * total),
                                       int(cfg.priming_t_range[1] * total), dev),
            "prime_cfg_scale": lo + (hi - lo) * draws.uniform()}
    rand["prime_noises"] = torch.stack([noise[:1]] + [draws.normal((1, *sh), dev)
                                                      for _ in range(n_p - 1)])
    rand["prime_rel_ts"] = draws.uniforms((max(n_p - 1, 0),), dev)
    rand["den_t0"] = draws.integers((b,), int(cfg.denoise_t_range[0] * total),
                                    int(cfg.denoise_t_range[1] * total), dev)
    rand["den_noises"] = draws.normal((n_d, b, *sh), dev)
    rand["den_rel_ts"] = draws.uniforms((max(n_d - 1, 0), b), dev)
    rand["den_ffn_gates"] = (draws.uniforms((n_d,), dev) < cfg.p_comp_ffn_lora).float()
    return rand


@torch.no_grad()
def prime_comp_x_start(unet, schedule: DiffusionSchedule, ctx_subj_single, ctx_cls_mix_prime,
                       uncond_ctx, rand: Params, cfg: CompDistillConfig, dtype):
    """No-gradient priming (`prime_x_start_for_comp_prompts` through the
    always-CFG teacher, `ddpm.py:1923-1985`): both starts from the same
    noise, the positive and the unconditional rows in one UNet call of batch
    4B → (x_primed_single, x_primed_comp) [B, 4, h, w] each."""
    b = ctx_subj_single.shape[0]
    x = rand["prime_x0"].repeat(2, 1, 1, 1)
    t = torch.full((2 * b,), int(rand["prime_t0"]), dtype=torch.long, device=x.device)
    un2 = uncond_ctx.expand(2 * b, *uncond_ctx.shape[1:])
    ctx4 = torch.cat([ctx_subj_single, ctx_cls_mix_prime, un2]).to(dtype)
    s = float(rand["prime_cfg_scale"])
    p = _chain_power(cfg.num_priming_steps)
    for i in range(cfg.num_priming_steps):
        x_t = schedule.q_sample(x, t, rand["prime_noises"][i].expand_as(x))
        eps_pos, eps_neg = unet(torch.cat([x_t, x_t]).to(dtype), torch.cat([t, t]),
                                ctx4).to(x.dtype).chunk(2)
        x = schedule.predict_start_from_noise(x_t, t, eps_pos * s - eps_neg * (s - 1.0))
        if i < cfg.num_priming_steps - 1:
            t = _next_t(t, rand["prime_rel_ts"][i], p)
    return x.chunk(2)


def _gate4(x: torch.Tensor) -> torch.Tensor:
    """Detach the ss / sc_rep / mc blocks: the batched form of the
    reference's no-grad sliced UNet calls (`guided_denoise`,
    `ddpm.py:1630-1712`)."""
    ss, sc, sr, mc = x.chunk(4)
    return torch.cat([ss.detach(), sc, sr.detach(), mc.detach()])


def _map_capture(fn, cap: dict) -> dict:
    return {key: {label: fn(v) for label, v in layers.items()} for key, layers in cap.items()}


def comp_distill_denoise(unet, schedule: DiffusionSchedule, x_start4, ctx4, uncond_ctx,
                         subj_mask4, rand: Params, attn_lora=None, ffn_lora=None,
                         cfg: CompDistillConfig = CompDistillConfig(), dtype=torch.bfloat16):
    """→ (a step's captures, its CFG recons [4B, …], its timesteps [4B], its
    chain inputs [4B, …]) for each denoising step (`comp_distill_denoise`,
    `comp_step.py:255-405`)."""
    b4 = x_start4.shape[0]
    b = b4 // 4
    n_steps = cfg.num_denoising_steps
    mix = cfg.mix_sc_mc_attn
    normalize = cfg.normalize_cross_attn and not mix
    use_attn_lora = cfg.use_attn_lora and attn_lora is not None and not mix
    use_ffn_lora = cfg.use_ffn_lora and ffn_lora is not None and not mix
    dev = x_start4.device
    # the attention adapters on ss / sc / sc_rep, never mc; normalization on
    # sc / sc_rep only (the ss rows' subject mask zeroed; the class rows have none)
    block_gate = torch.cat([torch.ones(3 * b, device=dev), torch.zeros(b, device=dev)])
    norm_mask = torch.cat([torch.zeros_like(subj_mask4[:b]), subj_mask4[b:]])
    rt = AttnRuntime(capture=True, use_attn_lora=use_attn_lora, use_ffn_lora=use_ffn_lora,
                     ffn_adapter="comp_distill", normalize_cross_attn=normalize,
                     res_hidden_gradscale=cfg.res_hidden_gradscale)
    # the unconditional pass: the step's FFN adapter on every row, no
    # attention adapter (`ddpm.py:1728-1734`)
    rt_uncond = AttnRuntime(use_ffn_lora=use_ffn_lora, ffn_adapter="comp_distill")
    s = cfg.denoise_cfg_scale
    p = _chain_power(n_steps)
    un4 = uncond_ctx.expand(b4, *uncond_ctx.shape[1:]).to(dtype)
    ctx_h = ctx4.to(dtype)

    def cond_step(x_t, t, ffn_gate):
        if mix:
            # ss and sc_rep plainly; [sc, mc] as one batch with mixed attention
            rt_plain = dataclasses.replace(rt, mix_attn_mats_in_batch=False)
            rt_mix = dataclasses.replace(rt, mix_attn_mats_in_batch=True)
            xs, ts_, cs = x_t.chunk(4), t.chunk(4), ctx_h.chunk(4)
            caps = [{}, {}, {}]
            eps_ss = unet(xs[0], ts_[0], cs[0], capture=caps[0], rt=rt_plain)
            eps_sr = unet(xs[2], ts_[2], cs[2], capture=caps[1], rt=rt_plain)
            eps_sm = unet(torch.cat([xs[1], xs[3]]), torch.cat([ts_[1], ts_[3]]),
                          torch.cat([cs[1], cs[3]]), capture=caps[2], rt=rt_mix)
            eps_sc, eps_mc = eps_sm.chunk(2)

            def join(k_ss, k_sr, k_sm):
                sc_c, mc_c = k_sm.chunk(2)
                return torch.cat([k_ss, sc_c, k_sr, mc_c])

            cap = {key: {label: join(caps[0][key][label], caps[1][key][label], v)
                         for label, v in layers.items()} for key, layers in caps[2].items()}
            return torch.cat([eps_ss, eps_sc, eps_sr, eps_mc]), cap
        cap = {}
        eps = unet(x_t, t, ctx_h, capture=cap, rt=rt, attn_lora=attn_lora, ffn_lora=ffn_lora,
                   subj_mask=norm_mask, attn_lora_gate=block_gate if use_attn_lora else None,
                   ffn_lora_gate=block_gate * ffn_gate if use_ffn_lora else None)
        return eps, cap

    captured, recons, ts, inputs = [], [], [], []
    x, t = x_start4, rand["den_t0"].repeat(4)
    for i in range(n_steps):
        ffn_gate = rand["den_ffn_gates"][i]
        x_t = schedule.q_sample(x, t, rand["den_noises"][i].repeat(4, 1, 1, 1))
        # the conditional call, recomputed in the backward
        eps, cap = checkpoint(cond_step, x_t.to(dtype), t, ffn_gate, use_reentrant=False)
        eps = _gate4(eps.to(x.dtype))
        cap = _map_capture(_gate4, cap)
        with torch.no_grad():
            eps_un = unet(x_t.to(dtype), t, un4, rt=rt_uncond,
                          ffn_lora=ffn_lora if use_ffn_lora else None,
                          ffn_lora_gate=ffn_gate.expand(b4) if use_ffn_lora else None)
        x_recon = schedule.predict_start_from_noise(x_t, t, eps * s - eps_un.to(x.dtype)
                                                    * (s - 1.0))
        captured.append(cap)
        recons.append(x_recon)
        ts.append(t)
        inputs.append(x)
        # the chain goes on from the detached recon (`ddpm.py:2080-2086`)
        if i < n_steps - 1:
            x = x_recon.detach()
            t = _next_t(t[:b], rand["den_rel_ts"][i], p).repeat(4)
    return captured, recons, ts, inputs


def encode_comp_prompts(frozen: Params, ada_embs: torch.Tensor, batch: Params,
                        cfg: TrainConfig) -> Params:
    """The 5-block prompts [ss ‖ sc ‖ sc_rep ‖ cs ‖ cc] through the CLIP text
    tower (`LatentDiffusion.forward`, `ddpm.py:1400-1530`) → the contexts
    ss, sc, sr, cs, cc, the class contexts distributed over the subject's
    positions (cs_dist, cc_dist) and the unconditional context. sc_rep and
    the unconditional prompt take the fixed CLIP-skip weights, the other
    four the iteration's."""
    te = frozen["text_encoder"]
    ids, splice_map = batch["prompt_ids"].long(), batch["splice_map"]
    b = ada_embs.shape[0]
    table = te.token_embedding
    base = table[ids.clamp(max=table.shape[0] - 1)]
    zeros = torch.zeros_like(ada_embs)
    embs = splice_ada_embeddings(base, torch.cat([ada_embs, ada_embs, ada_embs, zeros, zeros]),
                                 splice_map)
    if batch.get("merge_map") is not None:
        embs = apply_merge_map(embs, batch["merge_map"])
    default_w = torch.tensor(cfg.clip_skip_weights, device=embs.device)
    skip_w = batch.get("clip_skip_weights")
    fixed_w = batch.get("clip_skip_weights_fixed")
    skip_w = default_w if skip_w is None else skip_w
    fixed_w = default_w if fixed_w is None else fixed_w

    def rows(x, blocks):
        return torch.cat([x[i * b:(i + 1) * b] for i in blocks])

    ss, sc, cs, cc = te(rows(ids, (0, 1, 3, 4)), input_embs=rows(embs, (0, 1, 3, 4)),
                        skip_weights=skip_w).chunk(4)
    sr = te(ids[2 * b:3 * b], input_embs=embs[2 * b:3 * b], skip_weights=fixed_w)
    uncond = te(batch["uncond_ids"][:1].long(), skip_weights=fixed_w)
    ss_map = splice_map[:b]
    return {"ss": ss, "sc": sc, "sr": sr, "cs": cs, "cc": cc,
            "cs_dist": distribute_embedding_to_M_tokens(cs, ss_map, uncond),
            "cc_dist": distribute_embedding_to_M_tokens(cc, ss_map, uncond), "uncond": uncond}


def comp_distill_loss_fn(params: Params, frozen: Params, batch: Params,
                         schedule: DiffusionSchedule, cfg: TrainConfig, draws=None,
                         comp_cfg: CompDistillConfig = CompDistillConfig(), detector=None):
    """The comp iteration's loss → (loss, metrics).

    params: {"sbg", optional "attn_lora", "ffn_lora"}; frozen: {"unet",
    "text_encoder", and for the identity family "vae" (a `VAEDecoder`) and
    "arcface"}. batch: img_prompt_embs [B, K, D]; prompt_ids, splice_map,
    prompt_emb_mask, prompt_pad_mask [5B, …] ([ss ‖ sc ‖ sc_rep ‖ cs ‖ cc]);
    uncond_ids [1, S]; noise [B, 4, h, w]; for the identity family
    ref_images, ref_face_bboxes, ref_face_detected and the rolling
    comp_sc_face_detected_mean / _n; for the fallback ss_face_bboxes,
    sc_face_bboxes [B, 4] (latent) and sc_fg_mask_percent; optional fg_mask,
    comp_x_base (the fg-seeded start), comp_rand, redenoise_rand."""
    noise = batch["noise"]
    dev, b = noise.device, noise.shape[0]
    draws = as_draws(draws, dev)
    # every instance takes the first instance's ada embeddings
    # (`embedding_manager.py:316-320`)
    ada = compute_ada_embs(params, batch["img_prompt_embs"][:1], cfg).repeat(b, 1, 1)
    ctx = encode_comp_prompts(frozen, ada, batch, cfg)
    r = comp_cfg.cls_subj_mix_ratio
    ctx4_run = torch.cat([ctx["ss"], ctx["sc"], ctx["sr"], ctx["sc"] * (1.0 - r) + ctx["cc"] * r])
    r_prime = 0.5 + r / 2.0  # priming mixes with 0.8 (`ddpm.py:2398`)
    cc_mix_prime = ctx["sc"] * (1.0 - r_prime) + ctx["cc"] * r_prime

    rand = batch.get("comp_rand") or sample_comp_rand(draws, noise, schedule, comp_cfg)
    if "comp_x_base" in batch:  # the fg-seeded start replaces the priming noise
        rand = dict(rand, prime_x0=batch["comp_x_base"])
    dt = getattr(torch, comp_cfg.compute_dtype)
    unet = unet_runner({}, frozen, dt)
    x_ss, x_cc = prime_comp_x_start(unet, schedule, ctx["ss"], cc_mix_prime, ctx["uncond"], rand,
                                    comp_cfg, dt)
    x4 = torch.cat([x_ss, x_cc, x_cc, x_cc])

    def rows4(x):  # [ss, sc, sc_rep, cc] of the 5 blocks
        return torch.cat([x[:3 * b], x[4 * b:5 * b]])

    subj_mask4 = (rows4(batch["splice_map"]) >= 0).float()
    captured_steps, x_recons, ts, x_inputs = comp_distill_denoise(
        unet, schedule, x4, ctx4_run, ctx["uncond"], subj_mask4, rand,
        attn_lora=params.get("attn_lora"), ffn_lora=params.get("ffn_lora"), cfg=comp_cfg,
        dtype=dt)
    n_steps = len(captured_steps)
    subj_mask_1b = subj_mask4[:b]
    metrics: Params = {}
    loss = torch.zeros((), device=dev)

    have_face = ("arcface" in frozen and "vae" in frozen and detector is not None
                 and comp_cfg.arcface_align_loss_weight > 0 and "ref_images" in batch)
    if have_face:
        batch_f = batch
        if "redenoise_rand" not in batch:
            sh = (n_steps, b, *noise.shape[1:])
            batch_f = dict(batch, redenoise_rand={"x": draws.normal(sh, dev),
                                                  "n": draws.normal(sh, dev)})
        id_loss, aux, id_metrics = comp_identity_losses(
            unet, frozen, detector, x_recons, x_inputs, rand["den_noises"], ts, captured_steps,
            ctx["ss"], ctx["uncond"], subj_mask_1b, batch_f, params.get("attn_lora"),
            params.get("ffn_lora"), schedule, comp_cfg, dt)
        loss = loss + id_loss
        metrics.update(id_metrics)
        captured_steps = aux["captured_steps"]
        sc_fg_pct = aux["sc_fg_mask_percent"]
        ss_bboxes_per_step = aux["ss_bboxes_per_step"]
        sc_bboxes = aux["sc_fg_face_bboxes"]
        fg_bg_gates, ct_gates = aux["fg_bg_gates"], aux["ct_gates"]
        shrink, do_supp = aux["shrink_ratio"], aux["do_sc_fg_faces_suppress"]
    else:
        # no face towers: the batch's boxes and percent, every step active, the
        # masked-background suppression on the fg mask
        sc_fg_pct = torch.as_tensor(batch.get("sc_fg_mask_percent", 1.0), dtype=torch.float32,
                                    device=dev)
        ss_bboxes_per_step = [batch["ss_face_bboxes"]] * n_steps
        sc_bboxes = batch["sc_face_bboxes"]
        fg_bg_gates = torch.ones(n_steps, device=dev)
        ct_gates = torch.zeros(n_steps, device=dev)
        if n_steps > 1:
            ct_gates[n_steps - 2] = 1.0
        shrink, do_supp = 1.0, 0.0
        sc_attn = {k: v.chunk(4)[1] for k, v in captured_steps[-1]["attn"].items()}
        loss_mb = calc_subj_masked_bg_suppress_loss(sc_attn, subj_mask_1b,
                                                    batch.get("fg_mask")).to(dev)
        loss = loss + comp_cfg.mb_suppress_weight * loss_mb
        metrics["loss_mb_suppress"] = loss_mb

    # the per-step losses over all denoising steps (`ddpm.py:3466-3514`)
    emb_mask4, pad_mask4 = rows4(batch["prompt_emb_mask"]), rows4(batch["prompt_pad_mask"])
    flow_fn = (make_latent_flow_fn(frozen["flow"])
               if comp_cfg.use_face_flow and "flow" in frozen else None)
    rep_sums = {k: torch.zeros((), device=dev)
                for k in ("subj_attn", "subj_k", "nonsubj_k", "subj_v", "nonsubj_v")}
    fg_bg_steps, ct_steps = [], []
    for s in range(n_steps):
        rep_s = calc_sc_rep_attn_distill_loss(captured_steps[s], subj_mask_1b, emb_mask4,
                                              pad_mask4, sc_fg_pct,
                                              fg_thres=comp_cfg.rep_dist_fg_bounds[0])
        for k in rep_sums:
            rep_sums[k] = rep_sums[k] + rep_s[k] / n_steps
        loss_fg_bg_s, _ = calc_comp_subj_bg_preserve_loss(
            captured_steps[s], ss_bboxes_per_step[s], sc_bboxes, flow_fn=flow_fn,
            small_motion_ignore_thres=comp_cfg.small_motion_ignore_thres,
            do_sc_fg_faces_suppress=do_supp, sc_face_shrink_ratio=shrink)
        fg_bg_steps.append(loss_fg_bg_s)
        if s < n_steps - 1:
            ct_steps.append(calc_subj_attn_cross_t_diff_loss(captured_steps[s],
                                                             captured_steps[s + 1],
                                                             subj_mask_1b))
    loss_fg_bg = (torch.stack(fg_bg_steps) * fg_bg_gates).sum() / (fg_bg_gates.sum() + 1e-6)
    loss = loss + comp_cfg.fg_bg_preserve_weight * loss_fg_bg
    metrics["loss_comp_fg_bg_preserve"] = loss_fg_bg
    if ct_steps:
        ctg = ct_gates[:len(ct_steps)]
        loss_cross_t = (torch.stack(ct_steps) * ctg).sum() / (ctg.sum() + 1e-6)
    else:
        loss_cross_t = torch.zeros((), device=dev)
    loss = loss + comp_cfg.cross_t_diff_weight * loss_cross_t  # a monitor at weight 0
    metrics["loss_cross_t_diff"] = loss_cross_t

    # the rep-distill assembly (`ddpm.py:3556-3590`)
    bounds = comp_cfg.rep_dist_fg_bounds
    fg_scale = calc_dyn_loss_scale(sc_fg_pct, (bounds[1], 0.5), (bounds[2], 2.0),
                                   valid_scale_range=(0.05, 2.0)) * (sc_fg_pct > 0)
    loss_rep = ((rep_sums["subj_attn"] + rep_sums["subj_k"] + rep_sums["subj_v"]) * 2.0
                + rep_sums["nonsubj_k"] * 5.0 + rep_sums["nonsubj_v"] * 2.0) * fg_scale
    loss = loss + comp_cfg.rep_distill_weight * loss_rep
    metrics["loss_rep_distill"] = loss_rep

    # the attention-norm monitor over [sc, mc] of the last step
    loss_attn_norm = calc_attn_norm_loss(
        {k: torch.cat([v.chunk(4)[1], v.chunk(4)[3]])
         for k, v in captured_steps[-1]["attnscore"].items()}, subj_mask_1b)
    loss = loss + comp_cfg.attn_norm_weight * loss_attn_norm
    metrics["loss_attn_norm"] = loss_attn_norm

    # the prompt delta loss on [ss, sc, cs_dist, cc_dist] with the original
    # masks (`ddpm.py:2286-2293`)
    ctx4_delta = torch.cat([ctx["ss"], ctx["sc"], ctx["cs_dist"], ctx["cc_dist"]])
    emb_mask_orig = torch.cat([batch["prompt_emb_mask"][:2 * b],
                               batch["prompt_emb_mask"][3 * b:5 * b]])
    loss_delta = calc_prompt_emb_delta_loss(ctx4_delta, emb_mask_orig)
    loss = loss + comp_cfg.prompt_emb_delta_weight * loss_delta
    metrics["loss_prompt_emb_delta"] = loss_delta
    metrics["loss"] = loss
    return loss, metrics


def make_comp_loss_fn(comp_cfg: CompDistillConfig, detector=None):
    """The comp loss with its config and host detector bound, in
    `make_train_step`'s calling convention."""

    def loss_fn(params, frozen, batch, schedule, cfg, draws=None):
        return comp_distill_loss_fn(params, frozen, batch, schedule, cfg, draws,
                                    comp_cfg=comp_cfg, detector=detector)

    return loss_fn
