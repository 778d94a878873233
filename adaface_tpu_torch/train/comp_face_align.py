"""The comp iteration's identity losses and the subject-single re-denoise.

Counterpart of `adaface_tpu/train/comp_face_align.py` (the face-dependent
half of the reference's `calc_comp_feat_distill_loss`,
`ddpm.py:3190-3600`), at `stage="full"`:

- decode the subject-single recons of every step and the last step's
  class-comp recon (no gradient), detect their faces on the host;
- per step, decode the subject-comp recon with gradient (its decoder
  recomputed in the backward), detect its faces on the host, and take the
  ArcFace alignment to the input's face, the fg-face suppression and the
  background faces' suppression; the reversed-step kept / computed gates
  (`assemble_align_gates`, at most 3 kept under the 0.7 threshold);
- the face-proportion class (`classify_sc_face_proportion`) and the loss
  scales it sets (`compute_align_scales`), the masked-background
  suppression of the subject-comp attention;
- the subject-single re-denoise (`ss_redenoise_loop`) from starts with the
  subject-comp face pasted in (`paste_resized_crop`), a second detection
  round on its decodes, and per step the replacement of the subject-single
  block of the captured activations where the redenoised face is confident
  and sharp (`var_of_laplacian`).

Data-dependent choices stay {0, 1} tensor weights, as in the JAX graph.
Under data parallelism the gates and the face-mask fractions are the global
batch's (`parallel.collectives`: every instance detected, the least
confidence, the mean over instances).
Host detection runs inline on detached copies (`face_detect.detect_faces`:
one read-back of each set of decodes); the JAX package's three-phase
choreography for backends without host callbacks is not needed here.
"""

from __future__ import annotations

from typing import Any

import torch

from adaface_tpu_torch.models.unet import AttnRuntime
from adaface_tpu_torch.models.vae import vae_decode
from adaface_tpu_torch.parallel.collectives import gall, gmean, gmin, gsum
from adaface_tpu_torch.train.face_detect import detect_faces, map_bboxes_to_latent
from adaface_tpu_torch.train.face_losses import (bilinear_crop, calc_arcface_align_loss,
                                                 calc_bg_faces_suppress_loss)
from adaface_tpu_torch.train.losses import calc_subj_masked_bg_suppress_loss
from adaface_tpu_torch.train.recon_multistep import var_of_laplacian

Params = dict[str, Any]
PROPORTION_TYPES = ("sc-noface", "mc-no-sc-large", "little-no-overlap", "too-small",
                    "too-large", "good")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _bbox_mask(bboxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 4] → [B, 1, h, w] {0, 1} mask (zeros outside)."""
    ys = torch.arange(h, device=bboxes.device)[None, :, None]
    xs = torch.arange(w, device=bboxes.device)[None, None, :]
    x0, y0, x1, y1 = (bboxes[:, i, None, None] for i in range(4))
    return ((xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)).float()[:, None]


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img [C, H, W], ys / xs [H', W'] float coordinates → [C, H', W']."""
    h, w = img.shape[-2:]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    wy, wx = (ys - y0)[None], (xs - x0)[None]
    return (img[:, y0, x0] * (1 - wy) * (1 - wx) + img[:, y0, x1] * (1 - wy) * wx
            + img[:, y1, x0] * wy * (1 - wx) + img[:, y1, x1] * wy * wx)


def paste_resized_crop(dst: torch.Tensor, dst_bboxes: torch.Tensor, src: torch.Tensor,
                       src_bboxes: torch.Tensor, mix_weights=(0.5, 0.25, 0.25),
                       rand_noise: torch.Tensor | None = None) -> torch.Tensor:
    """src's src_bbox region resized onto dst's dst_bbox region and blended
    there: crop·w0 + noise·w1 + dst·w2 inside the box, dst outside
    (`ddpm.py:2118-2145`, `F.interpolate(bilinear, align_corners=False)`).
    dst, src [B, C, H, W]; boxes [B, 4]; no noise: its weight goes to dst."""
    b, c, h, w = dst.shape
    w0, w1, w2 = mix_weights
    if rand_noise is None:
        rand_noise = torch.zeros_like(dst)
        w1, w2 = 0.0, w2 + w1
    dev = dst.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] * torch.ones((1, w), device=dev)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * torch.ones((h, 1), device=dev)
    out = []
    for d, s, db, sb, rn in zip(dst, src, dst_bboxes.float(), src_bboxes.float(), rand_noise):
        dx0, dy0, dx1, dy1 = db
        sx0, sy0, sx1, sy1 = sb
        dw, dh = torch.clamp(dx1 - dx0, min=1.0), torch.clamp(dy1 - dy0, min=1.0)
        sw, sh = torch.clamp(sx1 - sx0, min=1.0), torch.clamp(sy1 - sy0, min=1.0)
        sy = sy0 + (yy - dy0 + 0.5) * (sh / dh) - 0.5
        sx = sx0 + (xx - dx0 + 0.5) * (sw / dw) - 0.5
        sampled = _bilinear_sample(s, sy, sx)
        inside = ((xx >= dx0) & (xx < dx1) & (yy >= dy0) & (yy < dy1)).to(d.dtype)[None]
        out.append(d * (1 - inside) + (sampled * w0 + rn * w1 + d * w2) * inside)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# the face proportion and the loss scales (`ddpm.py:3337-3464`)
# ---------------------------------------------------------------------------

def classify_sc_face_proportion(sc_pct, mc_pct, overlap_frac,
                                pct_range=(0.0225, 0.36)) -> torch.Tensor:
    """→ one-hot [6] over PROPORTION_TYPES, the reference's elif chain."""
    lo, hi = pct_range
    conds = [sc_pct == 0, (mc_pct == 0) & (sc_pct >= 0.16 * hi),
             (mc_pct > 0) & (overlap_frac < 0.16), sc_pct <= lo,
             (sc_pct >= hi) | ((mc_pct > 0) & (sc_pct >= 6.25 * mc_pct))]
    idx = torch.full((), 5, dtype=torch.long, device=sc_pct.device)
    for i in reversed(range(len(conds))):  # the first true condition wins
        idx = torch.where(conds[i], torch.full_like(idx, i), idx)
    return torch.nn.functional.one_hot(idx, 6).float()


def compute_align_scales(prop, frac, loss_align, loss_fg_sup):
    """The align / fg-suppress scale arithmetic (`ddpm.py:3372-3455`) →
    (loss_align scaled, the suppression scale, do_suppress {0, 1})."""
    extra_scale = (prop[3] + prop[5]) * 3.0 + (prop[1] + prop[2] + prop[4]) * 1.5
    la_scaled = loss_align * (extra_scale * torch.clamp(1.0 / (frac ** 2 + 0.01), max=4.0))
    do_suppress = prop[1] + prop[2] + prop[4]
    supp_base = prop[1] * 5.0 + prop[2] * 10.0 + prop[4] * 10.0
    # exact division (no epsilon in the reference, `ddpm.py:3444`); the
    # ratio is consumed only where loss_fg_sup > 0
    safe_fg = torch.where(loss_fg_sup > 0, loss_fg_sup, torch.ones_like(loss_fg_sup))
    ratio = la_scaled.detach() / safe_fg.detach()
    clipped = torch.minimum(torch.maximum(ratio * 0.1, supp_base / 2.0), supp_base + 1e-6)
    supp_scale = torch.where((la_scaled > 0) & (loss_fg_sup > 0), clipped, supp_base)
    return la_scaled, supp_scale, do_suppress


def assemble_align_gates(la_arr, g_any, thres: float, max_count: int):
    """The reversed-step gates (`ddpm.py:3628-3673`): from the last step
    down, the align loss is computed while fewer than `max_count` steps are
    kept; a detected step is kept when its loss is ≤ thres (thres ≤ 0: no
    threshold). → ({0, 1}[S] kept, computed, stat = detected ∧ computed)."""
    kept_rev, computed_rev = [], []
    kept_before = torch.zeros((), device=la_arr.device)
    for s in range(la_arr.shape[0] - 1, -1, -1):
        computed = (kept_before < max_count).float()
        under = (la_arr[s] <= thres).float() if thres > 0 else torch.ones_like(computed)
        kept = g_any[s] * computed * under
        computed_rev.append(computed)
        kept_rev.append(kept)
        kept_before = kept_before + kept
    computed = torch.stack(computed_rev[::-1])
    return torch.stack(kept_rev[::-1]), computed, g_any * computed


# ---------------------------------------------------------------------------
# the subject-single re-denoise (`ddpm.py:2093-2266`)
# ---------------------------------------------------------------------------

@torch.no_grad()
def ss_redenoise_loop(unet, schedule, xs_mixed, noises, ts, ctx_ss, uncond_ctx, attn_lora,
                      ffn_lora, cfg, dtype):
    """The no-gradient subject-single re-denoise with old_x_starts_mix_ratio
    0.3 chaining (`comp_distill_multistep_denoise` as `redenoise_subj_single`
    calls it: one block, no gradient, no attention augmentation) →
    (captures, x_recons), one each a step. `unet` computes in `dtype`."""
    b = xs_mixed[0].shape[0]
    use_attn_lora = cfg.use_attn_lora and attn_lora is not None
    use_ffn_lora = cfg.use_ffn_lora and ffn_lora is not None
    rt = AttnRuntime(capture=True, use_attn_lora=use_attn_lora, use_ffn_lora=use_ffn_lora,
                     ffn_adapter="comp_distill")
    rt_un = AttnRuntime(use_ffn_lora=use_ffn_lora, ffn_adapter="comp_distill")
    un = uncond_ctx.expand(b, *uncond_ctx.shape[1:]).to(dtype)
    ctx_h = ctx_ss.to(dtype)
    s_cfg = cfg.denoise_cfg_scale
    caps, recons, prev = [], [], None
    for x_mix, noise_i, t in zip(xs_mixed, noises, ts):
        # step 0 starts from its mixed start; later steps chain 0.3 / 0.7
        x = x_mix if prev is None else x_mix * 0.3 + prev * 0.7
        x_t = schedule.q_sample(x, t, noise_i)
        cap: dict = {}
        eps = unet(x_t.to(dtype), t, ctx_h, capture=cap, rt=rt,
                   attn_lora=attn_lora if use_attn_lora else None,
                   ffn_lora=ffn_lora if use_ffn_lora else None)
        eps_un = unet(x_t.to(dtype), t, un, rt=rt_un, ffn_lora=ffn_lora if use_ffn_lora else None)
        prev = schedule.predict_start_from_noise(
            x_t, t, eps.to(x.dtype) * s_cfg - eps_un.to(x.dtype) * (s_cfg - 1.0))
        caps.append(cap)
        recons.append(prev)
    return caps, recons


# ---------------------------------------------------------------------------
# the identity-loss orchestration
# ---------------------------------------------------------------------------

def _block(v: torch.Tensor, i: int) -> torch.Tensor:
    return v.chunk(4)[i]


def comp_identity_losses(unet, frozen: Params, detector, x_recons, x_inputs, den_noises, ts,
                         captured_steps, ctx_ss, uncond_ctx, subj_mask_1b, batch: Params,
                         attn_lora, ffn_lora, schedule, comp_cfg, dtype):
    """→ (loss, aux, metrics) at the JAX package's `stage="full"`
    (`comp_face_align.py:311-626`). x_recons, x_inputs: a step's [4B, 4, h, w]
    each; den_noises [S, B, 4, h, w]; ts a step's [4B]; captured_steps the
    denoise's captures; batch: ref_images, ref_face_bboxes, ref_face_detected,
    comp_sc_face_detected_mean / _n, redenoise_rand {x, n} [S, B, 4, h, w].
    aux: sc_fg_mask_percent, sc_fg_face_bboxes, sc_fg_mask,
    ss_bboxes_per_step, fg_bg_gates, ct_gates, shrink_ratio,
    do_sc_fg_faces_suppress and the captures with the redenoised
    subject-single block swapped in."""
    s_steps = len(x_recons)
    b = x_recons[0].shape[0] // 4
    hw = x_recons[0].shape[-1]
    dev = x_recons[0].device
    metrics: Params = {}
    vae, arcface = frozen["vae"], frozen["arcface"]
    max_bg = comp_cfg.max_bg_faces

    # decode and detect: the subject-single recons of every step and the last
    # step's class-comp recon, in one batch
    with torch.no_grad():
        ssmc_px = vae_decode(vae, torch.cat([x_recons[s][:b] for s in range(s_steps)]
                                            + [x_recons[-1][3 * b:]]).detach())
    ss_px = ssmc_px[:s_steps * b]
    px = ss_px.shape[-1]
    fg_bb_all, det_all, conf_all, _, _ = detect_faces(ssmc_px, detector, max_bg)
    ss_bb = fg_bb_all[:s_steps * b].reshape(s_steps, b, 4)
    ss_det = det_all[:s_steps * b].reshape(s_steps, b)
    ss_conf = conf_all[:s_steps * b].reshape(s_steps, b)
    mc_bb, mc_det = fg_bb_all[s_steps * b:], det_all[s_steps * b:]
    # every subject-single instance of the last step confidently detected
    all_ss = (gall(ss_det[-1])
              * (gmin(ss_conf[-1]) >= comp_cfg.comp_ss_face_confidence_thres).float())
    ss_bb_lat_last = map_bboxes_to_latent(ss_bb[-1], px, hw)

    # per step: the subject-comp decode with gradient, its faces, the losses
    ref_det = batch.get("ref_face_detected", torch.ones((b,), device=dev))
    la_l, lfg_l, lbg_l, bga_l, g_l, sc_bb_lat_steps = [], [], [], [], [], []
    for s in range(s_steps):
        sc_px = vae_decode(vae, x_recons[s][b:2 * b])
        sc_fg_bb, sc_det, _, sc_bgbb, sc_bgv = detect_faces(sc_px, detector, max_bg)
        det = sc_det * ref_det
        la, lfg, _ = calc_arcface_align_loss(
            arcface, batch["ref_images"][:b], sc_px, batch["ref_face_bboxes"][:b], sc_fg_bb, det,
            fg_faces_grad_mask_ratios=(0.9, comp_cfg.sc_fg_face_suppress_mask_shrink_ratio))
        lbg, bga = calc_bg_faces_suppress_loss(arcface, sc_px, sc_bgbb, sc_bgv)
        la_l.append(la)
        lfg_l.append(lfg)
        lbg_l.append(lbg)
        bga_l.append(bga)
        g_l.append((gsum(det.sum()) > 0).float())
        sc_bb_lat_steps.append(map_bboxes_to_latent(sc_fg_bb, px, hw))
    la_arr, lfg_arr, lbg_arr = torch.stack(la_l), torch.stack(lfg_l), torch.stack(lbg_l)
    lbg_any_arr = torch.stack(bga_l)
    # the align family runs only where every last-step subject-single face
    # is confident (`ddpm.py:3247`)
    g_any = torch.stack(g_l) * all_ss

    kept, computed, stat = assemble_align_gates(la_arr, g_any,
                                                comp_cfg.comp_sc_face_align_loss_thres,
                                                comp_cfg.max_arcface_align_loss_count)
    loss_align = (la_arr * kept).sum() / (kept.sum() + 1e-6)
    metrics["loss_arcface_align_comp"] = (la_arr * stat).sum() / (stat.sum() + 1e-6)
    metrics["comp_sc_face_align_kept_frac"] = kept.sum() / (stat.sum() + 1e-6)
    fg_pos = (lfg_arr > 0).float() * stat
    loss_fg_sup = (lfg_arr * fg_pos).sum() / (fg_pos.sum() + 1e-6)
    bg_pos = lbg_any_arr * stat
    loss_bg_sup = (lbg_arr * bg_pos).sum() / (bg_pos.sum() + 1e-6) * (bg_pos.sum() > 0)

    # the last detected step s* sets the subject-comp face mask (`:3676-3688`)
    steps = torch.arange(s_steps, device=dev)
    det_any_at_all = (g_any.max() > 0).float()
    s_star = torch.argmax(g_any * (steps + 1))
    onehot = torch.nn.functional.one_hot(s_star, s_steps).float() * det_any_at_all
    sc_bb_lat = torch.einsum("s,sbi->bi", onehot, torch.stack(sc_bb_lat_steps))
    sc_fg_mask = _bbox_mask(sc_bb_lat, hw, hw) * det_any_at_all
    sc_pct = gmean(sc_fg_mask)

    # masked-background suppression per step with the s* mask, steps ≤ s*; an
    # undetected step reuses the nearest detected step above it
    # (`ddpm.py:3675`, replicated as the JAX package does)
    mb_all = [calc_subj_masked_bg_suppress_loss(
        {k: _block(v, 1) for k, v in captured_steps[s]["attn"].items()}, subj_mask_1b,
        sc_fg_mask) for s in range(s_steps)]
    mb_steps = []
    for s in range(s_steps):
        pick = torch.zeros((), device=dev)
        found = torch.zeros((), device=dev)
        for sp in range(s, s_steps):
            pick = pick + mb_all[sp] * (g_any[sp] * (1.0 - found))
            found = torch.maximum(found, g_any[sp])
        mb_steps.append(pick)
    mb_w = (steps <= s_star).float() * det_any_at_all
    loss_mb = (torch.stack(mb_steps) * mb_w).sum() / (mb_w.sum() + 1e-6)

    # the class-comp face mask and the proportion class (`:3284-3330`)
    mc_all = gall(mc_det)
    mc_fg_mask = _bbox_mask(map_bboxes_to_latent(mc_bb, px, hw), hw, hw) * mc_all
    mc_pct = gmean(mc_fg_mask)
    overlap = gsum((sc_fg_mask * mc_fg_mask).sum()) / (gsum(sc_fg_mask.sum()) + 1e-6)
    prop = classify_sc_face_proportion(sc_pct, mc_pct, overlap,
                                       comp_cfg.comp_sc_fg_mask_percent_range)
    metrics.update(sc_fg_mask_percent=sc_pct, mc_fg_mask_percent=mc_pct,
                   sc_face_proportion_type=torch.argmax(prop).float(),
                   comp_sc_face_detected=det_any_at_all, comp_mc_face_detected=mc_all)

    # the loss scales, with this iteration's indicator in the rolling window
    # (`ddpm.py:3380-3396`: a kept align step exists)
    kept_any = (kept.sum() > 0).float()
    prev_mean = torch.as_tensor(batch.get("comp_sc_face_detected_mean", 1.0),
                                dtype=torch.float32, device=dev)
    prev_n = torch.as_tensor(batch.get("comp_sc_face_detected_n", 0.0), dtype=torch.float32,
                             device=dev)
    frac = (prev_mean * prev_n + kept_any) / (prev_n + 1.0)
    metrics["comp_sc_face_detected_frac"] = frac
    metrics["comp_sc_face_kept_any"] = kept_any
    la_scaled, supp_scale, do_suppress = compute_align_scales(prop, frac, loss_align * kept_any,
                                                              loss_fg_sup)
    w_arc = comp_cfg.arcface_align_loss_weight
    loss = loss_bg_sup * 400.0 * w_arc * all_ss
    loss = loss + loss_mb * comp_cfg.comp_sc_subj_mb_suppress_loss_weight * all_ss
    loss = loss + la_scaled * w_arc * all_ss
    loss = loss + loss_fg_sup * supp_scale * w_arc * do_suppress * all_ss * (fg_pos.sum() > 0)

    # the subject-single re-denoise from subject-comp-face-mixed starts
    # (`:3402-3427`)
    mix = batch.get("redenoise_rand")
    mixed_xs, mixed_noises = [], []
    for s in range(s_steps):
        ss_x = x_inputs[s][:b].detach()
        sc_x = x_inputs[s][b:2 * b].detach()
        rn_x = mix["x"][s] if mix is not None else torch.zeros_like(ss_x)
        rn_n = mix["n"][s] if mix is not None else torch.zeros_like(ss_x)
        mixed_xs.append(paste_resized_crop(ss_x, ss_bb_lat_last, sc_x, sc_bb_lat,
                                           comp_cfg.redenoise_crop_mix_weights, rn_x))
        mixed_noises.append(paste_resized_crop(den_noises[s], ss_bb_lat_last, den_noises[s],
                                               sc_bb_lat, comp_cfg.redenoise_crop_mix_weights,
                                               rn_n))
    cap2, recons2 = ss_redenoise_loop(unet, schedule, mixed_xs, mixed_noises,
                                      [t[:b] for t in ts], ctx_ss, uncond_ctx, attn_lora,
                                      ffn_lora, comp_cfg, dtype)

    # the second detection round and its quality gates (`:2179-2260`)
    with torch.no_grad():
        ss2_px = vae_decode(vae, torch.cat(recons2))
    ss2_bb, ss2_det, ss2_conf, _, _ = detect_faces(ss2_px, detector, max_bg)
    ss2_det_st, ss2_conf_st = ss2_det.reshape(s_steps, b), ss2_conf.reshape(s_steps, b)
    with torch.no_grad():
        lap1 = var_of_laplacian(bilinear_crop(ss_px, fg_bb_all[:s_steps * b], 128))
        lap2 = var_of_laplacian(bilinear_crop(ss2_px, ss2_bb, 128))
    lap1, lap2 = gmean(lap1.reshape(s_steps, b), -1), gmean(lap2.reshape(s_steps, b), -1)
    round2_ok = gall(ss2_det_st[-1])
    good_conf = gmean(ss2_conf_st, -1) >= comp_cfg.comp_ss_face_confidence_thres
    is_clear = lap2 >= lap1 * comp_cfg.lap_vars_tolerance
    # no re-denoise where the subject-comp face went undetected (`:3420-3424`)
    repl = (good_conf & is_clear).float() * round2_ok * (1.0 - prop[0])
    metrics["comp_ss_redenoise_success_frac"] = repl.mean()

    # per step, the subject-single block of the captures replaced
    new_captured, ss_bboxes_per_step = [], []
    ss2_bb_lat_st = map_bboxes_to_latent(ss2_bb.reshape(s_steps, b, 4), px, hw)
    for s in range(s_steps):
        w_s = repl[s]

        def swap(v, v2):
            parts = list(v.chunk(4))
            parts[0] = (v2 * w_s + parts[0] * (1 - w_s)).to(v.dtype)
            return torch.cat(parts)

        new_captured.append({key: {label: swap(v, cap2[s][key][label])
                                   for label, v in layers.items()}
                             for key, layers in captured_steps[s].items()})
        ss_bboxes_per_step.append(ss2_bb_lat_st[s] * w_s + ss_bb_lat_last * (1 - w_s))

    # fg_bg_preserve from s* on, cross-t from s* − 1 to S − 2, both only where
    # every last-step subject-single face is confident and a subject-comp face
    # was found (`:3488-3503`)
    on = all_ss * det_any_at_all
    fg_bg_gates = (steps >= s_star).float() * on
    ct_gates = ((steps >= s_star - 1) & (steps < s_steps - 1)).float() * on
    shrink = do_suppress * comp_cfg.sc_fg_face_suppress_mask_shrink_ratio + (1.0 - do_suppress)
    aux = {"sc_fg_mask_percent": sc_pct, "sc_fg_face_bboxes": sc_bb_lat,
           "sc_fg_mask": sc_fg_mask, "ss_bboxes_per_step": ss_bboxes_per_step,
           "fg_bg_gates": fg_bg_gates, "ct_gates": ct_gates, "shrink_ratio": shrink,
           "do_sc_fg_faces_suppress": do_suppress, "captured_steps": new_captured}
    return loss, aux, metrics
