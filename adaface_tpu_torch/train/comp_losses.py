"""Stage-2 compositional-distillation losses.

Counterpart of `adaface_tpu/train/comp_losses.py` (the reference's
`ldm/util.py:1920-2758`, dispatched from `calc_comp_feat_distill_loss`,
`ddpm.py:3190-3600`). The 4-block batch is [subj_single ‖ subj_comp ‖
subj_comp_rep ‖ cls_comp] along the leading axis; a capture is the UNet's
`capture[key][label]` dict (q2, attn_out, outfeat, attn, k, v of the last
up block's cross-attentions, labels 22-24).

- `calc_elastic_matching_loss`: the subject-comp features rebuilt from the
  subject-single face crop and from the class-comp background, by
  q-similarity attention and by the same location, the margin-weighted
  per-token minimum, with the loss scale capped and discarded by tensor
  gates. With `flow_fn` (GMA, `models/gma.make_latent_flow_fn`) the flow
  candidate warps the source features by the target→source flow of the
  demeaned q features, computed once a call without gradient, and the
  flow-warped identity (`flow2attn`) takes part in the sparse-attention
  pick; without it the flow candidate is the same location, the reference
  default (`use_face_flow_for_sc_matching_loss=False`).
- `calc_comp_subj_bg_preserve_loss`: the layer-weighted wrapper over layers
  22-24.
- `calc_sc_rep_attn_distill_loss`: subject-comp → subject-comp-rep
  attention distillation and the K/V alignments, gated on the face area.
- `calc_subj_attn_cross_t_diff_loss`: subject attention across steps (a
  monitor in the reference).
"""

from __future__ import annotations

from typing import Callable

import torch

from adaface_tpu_torch.models.gma import backward_warp_by_flow, flow2attn
from adaface_tpu_torch.parallel.collectives import active_mesh, global_batch_size, gmean, gsum
def _crop_resize_feat(feat_4d: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] + latent boxes [B, 4] (x0, y0, x1, y1) → the crops resized
    back to [B, C, H, W]: the integer-box slice + `F.interpolate(bilinear,
    align_corners=False)` of the reference (`ldm/util.py:2576-2586`), sample
    centres (i + 0.5)·crop/H − 0.5, border-replicated inside the crop."""
    b, c, h, w = feat_4d.shape
    x0, y0, x1, y1 = (bboxes[:, i].float() for i in range(4))
    cw = torch.clamp(x1 - x0, min=1.0)
    ch = torch.clamp(y1 - y0, min=1.0)
    dev = feat_4d.device
    ty = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[None] * (ch[:, None] / h) - 0.5
    tx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None] * (cw[:, None] / w) - 0.5
    ys = y0[:, None] + torch.minimum(torch.clamp(ty, min=0.0), (ch - 1.0)[:, None])
    xs = x0[:, None] + torch.minimum(torch.clamp(tx, min=0.0), (cw - 1.0)[:, None])
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0i = torch.floor(ys).long()
    x0i = torch.floor(xs).long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)
    wy = (ys - y0i)[:, None, :, None].to(feat_4d.dtype)
    wx = (xs - x0i)[:, None, None, :].to(feat_4d.dtype)

    def gather(yi, xi):
        rows = torch.gather(feat_4d, 2, yi[:, None, :, None].expand(b, c, h, w))
        return torch.gather(rows, 3, xi[:, None, None, :].expand(b, c, h, w))

    return (gather(y0i, x0i) * (1 - wy) * (1 - wx) + gather(y0i, x1i) * (1 - wy) * wx
            + gather(y1i, x0i) * wy * (1 - wx) + gather(y1i, x1i) * wy * wx)


def _recon_with_attn(feat: torch.Tensor, prob: torch.Tensor) -> torch.Tensor:
    """[B, C, N] × [B, N, N'] → [B, N', C] (`reconstruct_feat_with_attn_aggregation`)."""
    return torch.einsum("bcn,bnm->bmc", feat, prob)


def _mean_over_batch_and_tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, N] → [1, C, 1], the global batch's (no gradient reads it)."""
    if active_mesh() is None:
        return x.mean(dim=(0, 2), keepdim=True)
    return gsum(x.sum(dim=(0, 2), keepdim=True)) / (x.shape[0] * x.shape[2] * active_mesh().dp)


def calc_elastic_matching_loss(ca_q, ca_attn_out, ca_outfeat, h: int, w: int,
                               ss_face_bboxes, sc_face_bboxes, flow_fn: Callable | None = None,
                               small_motion_ignore_thres: float = 0.3,
                               sc_face_shrink_ratio=1.0,
                               recon_scaled_loss_threses=None,
                               recon_max_scale_of_threses: float = 5.0) -> dict:
    """ca_q (the q2 capture), ca_attn_out, ca_outfeat [4B, C, N]; latent boxes
    [B, 4] → {sc_recon_{ssfg,mc}_{attn_agg,flow,sameloc,min},
    sc_to_{ssfg,mc}_sparse_attns_distill, discarded_loss_ratio}. flow_fn(target_q,
    src_q, h, w, small_motion_thres) → the target→src flow [B, 2, h, w]."""
    threses = recon_scaled_loss_threses or {"mc": 0.4, "ssfg": 0.4}
    b4, c, n = ca_q.shape
    b = b4 // 4
    ca_q, ca_attn_out, ca_outfeat = ca_q.float(), ca_attn_out.float(), ca_outfeat.float()
    ss_q, sc_q, _, mc_q = ca_q.chunk(4)
    dev = ca_q.device

    def to4d(x):
        return x.reshape(x.shape[0], c, h, w)

    # the face crops resized to the full grid, demeaned for sharper matching
    ssfg_q = _crop_resize_feat(to4d(ss_q), ss_face_bboxes).reshape(b, c, n)
    scfg_q = _crop_resize_feat(to4d(sc_q), sc_face_bboxes).reshape(b, c, n)
    q_fg_mean = _mean_over_batch_and_tokens(torch.cat([ssfg_q, scfg_q])).detach()
    ssfg_q = ssfg_q - q_fg_mean
    scfg_q = scfg_q - q_fg_mean

    # the background: 1 outside the (possibly shrunken) subject-comp face box
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    shrink = torch.as_tensor(sc_face_shrink_ratio, dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = (sc_face_bboxes[:, i, None, None] * shrink for i in range(4))
    in_face = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    sc_bg_mask_3d = (1.0 - in_face.float()).reshape(b, 1, n)
    bg_frac = gsum(sc_bg_mask_3d.sum()) / (global_batch_size(b) * n) + 1e-5

    def bg_demean(mc, sc):
        scbg = sc * sc_bg_mask_3d
        mean = ((_mean_over_batch_and_tokens(mc)
                 + _mean_over_batch_and_tokens(scbg) / bg_frac) / 2.0).detach()
        return mc - mean, (scbg - mean) * sc_bg_mask_3d

    mc_q, scbg_q = bg_demean(mc_q, sc_q)
    # matching probabilities, normalized over the subject-comp tokens
    sc_attns = {"ssfg": torch.softmax(torch.einsum("bcn,bcm->bnm", scfg_q, ssfg_q), dim=1),
                "mc": torch.softmax(torch.einsum("bcn,bcm->bnm", scbg_q, mc_q), dim=1)}
    eye = torch.eye(n, device=dev).expand(b, n, n)
    # the flows, once a call from the demeaned q features, reused over
    # outfeat and attn_out (`ldm/util.py:2352-2372`); no gradient, as JAX's
    # stop_gradient
    flows = flow_attns = None
    if flow_fn is not None:
        with torch.no_grad():
            flows = {"ssfg": flow_fn(ssfg_q, scfg_q, h, w, 0.0).float(),
                     "mc": flow_fn(mc_q, scbg_q, h, w, small_motion_ignore_thres).float()}
            flow_attns = {k: flow2attn(v, h, w) for k, v in flows.items()}
    margins = {"ssfg": (10.0, 1.02), "mc": (10.0, 1.1)}  # `:2455-2463`
    losses = {f"sc_to_{name}_sparse_attns_distill": torch.zeros((), device=dev)
              for name in ("ssfg", "mc")}
    accum: dict[str, list] = {}
    discard_flags = []
    for feat in (ca_outfeat, ca_attn_out):
        ss_f, sc_f, _, mc_f = feat.chunk(4)
        ssfg_f = _crop_resize_feat(to4d(ss_f), ss_face_bboxes).reshape(b, c, n)
        scfg_f = _crop_resize_feat(to4d(sc_f), sc_face_bboxes).reshape(b, c, n)
        f_fg_mean = _mean_over_batch_and_tokens(torch.cat([ssfg_f, scfg_f])).detach()
        ssfg_f = ssfg_f - f_fg_mean
        scfg_f = scfg_f - f_fg_mean
        mc_f, scbg_f = bg_demean(mc_f, sc_f)
        srcs = {"ssfg": scfg_f, "mc": scbg_f}
        targets = {"ssfg": ssfg_f.detach(), "mc": mc_f.detach()}
        for name in ("ssfg", "mc"):
            target = targets[name].transpose(1, 2)  # [B, N, C]
            sameloc = srcs[name].transpose(1, 2)
            if flows is not None:
                # `reconstruct_feat_with_matching_flow`: the source warped onto
                # the target's layout by the target→source flow
                flow_recon = backward_warp_by_flow(to4d(srcs[name]), flows[name]).reshape(
                    b, c, n).transpose(1, 2)
            else:
                flow_recon = sameloc  # the margins keep this candidate out
            cands = {"attn_agg": _recon_with_attn(srcs[name], sc_attns[name]),
                     "flow": flow_recon, "sameloc": sameloc}
            token_losses = {k: ((v - target) ** 2).mean(-1) for k, v in cands.items()}
            m_attn, m_flow = margins[name]
            stacked = torch.stack([token_losses["attn_agg"] * m_attn,
                                   token_losses["flow"] * m_flow, token_losses["sameloc"]])
            loss_min = gmean(stacked.min(dim=0).values)
            # sparse-attention distillation toward the better sparse scheme,
            # weighted by its (detached) advantage; both are the identity
            # without a flow
            adv = (stacked[0:1] - stacked[1:]).detach()  # [2, B, N]
            if flow_attns is not None:
                # per target token the flow-warped identity or the same
                # location, by the larger advantage (`ldm/util.py:2484-2491`)
                sparse = torch.where((adv[0] >= adv[1])[:, None, :], flow_attns[name], eye)
            else:
                sparse = eye
            adv_best = adv.max(dim=0).values
            adv_n = (adv_best - adv_best.mean(-1, keepdim=True)) / (
                adv_best.std(-1, unbiased=False, keepdim=True) + 1e-5)
            weights = torch.sigmoid(5.0 * adv_n)[:, None, :]  # [B, 1, N]
            ens = sparse + sc_attns[name]
            w_sc = torch.einsum("bon,bmn->bom", weights, ens).detach().transpose(1, 2)
            loss_sparse = gmean((sparse - sc_attns[name]).abs() * w_sc)
            # the loss scale's cap and the discard gate (`:2706-2737`)
            thres = threses[name]
            raw = loss_min.detach()
            keep = (raw < thres * recon_max_scale_of_threses).float()
            scale = torch.clamp(thres / (raw + 1e-6), max=1.0) * keep
            discard_flags.append(1.0 - keep)
            for k in ("attn_agg", "flow", "sameloc"):
                accum.setdefault(f"sc_recon_{name}_{k}", []).append(gmean(token_losses[k])
                                                                    * scale)
            accum.setdefault(f"sc_recon_{name}_min", []).append(loss_min * scale)
            accum.setdefault(f"sc_to_{name}_sparse_attns_distill", []).append(loss_sparse)
    for k, vals in accum.items():
        losses[k] = sum(vals) / len(vals)
    losses["discarded_loss_ratio"] = sum(discard_flags) / len(discard_flags)
    return losses


def calc_comp_subj_bg_preserve_loss(ca_layers_activations: dict, ss_face_bboxes, sc_face_bboxes,
                                    flow_fn: Callable | None = None,
                                    small_motion_ignore_thres: float = 0.3,
                                    layer_weights: dict | None = None,
                                    sc_recon_ssfg_loss_scale: float = 0.1,
                                    sc_recon_mc_loss_scale: float = 0.2,
                                    do_sc_fg_faces_suppress=0.0, sc_face_shrink_ratio=1.0):
    """→ (loss_comp_fg_bg_preserve, metrics). `do_sc_fg_faces_suppress` may be
    a {0, 1} tensor gate (it zeroes the face term, `ldm/util.py:1987-1990`);
    `sc_face_shrink_ratio` shrinks the subject-comp face box of the
    background mask."""
    layer_weights = layer_weights or {22: 1 / 3, 23: 1 / 3, 24: 1 / 3}
    qs = ca_layers_activations["q2"]
    dev = next(iter(qs.values())).device
    gate = torch.as_tensor(do_sc_fg_faces_suppress, dtype=torch.float32, device=dev)
    ssfg_scale = sc_recon_ssfg_loss_scale * (1.0 - gate)
    total = torch.zeros((), device=dev)
    metrics: dict = {}
    for layer, w in layer_weights.items():
        if layer not in qs:
            continue
        outfeat = ca_layers_activations["outfeat"][layer]
        if outfeat.dim() == 4:  # [4B, C, H, W] → [4B, C, N]
            hh, ww = outfeat.shape[-2:]
            outfeat = outfeat.reshape(*outfeat.shape[:2], -1)
        else:
            hh = ww = int(round(outfeat.shape[-1] ** 0.5))
        losses = calc_elastic_matching_loss(
            qs[layer], ca_layers_activations["attn_out"][layer], outfeat, hh, ww,
            ss_face_bboxes, sc_face_bboxes, flow_fn=flow_fn,
            small_motion_ignore_thres=small_motion_ignore_thres,
            sc_face_shrink_ratio=sc_face_shrink_ratio)
        total = total + w * (losses["sc_recon_ssfg_min"] * ssfg_scale
                             + losses["sc_recon_mc_min"] * sc_recon_mc_loss_scale)
        metrics.update({f"l{layer}_{k}": v for k, v in losses.items()})
    return total, metrics


def calc_dyn_loss_scale(loss, base_loss_and_scale: tuple[float, float],
                        ref_loss_and_scale: tuple[float, float],
                        valid_scale_range: tuple[float, float] = (0.0, 100.0)) -> torch.Tensor:
    """Linear loss → scale interpolation, clipped (`ldm/util.py:1485-1520`)."""
    base_loss, base_scale = base_loss_and_scale
    ref_loss, ref_scale = ref_loss_and_scale
    rel = (torch.as_tensor(loss, dtype=torch.float32) - base_loss) / (ref_loss - base_loss)
    return torch.clamp(rel * (ref_scale - base_scale) + base_scale, *valid_scale_range)


def calc_sc_rep_attn_distill_loss(ca_layers_activations: dict, subj_mask_1b, prompt_emb_mask_4b,
                                  prompt_pad_mask_4b, sc_fg_mask_percent, fg_thres: float = 0.1,
                                  layer_weights: dict | None = None) -> dict:
    """attn [4B, H, Nq, S], k / v [4B, C, S] by layer; subj_mask_1b [B, S];
    the 4-block prompt masks [4B, S, 1] → the five rep-distill losses, all 0
    where the face area is under `fg_thres`."""
    layer_weights = layer_weights or {23: 0.5, 24: 0.5}
    attns = ca_layers_activations["attn"]
    dev = next(iter(attns.values())).device
    gate = (torch.as_tensor(sc_fg_mask_percent, device=dev) >= fg_thres).float()
    _, sc_emb, _, _ = prompt_emb_mask_4b[..., 0].float().chunk(4)
    _, sc_pad, _, _ = prompt_pad_mask_4b[..., 0].float().chunk(4)
    subj = subj_mask_1b.float()
    nonsubj = torch.clamp(sc_emb * (1.0 - subj) + sc_pad, 0.0, 1.0)[:, None, :]
    out = {k: torch.zeros((), device=dev) for k in (
        "subj_attn", "subj_k", "nonsubj_k", "subj_v", "nonsubj_v")}

    def masked_mse(a, ref, m):
        d = (a - ref.detach()) ** 2
        m = m.expand_as(d)
        return gsum((d * m).sum()) / (gsum(m.sum()) + 1e-6)

    for layer, w in layer_weights.items():
        if layer not in attns:
            continue
        attn = attns[layer].float()
        s = attn.shape[-1]
        _, sc_attn, sc_rep_attn, _ = attn.chunk(4)
        out["subj_attn"] = out["subj_attn"] + gmean((sc_attn - sc_rep_attn.detach()) ** 2) \
            * (s * 10) * w
        ss_k, sc_k, _, mc_k = ca_layers_activations["k"][layer].float().chunk(4)
        ss_v, sc_v, _, mc_v = ca_layers_activations["v"][layer].float().chunk(4)
        sm = subj[:, None, :]
        out["subj_k"] = out["subj_k"] + masked_mse(sc_k, ss_k, sm) * w
        out["subj_v"] = out["subj_v"] + masked_mse(sc_v, ss_v, sm) * w
        out["nonsubj_k"] = out["nonsubj_k"] + masked_mse(sc_k, mc_k, nonsubj) * w
        out["nonsubj_v"] = out["nonsubj_v"] + masked_mse(sc_v, mc_v, nonsubj) * w
    return {k: v * gate for k, v in out.items()}


def calc_subj_attn_cross_t_diff_loss(ca_layers_activations: dict,
                                     future_ca_layers_activations: dict, subj_mask_1b,
                                     layer_weights: dict | None = None) -> torch.Tensor:
    """The subject-comp block's subject-token attention against the next
    step's (detached), ×10, layer-weighted (`ldm/util.py:2123-2146`)."""
    layer_weights = layer_weights or {23: 0.5, 24: 0.5}
    m = subj_mask_1b.float()[:, None, None, :]
    total = torch.zeros((), device=m.device)
    for layer, w in layer_weights.items():
        cur = ca_layers_activations["attn"].get(layer)
        fut = future_ca_layers_activations["attn"].get(layer)
        if cur is None or fut is None:
            continue
        d = (cur.float().chunk(4)[1] - fut.float().chunk(4)[1].detach()) ** 2
        mm = m.expand_as(d)
        total = total + w * 10.0 * gsum((d * mm).sum()) / (gsum(mm.sum()) + 1e-6)
    return total
