"""Training losses (stage-1 recon and distillation core).

Counterpart of `adaface_tpu/train/losses.py`, pure tensor functions with
mask tensors in place of index tuples:

- `calc_recon_loss`: fg/bg-weighted masked MSE between predicted and target
  noise;
- `calc_recon_and_suppress_losses`: recon, class-guided background recon
  and the subject-attention background suppression
  (`calc_subj_masked_bg_suppress_loss`);
- `calc_prompt_emb_delta_loss` with `calc_ref_cosine_loss`: align
  (subj_comp − subj_single) with (cls_comp − cls_single) by ortho-subtract
  and a masked cosine against a gradient-scaled, demeaned reference;
- `calc_attn_norm_loss`: subject-token attention-score norms of the sc and
  mc halves (comp distillation).
"""

from __future__ import annotations

import torch

from adaface_tpu_torch.ops.resize import resize_bilinear_half_pixel, resize_nearest
from adaface_tpu_torch.utils.tensor import gen_gradient_scaler, ortho_subtract


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mask = mask.float()
    return (x.float() * mask).sum() / (mask.sum() + eps)


def calc_recon_loss(noise_pred, noise_gt, img_mask=None, fg_mask=None, instance_weights=None,
                    fg_pixel_weight: float = 1.0, bg_pixel_weight: float = 1.0):
    """fg/bg-weighted masked MSE; masks [B, 1, H, W], instance weights [B]."""
    if img_mask is None:
        img_mask = torch.ones_like(noise_pred[:, :1])
    if fg_mask is None:
        fg_mask = torch.ones_like(noise_pred[:, :1])
    if instance_weights is not None:
        iw = instance_weights.reshape(-1, 1, 1, 1).float()
        fg_mask = fg_mask * iw
        img_mask = img_mask * iw
    err = ((noise_pred * img_mask).float() - (noise_gt * img_mask).float()) ** 2
    w_fg = (fg_mask * img_mask * fg_pixel_weight).expand_as(err)
    w_bg = ((1.0 - fg_mask) * img_mask * bg_pixel_weight).expand_as(err)
    num = (err * w_fg).sum() + (err * w_bg).sum()
    return num / (w_fg.sum() + w_bg.sum() + 1e-6)


def calc_subj_masked_bg_suppress_loss(ca_attn: dict, subj_mask, fg_mask,
                                      layer_weights: dict | None = None,
                                      bg_attn_tolerance: float = 0.02):
    """Suppress subject-token attention outside the fg mask. ca_attn: layer →
    [B, H, Nq, S] probabilities; subj_mask [B, S]; fg_mask [B, 1, h, w]."""
    layer_weights = {23: 0.5, 24: 0.5} if layer_weights is None else layer_weights
    if subj_mask is None or fg_mask is None or not ca_attn:
        return torch.zeros(())
    total = torch.zeros((), device=fg_mask.device)
    for layer, w in layer_weights.items():
        if layer not in ca_attn:
            continue
        attn = ca_attn[layer].float()
        subj_attn = (attn * subj_mask[:, None, None, :]).sum(-1)  # [B, H, Nq]
        n = subj_attn.shape[-1]
        side = int(round(n ** 0.5))
        # the elementwise max of nearest and bilinear resizes, binarized:
        # a cell that overlaps the fg at all counts as fg
        fgf = fg_mask.float()
        fg = torch.maximum(resize_nearest(fgf, (side, side)),
                           resize_bilinear_half_pixel(fgf, (side, side), spatial_axes=(-2, -1)))
        bg = 1.0 - (fg.reshape(fg.shape[0], 1, n) > 1e-6).float()
        excess = subj_attn * bg - bg_attn_tolerance
        total = total + w * masked_mean(excess, excess > 0)
    return total


def calc_recon_and_suppress_losses(noise_gt, noise_pred, noise_pred_cls,
                                   face_detected_inst_weights, ca_attn, subj_mask, img_mask,
                                   fg_mask, bg_pixel_weight: float,
                                   recon_on_pure_noise: bool = False):
    """→ (loss_recon, loss_recon_cls, loss_subj_mb_suppress)."""
    zero = torch.zeros((), device=noise_pred.device)
    loss_recon = zero if recon_on_pure_noise else calc_recon_loss(
        noise_pred, noise_gt, img_mask, fg_mask, instance_weights=face_detected_inst_weights,
        fg_pixel_weight=1.0, bg_pixel_weight=bg_pixel_weight)
    if noise_pred_cls is not None:
        bg_mask = 1.0 - fg_mask if fg_mask is not None else None
        loss_recon_cls = calc_recon_loss(
            noise_pred, noise_pred_cls.detach(), img_mask, bg_mask,
            instance_weights=face_detected_inst_weights, fg_pixel_weight=1.0,
            bg_pixel_weight=bg_pixel_weight)
    else:
        loss_recon_cls = zero
    loss_mb = calc_subj_masked_bg_suppress_loss(ca_attn, subj_mask, fg_mask)
    return loss_recon, loss_recon_cls, loss_mb


def demean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(dim=-1, keepdim=True)


def calc_ref_cosine_loss(delta, ref_delta, emb_mask=None, exponent: float = 2.0,
                         do_demeans=(False, False), ref_grad_scale: float = 0.0,
                         aim_to_align: bool = True):
    """Masked cosine of delta against a gradient-scaled reference raised to a
    sign-keeping power, over the last axis; emb_mask [..., S] weights."""
    d, r = delta.float(), ref_delta.float()
    if do_demeans[0]:
        d = demean(d)
    if do_demeans[1]:
        r = demean(r)
    r = gen_gradient_scaler(ref_grad_scale)(r)
    r_pow = r * r.abs() ** (exponent - 1.0)

    def safe_norm(x):
        # eps inside the square root: a zero delta (shared prompt prefixes,
        # padding) would give NaN gradients even where masked out
        return ((x * x).sum(-1) + 1e-12).sqrt()

    cos = (d * r_pow).sum(-1) / (safe_norm(d) * safe_norm(r_pow) + 1e-8)
    # F.cosine_embedding_loss: target +1 → 1 - cos; target -1 → max(0, cos)
    per_tok = 1.0 - cos if aim_to_align else torch.relu(cos)
    if emb_mask is not None:
        w = emb_mask.float()
        return (per_tok * w).sum() / (w.sum() + 1e-6)
    return per_tok.mean()


def calc_prompt_emb_delta_loss(prompt_embeddings, prompt_emb_mask=None,
                               cls_delta_grad_scale: float = 0.05):
    """Align (subj_comp − subj_single) with (cls_comp − cls_single) over the
    4 blocks [ss, sc, cs, cc] of prompt_embeddings [4B, S, D]; the mask
    [4B, S, 1] leaves out BOS and weights by the ss and sc masks."""
    ss, sc, cs, cc = prompt_embeddings.chunk(4, dim=0)
    weights = None
    if prompt_emb_mask is not None:
        m = prompt_emb_mask.float().clone()
        m[:, 0] = 0.0  # BOS
        m_ss, m_sc, _, _ = m.chunk(4, dim=0)
        weights = ((m_ss + m_sc) ** 2 / 4.0)[..., 0]
    return calc_ref_cosine_loss(ortho_subtract(sc, ss), ortho_subtract(cc, cs), emb_mask=weights,
                                do_demeans=(False, True), ref_grad_scale=cls_delta_grad_scale,
                                aim_to_align=True)


def calc_attn_norm_loss(ca_attn_scores: dict, subj_mask, layer_weights: dict | None = None):
    """Align the subject tokens' attention-score norms of the sc half with the
    (detached) mc half; ca_attn_scores: layer → [2B, H, Nq, S]."""
    layer_weights = {23: 1.0, 24: 1.0} if layer_weights is None else layer_weights
    if not ca_attn_scores:
        return torch.zeros(())
    total, wsum = 0.0, 0.0
    for layer, w in layer_weights.items():
        if layer not in ca_attn_scores:
            continue
        sc, mc = ca_attn_scores[layer].float().chunk(2, dim=0)
        m = subj_mask[:, None, None, :]
        sc_norm = (sc * m).sum(-1) / (m.sum(-1) + 1e-6)
        mc_norm = ((mc * m).sum(-1) / (m.sum(-1) + 1e-6)).detach()
        total = total + w * ((sc_norm - mc_norm) ** 2).mean()
        wsum += w
    return total / max(wsum, 1e-6)
