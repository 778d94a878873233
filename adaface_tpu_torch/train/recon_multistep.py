"""The ArcFace adversarial gradient of the recon iteration, and the
Laplacian-variance sharpness gate of the comp identity losses.

Counterpart of `calc_arcface_adv_grad` and `var_of_laplacian` in
`adaface_tpu/train/recon_multistep.py` (`:85-121`, the reference's
`ddpm.py:2536-2581`; `:71`, `ldm/util.py:786-801`). The adversarial gradient
is the gradient, with respect to the input latents, of the dropped-out
squared face embedding of their decoded image, masked to the face box in
latent coordinates; the recon step subtracts it, scaled, from the next
step's noise when its adversarial branch is drawn
(`recon_step._adv_attacked_noise`). `recon_multistep_denoise`,
`redenoise_subj_single` and the smoothed gradient have no caller in the JAX
training path and wait in ROADMAP §1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaface_tpu_torch.models.vae import vae_decode
from adaface_tpu_torch.train.face_losses import embed_face_crops


def calc_arcface_adv_grad(arcface, vae_decoder, x_start: torch.Tensor,
                          face_bboxes: torch.Tensor, pixel_bboxes: torch.Tensor,
                          dropout_u: torch.Tensor, dropout_p: float = 0.3) -> torch.Tensor:
    """∂/∂x_start of mean((dropout(emb))²), emb the ArcFace embedding of the
    face crop of the decoded x_start (gradient mask 0.9 on the crop's
    center), masked to `face_bboxes` [B, 4] (latent coords). x_start
    [B, 4, h, w]; pixel_bboxes [B, 4] the crops' boxes; dropout_u [B, 512]
    U[0, 1) draws: an embedding element is kept where u < 1 - dropout_p (the
    JAX package's `bernoulli`). The decode runs in the decoder's dtype, its
    activations recomputed in the backward. → [B, 4, h, w] in x_start's
    dtype."""
    with torch.enable_grad():
        x = x_start.detach().requires_grad_(True)
        img = vae_decode(vae_decoder, x)
        emb, _ = embed_face_crops(arcface, img, pixel_bboxes, (0.9, 0.9))
        keep = dropout_u.to(emb.device) < 1.0 - dropout_p
        emb = torch.where(keep, emb / (1.0 - dropout_p), torch.zeros_like(emb))
        (adv_grad,) = torch.autograd.grad((emb ** 2).mean(), x)
    b, _, h, w = x_start.shape
    ys = torch.arange(h, device=x_start.device)[None, :, None]
    xs = torch.arange(w, device=x_start.device)[None, None, :]
    x0, y0, x1, y1 = (face_bboxes[:, i, None, None] for i in range(4))
    mask = (xs >= x0) & (xs < x1) & (ys >= y0) & (ys < y1)
    return adv_grad * mask[:, None].to(adv_grad.dtype)


RGB_TO_GRAY = (0.299, 0.587, 0.114)


def var_of_laplacian(images: torch.Tensor, scale: float = 10.0) -> torch.Tensor:
    """Per-image variance (unbiased, as torch's `.var()` the reference
    calibrated on) of the 3x3 Laplacian of 10× the grey image; images
    [B, 3, H, W] → [B] fp32."""
    w = torch.tensor(RGB_TO_GRAY, device=images.device)
    gray = (images.float() * w[None, :, None, None]).sum(1, keepdim=True)
    k = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                     device=images.device)[None, None]
    lap = F.conv2d(gray * scale, k, padding=1)
    return lap.flatten(1).var(dim=1, unbiased=True)
