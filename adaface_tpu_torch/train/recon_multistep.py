"""Multi-step recon denoising, the ArcFace adversarial gradient, the
subject-single re-denoise and the smoothed gradient.

Counterpart of `adaface_tpu/train/recon_multistep.py`:
- `smooth_tensor` / `smooth_grad` (`:44-64`, `SmoothGrad`,
  `ldm/util.py:827-870`): a depthwise 3x3 smoothing in fp32, and an
  autograd Function whose forward is the identity and whose backward
  smooths the cotangent;
- `var_of_laplacian` (`:71`, `ldm/util.py:786-801`): the sharpness gate of
  the comp identity losses;
- `calc_arcface_adv_grad` (`:85-121`, `ddpm.py:2536-2581`): the gradient,
  with respect to the input latents, of the dropped-out squared face
  embedding of their decoded image, masked to the face box in latent
  coordinates; the recon step subtracts it, scaled, from the next step's
  noise when its adversarial branch is drawn
  (`recon_step._adv_attacked_noise`);
- `recon_multistep_denoise` (`:123`, `ddpm.py:1753-1917`) and
  `redenoise_subj_single` (`:169`, `ddpm.py:2093-2271`), which have no
  caller in the JAX training path either. Their noise comes from `Draws` in
  the order JAX splits its key: one normal a step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from adaface_tpu_torch.models.vae import vae_decode
from adaface_tpu_torch.train.face_losses import bilinear_crop, embed_face_crops
from adaface_tpu_torch.utils.tensor import Draws, device_constant

# the 3x3 smoothing kernels by their centre weight (`SMOOTH_KERNELS`, `:37-42`)
SMOOTH_CENTRE = {1: (1.0, 9.0), 2: (2.0, 10.0), 3: (3.0, 11.0), 4: (4.0, 12.0)}


def smooth_tensor(x: torch.Tensor, kernel_center_weight: int = 2) -> torch.Tensor:
    """Depthwise 3x3 smoothing of [B, C, H, W] with zero padding, in fp32,
    cast back to x's dtype (`smooth_tensor_34d`): the kernel is 1 around a
    centre of `kernel_center_weight`, over their sum."""
    centre, total = SMOOTH_CENTRE[kernel_center_weight]
    k = torch.ones((3, 3), device=x.device)
    k[1, 1] = centre
    b, c, h, w = x.shape
    y = F.conv2d(x.reshape(b * c, 1, h, w).float(), (k / total)[None, None], padding=1)
    return y.reshape(b, c, h, w).to(x.dtype)


class _SmoothGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel_center_weight):
        ctx.kernel_center_weight = kernel_center_weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return smooth_tensor(g, ctx.kernel_center_weight), None


def smooth_grad(x: torch.Tensor, kernel_center_weight: int = 2) -> torch.Tensor:
    """The identity, whose gradient is the cotangent smoothed by
    `smooth_tensor` (`smooth_grad`, a `jax.custom_vjp`)."""
    return _SmoothGrad.apply(x, kernel_center_weight)


def calc_arcface_adv_grad(arcface, vae_decoder, x_start: torch.Tensor,
                          face_bboxes: torch.Tensor, pixel_bboxes: torch.Tensor,
                          dropout_u: torch.Tensor, dropout_p: float = 0.3,
                          count: int | None = None) -> torch.Tensor:
    """∂/∂x_start of mean((dropout(emb))²), emb the ArcFace embedding of the
    face crop of the decoded x_start (gradient mask 0.9 on the crop's
    center), masked to `face_bboxes` [B, 4] (latent coords). x_start
    [B, 4, h, w]; pixel_bboxes [B, 4] the crops' boxes; dropout_u [B, 512]
    U[0, 1) draws: an embedding element is kept where u < 1 - dropout_p (the
    JAX package's `bernoulli`). `count` is the mean's divisor (emb's size by
    default; under data parallelism the global rows' 512 each, so a rank's
    rows get the gradient of the global mean). The decode runs in the
    decoder's dtype, its activations recomputed in the backward. →
    [B, 4, h, w] in x_start's dtype."""
    with torch.enable_grad():
        x = x_start.detach().requires_grad_(True)
        img = vae_decode(vae_decoder, x)
        emb, _ = embed_face_crops(arcface, img, pixel_bboxes, (0.9, 0.9))
        keep = dropout_u.to(emb.device) < 1.0 - dropout_p
        emb = torch.where(keep, emb / (1.0 - dropout_p), torch.zeros_like(emb))
        sq = emb ** 2
        (adv_grad,) = torch.autograd.grad(sq.mean() if count is None else sq.sum() / count, x)
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
    w = device_constant(RGB_TO_GRAY, images.device)
    gray = (images.float() * w[None, :, None, None]).sum(1, keepdim=True)
    k = device_constant(((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0)),
                        images.device)[None, None]
    lap = F.conv2d(gray * scale, k, padding=1)
    return lap.flatten(1).var(dim=1, unbiased=True)


def recon_multistep_denoise(model_fn, schedule, x_start: torch.Tensor, t0: torch.Tensor,
                            draws: Draws, num_priming_steps: int = 1, num_recon_steps: int = 2,
                            adv_grad: torch.Tensor | None = None, adv_grad_scale: float = 0.0):
    """→ (noise predictions, noises, x_ts [S, B, ...], ts [S, B]) of the
    `num_recon_steps` steps that carry gradients. `model_fn(x_t, t, grad)`
    → eps. The priming steps roll x_start forward without gradients; the
    adversarial gradient, scaled, moves the start of the recon steps; each
    step's timestep is 0.6 of the last one's, truncated (`ddpm.py:1855-1912`).
    `draws`: one normal of x_start's shape a step, priming steps first."""
    x0, t = x_start, t0
    for _ in range(num_priming_steps):
        noise = draws.normal(x0.shape, x0.device).to(x0.dtype)
        x_t = schedule.q_sample(x0, t, noise)
        with torch.no_grad():
            eps = model_fn(x_t, t, False)
        x0 = schedule.predict_start_from_noise(x_t, t, eps).detach()
        t = (t.float() * 0.6).long()
    if adv_grad is not None and adv_grad_scale > 0:
        x0 = x0 + adv_grad_scale * adv_grad.detach()
    preds, noises, x_ts, ts = [], [], [], []
    for _ in range(num_recon_steps):
        noise = draws.normal(x0.shape, x0.device).to(x0.dtype)
        x_t = schedule.q_sample(x0, t, noise)
        eps = model_fn(x_t, t, True)
        preds.append(eps)
        noises.append(noise)
        x_ts.append(x_t)
        ts.append(t)
        x0 = schedule.predict_start_from_noise(x_t, t, eps)
        t = (t.float() * 0.6).long()
    return torch.stack(preds), torch.stack(noises), torch.stack(x_ts), torch.stack(ts)


def redenoise_subj_single(model_fn, schedule, vae_decoder, ss_x_start: torch.Tensor,
                          sc_x_start: torch.Tensor, sc_face_bboxes: torch.Tensor, draws: Draws,
                          t_frac: float = 0.4, mix_ratio: float = 0.5,
                          lap_var_thres: float = 0.2):
    """Re-denoise the subject-single latents from a start mixed with the
    subject-comp face crop, gated by the decoded image's Laplacian variance
    (`redenoise_subj_single`, `ddpm.py:2093-2271`). sc_face_bboxes [B, 4] in
    latent coordinates; `draws`: one normal of the latents' shape. → (x0,
    quality weight [B]: 0 for a blurry instance, 1 otherwise)."""
    b, _, h, _ = ss_x_start.shape
    mixed = ss_x_start * (1 - mix_ratio) + bilinear_crop(sc_x_start, sc_face_bboxes, h) * mix_ratio
    t = torch.full((b,), int(schedule.num_timesteps * t_frac), dtype=torch.long,
                   device=mixed.device)
    noise = draws.normal(mixed.shape, mixed.device).to(mixed.dtype)
    x_t = schedule.q_sample(mixed, t, noise)
    x0 = schedule.predict_start_from_noise(x_t, t, model_fn(x_t, t, True))
    lap = var_of_laplacian(vae_decode(vae_decoder, x0.detach()))
    return x0, (lap > lap_var_thres).float()
