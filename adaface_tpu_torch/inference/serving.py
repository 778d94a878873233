"""Continuous-batching serving for personalized generation.

Counterpart of `adaface_tpu/inference/serving.py`, built around two ideas:

1. **Per-sample ada injection.** Instead of writing a subject's ada
   embeddings into the shared token table, each request's embeddings are
   spliced into its own token embeddings (`CLIPTextModel.forward(input_embs=
   ...)`). Requests for different subjects therefore share one device batch.

2. **Continuous batching at denoise-step granularity.** A fixed pool of N
   slots each hold (latent, cond/uncond context, step index, guidance
   scales). One step advances every active slot by one DDIM step; slots are
   at different timesteps, and their timestep, alphas and guidance scale are
   gathered from tables on the device by the slot's step index. A slot that
   finishes is decoded and refilled from the queue at once, so the UNet
   batch stays full: throughput is the batch-N envelope, a request's latency
   one trajectory. The UNet runs with the modules' trained adapters
   (`PipelineModules.attn_lora`, `ffn_lora`), as the JAX batcher's step does;
   an ensemble of UNets is refused, as there.

Completion is tracked on the host (every request runs exactly
`num_inference_steps` steps from admission), so `run()` reads nothing back
from the device between steps. The step writes the pool's state in place
into buffers allocated once, builds no tensor from a host number and never
synchronises: what it launches depends on no value on the device, so it can
be captured in a CUDA graph as it is. Whoever holds a `SlotState` must
leave its tensors where they are: rebinding a field to a new tensor would
take the step's work out of the buffers.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from adaface_tpu_torch.inference.pipeline import PipelineModules
from adaface_tpu_torch.ops.samplers import DDIMConfig, _alpha_tables, ddim_step


@dataclasses.dataclass
class Request:
    """One generation request. `ada_embs` [K, D] are the subject's ada token
    embeddings (from `prepare_adaface_embeddings(update_text_encoder=False)`);
    None for a plain prompt. `latents` [4, h, w] is the initial noise; None
    draws it from a `torch.Generator` seeded with `seed` on the batcher's
    device."""

    prompt: str
    negative_prompt: str = ""
    ada_embs: torch.Tensor | None = None
    guidance_scale: float = 6.0
    guidance_scale_min: float | None = None
    seed: int = 0
    latents: torch.Tensor | None = None
    # CLIP-skip weights over the last k hidden layers
    skip_weights: Sequence[float] | None = None
    request_id: int = -1  # assigned by submit()


@dataclasses.dataclass(frozen=True)
class SlotState:
    """The slot pool on the device: buffers allocated once and written in
    place by admission and by every step."""

    latents: torch.Tensor  # [N, 4, h, w]
    ctx: torch.Tensor  # [2N, S, D]: the UNet's context, [uncond; cond]
    step: torch.Tensor  # [N] int64, index into the timestep table
    active: torch.Tensor  # [N] int64, 1 while the slot holds a request
    hi: torch.Tensor  # [N] f32 guidance scale at step 0
    lo: torch.Tensor  # [N] f32 guidance scale at the last step

    @property
    def uncond(self) -> torch.Tensor:
        return self.ctx[:self.ctx.shape[0] // 2]

    @property
    def cond(self) -> torch.Tensor:
        return self.ctx[self.ctx.shape[0] // 2:]

    def tensors(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


class ContinuousBatcher:
    def __init__(self, modules: PipelineModules, num_slots: int = 8,
                 num_inference_steps: int = 25,
                 placeholder_token_ids: Sequence[int] | None = None,
                 height: int = 512, width: int = 512, dtype=torch.bfloat16):
        if isinstance(modules.unet, (list, tuple)):
            raise ValueError("the continuous batcher serves one UNet, not an ensemble "
                             "(as the JAX batcher)")
        self.m = modules
        self.num_slots = num_slots
        self.steps = num_inference_steps
        self.dtype = dtype
        self.device = modules.device
        ph = list(placeholder_token_ids or [])
        self._ph_ids = (torch.as_tensor(ph, dtype=torch.long, device=self.device)
                        if ph else None)
        s = modules.vae.cfg.spatial_scale
        self.latent_hw = (height // s, width // s)
        self.seq_len = modules.text_encoder.position_embedding.shape[0]

        ts, alpha_t, alpha_prev = _alpha_tables(
            modules.schedule, DDIMConfig(num_inference_steps=num_inference_steps))
        self._ts, self._alpha_t, self._alpha_prev = (
            torch.from_numpy(a).to(self.device) for a in (ts, alpha_t, alpha_prev))

        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * num_slots
        self._remaining = np.zeros(num_slots, np.int64)  # host bookkeeping
        self._next_id = 0
        self._state = self._empty_state()

    # ---------------------------------------------------------------- state
    def _empty_state(self) -> SlotState:
        n, (h, w), dev = self.num_slots, self.latent_hw, self.device
        d = self.m.text_encoder.cfg.hidden_size
        return SlotState(
            latents=torch.zeros((n, 4, h, w), dtype=self.dtype, device=dev),
            ctx=torch.zeros((2 * n, self.seq_len, d), dtype=self.dtype, device=dev),
            step=torch.zeros((n,), dtype=torch.long, device=dev),
            active=torch.zeros((n,), dtype=torch.long, device=dev),
            hi=torch.ones((n,), dtype=torch.float32, device=dev),
            lo=torch.ones((n,), dtype=torch.float32, device=dev))

    # ------------------------------------------------------------- encoding
    def _encode_request(self, ids, nids, ada, skip_w):
        """cond/uncond contexts [1, S, D] with per-sample ada injection.
        ids/nids [1, S]; ada [K, D] fp32 or None; skip_w [k] or None."""
        te = self.m.text_encoder
        embs = te.token_embedding[ids]
        if ada is not None and self._ph_ids is not None:
            match = ids[..., None] == self._ph_ids[None, None]  # [1, S, K]
            inj = torch.einsum("bsk,kd->bsd", match.to(ada.dtype), ada)
            embs = torch.where(match.any(-1)[..., None], inj,
                               embs.to(ada.dtype)).to(embs.dtype)
        cond = te(ids, input_embs=embs, skip_weights=skip_w)
        uncond = te(nids, skip_weights=skip_w)
        return cond.to(self.dtype), uncond.to(self.dtype)

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def _step(self) -> None:
        """One DDIM step for every slot, each at its own timestep; inactive
        slots keep their latents. Writes `latents` and `step` in place."""
        s, n_steps = self._state, self.steps
        x, idx = s.latents, s.step
        t = self._ts[idx]
        eps2 = self.m.unet_eps(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), s.ctx)
        eps_u, eps_c = eps2.float().chunk(2, dim=0)
        # per-slot dual guidance, linear from hi to lo over the trajectory
        frac = idx.float() / max(n_steps - 1, 1)
        scale = s.hi + (s.lo - s.hi) * frac
        eps = eps_u + scale[:, None, None, None] * (eps_c - eps_u)
        a_t = self._alpha_t[idx][:, None, None, None]
        a_p = self._alpha_prev[idx][:, None, None, None]
        x_prev, _ = ddim_step(x, eps, a_t, a_p)
        keep = (s.active > 0)[:, None, None, None]
        s.latents.copy_(torch.where(keep, x_prev.to(x.dtype), x))
        s.step.add_(s.active).clamp_(max=n_steps - 1)

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> int:
        req.request_id = self._next_id
        self._next_id += 1
        self._queue.append(req)
        return req.request_id

    @torch.inference_mode()
    def _admit(self, slot: int, req: Request) -> None:
        tok, dev = self.m.tokenizer, self.device
        encode = lambda text: torch.as_tensor(tok([text], max_length=self.seq_len),
                                              dtype=torch.long, device=dev)
        ada = (None if req.ada_embs is None
               else torch.as_tensor(req.ada_embs).to(dev, torch.float32))
        skip_w = (None if req.skip_weights is None
                  else torch.as_tensor(req.skip_weights, dtype=torch.float32, device=dev))
        cond, uncond = self._encode_request(encode(req.prompt), encode(req.negative_prompt),
                                            ada, skip_w)
        h, w = self.latent_hw
        if req.latents is not None:
            if tuple(req.latents.shape) != (4, h, w):
                raise ValueError(f"request latents must be {(4, h, w)}, got "
                                 f"{tuple(req.latents.shape)}")
            latent = req.latents
        else:
            latent = torch.randn((4, h, w), device=dev,
                                 generator=torch.Generator(dev).manual_seed(req.seed))
        s = self._state
        s.latents[slot].copy_(latent)
        s.cond[slot].copy_(cond[0])
        s.uncond[slot].copy_(uncond[0])
        s.step[slot] = 0
        s.active[slot] = 1
        s.hi[slot] = req.guidance_scale
        s.lo[slot] = (req.guidance_scale if req.guidance_scale_min is None
                      else req.guidance_scale_min)
        self._slot_req[slot] = req
        self._remaining[slot] = self.steps

    def _fill_slots(self) -> None:
        for slot in range(self.num_slots):
            if self._slot_req[slot] is None and self._queue:
                self._admit(slot, self._queue.popleft())

    # ----------------------------------------------------------------- run
    @torch.inference_mode()
    def run(self) -> Iterator[tuple[int, torch.Tensor]]:
        """Drain the queue; yields (request_id, image [3, H, W] float32 in
        [0, 1], on the batcher's device) as each request finishes. A slot is
        refilled the step it frees, so the UNet runs at full batch while
        work remains. Nothing is read back from the device on the way: the
        images are ready once the device has caught up (a copy to the host
        waits for that)."""
        while self._queue or any(r is not None for r in self._slot_req):
            self._fill_slots()
            busy = self._remaining > 0
            n = int(self._remaining[busy].min())  # steps to the next completion
            for _ in range(n):
                self._step()
            self._remaining[busy] -= n
            for slot in np.nonzero(busy & (self._remaining == 0))[0]:
                slot = int(slot)
                req = self._slot_req[slot]
                img = self.m.vae(self._state.latents[slot][None]).float()[0]
                self._slot_req[slot] = None
                self._state.active[slot] = 0
                yield req.request_id, ((img + 1.0) / 2.0).clamp(0.0, 1.0)

    def generate_all(self, requests: Sequence[Request]) -> dict[int, torch.Tensor]:
        """Submit everything, run to completion."""
        for r in requests:
            self.submit(r)
        return dict(self.run())
