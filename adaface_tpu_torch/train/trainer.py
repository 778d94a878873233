"""Training orchestrator: unet-distill, recon and comp-distill iterations.

Counterpart of `Trainer` in `adaface_tpu/train/trainer.py`: Stage 1
(`configs/stage1-distill-arc2face.yaml`, every iteration unet-distill),
full-UNet finetuning (`configs/finetune-unet.yaml`, every iteration recon,
the UNet trained beside the SubjBasisGenerator) and Stage 2
(`configs/stage2-comp-distill.yaml`: comp-distill every 4th iteration,
unet-distill and recon between, the UNet's attention and FFN adapters
trained where the caller hands them in as `trainable["attn_lora"]` /
`["ffn_lora"]`). The dataset and its sampler (with the `skip_non_faces`
resampling), the host prep of each batch (VAE encode of the photos, face ID
→ image-prompt embeddings, the perturbed-ID and random-ID draws, the
4-block prompt batch or the comp iteration's 5-block one with sc_rep, the
Dirichlet CLIP-skip weights, the frozen teacher's denoising chain, for
recon and comp the host face detection on the inputs, for recon the
attn-LoRA gate, for comp the fallback boxes, the face-kept window and the
optional fg-seeded start), an optional background thread preparing batches
ahead of the step, one train step per iteration shape (comp keyed by its
priming count, recon by pure noise, the adversarial branch and the FFN
adapter, as the JAX trainer keys its graphs) with accumulation
(`optimizers.MultiSteps`), the NaN trap, the rolling face statistics, CSV
logging, the profiler hook and checkpoints (with `unet_lora_modules` when
adapters train and `unet_fp16.safetensors` when the UNet trains), and the
UNet hot-swap for comp iterations: with `frozen["comp_unet"]` (a state dict
on the host, `comp_unet_state_dict`) the planner's comp iterations run on
those weights, copied in place into the frozen UNet before the step and the
base weights copied back after it, so no second UNet is on the device. Data
parallelism waits in ROADMAP §1.

Random draws: each step's from two `torch.Generator`s seeded with
(cfg.seed, the step's planner seed), one for its batch and one for its loss,
so a step draws the same whatever thread prepares it. The dataset, the
planner, the CLIP-skip weights, the perturbation decision and the
fg-seeded start's plan draw from numpy RandomStates as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Any

import numpy as np
import torch

from adaface_tpu_torch.data.personalized import PersonalizedBase, SubjectSampler, collate_batch
from adaface_tpu_torch.id2ada.subj_basis_generator import (extend_prompt2token_proj_attention,
                                                          load_sbg_state_dict)
from adaface_tpu_torch.models.clip import layer_multipliers
from adaface_tpu_torch.models.vae import vae_encode
from adaface_tpu_torch.ops.resize import resize_nearest
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt, save_adaface_ckpt
from adaface_tpu_torch.train.comp_step import CompDistillConfig, make_comp_loss_fn
from adaface_tpu_torch.train.face_detect import HostFaceDetector
from adaface_tpu_torch.train.init_x import init_x_with_fg_from_training_image, plan_fg_init
from adaface_tpu_torch.train.iteration_plan import IterationPlanner
from adaface_tpu_torch.train.optimizers import jax_layouts, make_optimizer
from adaface_tpu_torch.train.prompt_batch import (build_4block_prompt_batch,
                                                  build_comp_prompt_batch, make_comp_rep_prompts)
from adaface_tpu_torch.train.recon_step import ReconStepConfig, make_recon_loss_fn
from adaface_tpu_torch.train.train_step import (LORA_KEYS, State, TrainConfig, init_state,
                                                lora_state_dicts, make_train_step,
                                                trainable_parameters, trainable_state_dicts,
                                                unet_distill_loss_fn)
from adaface_tpu_torch.utils.monitor import MetricsLogger, ProfilerHook, RollingStats
from adaface_tpu_torch.utils.tensor import Draws, anneal_perturb_embedding

Params = dict[str, Any]
ITER_TYPE_ID = {"recon": 0, "unet_distill": 1, "comp_distill": 2}


@dataclasses.dataclass
class TrainerConfig:
    data_roots: list[str] = dataclasses.field(default_factory=list)
    log_dir: str = "logs/run"
    batch_size: int = 4
    max_steps: int = 120_000
    accum_steps: int = 2
    ckpt_every: int = 500
    optimizer: str = "cadamw"
    lr: float = 1e-5
    warmup_steps: int = 600
    grad_clip: float = 0.2
    # prodigy: d_coef, scheduler_cycles, scheduler_type ('Linear',
    # 'CosineAnnealingWarmRestarts', 'CyclicLR')
    optimizer_kwargs: dict = dataclasses.field(default_factory=dict)
    comp_distill_iter_gap: int = 0
    unet_distill_iter_gap: int = 1
    num_vectors_per_subj_token: int = 16
    image_size: int = 512
    seed: int = 0
    # last-3 CLIP hidden states: the Dirichlet alpha when randomized, else
    # normalised into fixed weights
    clip_skip_weights: tuple = (1.0, 2.0, 2.0)
    randomize_clip_skip_weights: bool = True
    profile: bool = False
    # distill on a random identity; repeat the first instance across the
    # batch and noise the other image-prompt embeddings
    p_gen_rand_id_for_id2img: float = 0.0
    p_perturb_face_id_embs: float = 0.2
    perturb_face_id_embs_std_range: tuple = (0.3, 0.6)
    unet_distill_steps_range: tuple = (2, 4)  # the teacher's step buckets
    echo_every: int = 50
    # full-UNet finetuning: the UNet joins the trainable set and checkpoints
    # export it as fp16 safetensors (`ddpm.py:4041-4062`)
    unfreeze_unet: bool = False
    # batches prepared ahead by a background thread (VAE, face ID, teacher)
    prefetch: int = 2
    # the recon iteration's config; on_pure_noise and do_adv_attack are the
    # planner's per-iteration draws
    recon_cfg: ReconStepConfig = dataclasses.field(default_factory=ReconStepConfig)
    p_normal_recon_on_pure_noise: float | None = None  # None: the planner's 0.4
    use_fp_trick: bool = True
    # resample instances whose input image has no detectable face
    # (`personalized.py:653`)
    skip_non_faces: bool = False
    p_do_adv_attack: float = 0.0  # on recon-on-image iterations (reference default 0)
    p_recon_ffn_comp_adapter: float | None = None  # None: the planner's 0.25


def img_prompt_embs_to_context(img_prompt_embs: torch.Tensor) -> torch.Tensor:
    """The teacher's context: the Arc2Face teacher reads the 16 image-prompt
    tokens as they are."""
    return img_prompt_embs


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_cfg: TrainConfig, frozen: Params,
                 trainable: Params, id2ada_encoder, embedding_manager, vae=None, teacher=None,
                 vae_decoder=None, arcface=None, host_detector: HostFaceDetector | None = None,
                 comp_cfg: CompDistillConfig = CompDistillConfig()):
        """frozen: {"unet", "text_encoder"} modules, optional "comp_unet" (the
        comp iterations' UNet weights, `comp_unet_state_dict`) and "flow" (the
        `GMA` of `comp_cfg.use_face_flow`); trainable: {"sbg": a
        SubjBasisGenerator or a list; optional "attn_lora" (`AttnLoRA`),
        "ffn_lora" (`FFNLoRA`)}; vae: a `VAEEncoder` or None (then x_start is
        drawn from N(0, 1) at image_size / 8); vae_decoder (a `VAEDecoder`)
        and arcface (an `ArcFace`): the recon and comp losses' identity
        towers, kept in `frozen` as "vae" and "arcface"; host_detector: the
        face detector on the inputs and the recons (default: the backend
        chain of `HostFaceDetector`); comp_cfg: the comp iteration's config
        (its priming count is the planner's)."""
        self.cfg = cfg
        self.comp_cfg = comp_cfg
        self.tcfg = train_cfg
        self.frozen = frozen
        self.vae = vae
        self.encoder = id2ada_encoder
        self.em = embedding_manager
        self.teacher = teacher
        self.schedule = DiffusionSchedule.create()
        self.device = next(frozen["unet"].parameters()).device
        if vae_decoder is not None:
            frozen["vae"] = vae_decoder
        if arcface is not None:
            frozen["arcface"] = arcface
        self.host_detector = host_detector or HostFaceDetector()
        planner_kwargs = {}
        if cfg.p_normal_recon_on_pure_noise is not None:
            planner_kwargs["p_normal_recon_on_pure_noise"] = cfg.p_normal_recon_on_pure_noise
        if cfg.p_recon_ffn_comp_adapter is not None:
            planner_kwargs["p_recon_ffn_comp_adapter"] = cfg.p_recon_ffn_comp_adapter
        self.planner = IterationPlanner(
            comp_distill_iter_gap=cfg.comp_distill_iter_gap,
            unet_distill_iter_gap=cfg.unet_distill_iter_gap,
            unet_distill_steps_range=tuple(cfg.unet_distill_steps_range),
            use_fp_trick=cfg.use_fp_trick,
            p_do_adv_attack_when_recon_on_images=cfg.p_do_adv_attack, **planner_kwargs)
        # the base UNet's weights on the host, copied back after comp
        # iterations; the lock keeps the prefetch thread's teacher off the UNet
        # while the comp weights are in (`_hot_swap_unet`)
        self._base_unet = None
        self._comp_weights_in = False
        self._unet_lock = threading.Lock()
        if "comp_unet" in frozen:
            self.set_comp_unet(frozen["comp_unet"])
        if cfg.unfreeze_unet:
            # one module in both: the loss functions take params["unet"]
            trainable = dict(trainable, unet=frozen["unet"])
        self.state = self._init_state(trainable)
        self.logger = MetricsLogger(cfg.log_dir, echo_every=cfg.echo_every)
        self.face_stats = RollingStats(("face_detected",))
        self.profiler = ProfilerHook(cfg.log_dir) if cfg.profile else None
        self._steps: dict = {}
        self._nan_streak = 0

    def _init_state(self, trainable: Params) -> State:
        cfg = self.cfg
        modules = [m for key in ("sbg", "unet", *LORA_KEYS) if key in trainable
                   for m in (trainable[key] if isinstance(trainable[key], (list, tuple))
                             else [trainable[key]])]
        opt = make_optimizer(cfg.optimizer, trainable_parameters(trainable), cfg.lr,
                             warmup_steps=cfg.warmup_steps, total_steps=cfg.max_steps,
                             grad_clip=cfg.grad_clip, accum_steps=cfg.accum_steps,
                             layouts=jax_layouts(*modules), **dict(cfg.optimizer_kwargs))
        return init_state(trainable, opt)

    def _get_step(self, flags):
        """One step function per iteration shape, keyed as the JAX trainer
        keys its graphs (`trainer.py:237-246`): comp by the planner's priming
        count (`ddpm.py:2388`), recon by the pure-noise, adversarial and
        FFN-adapter draws (`ddpm.py:2305-2339`)."""
        if flags.iter_type == "comp_distill":
            key = ("comp_distill", flags.num_priming_steps)
        elif flags.iter_type == "recon":
            key = ("recon", flags.normal_recon_on_pure_noise, flags.do_adv_attack,
                   flags.recon_ffn_adapter)
        else:
            key = ("unet_distill",)
        if key not in self._steps:
            if flags.iter_type == "comp_distill":
                ccfg = dataclasses.replace(self.comp_cfg,
                                           num_priming_steps=flags.num_priming_steps)
                loss_fn = make_comp_loss_fn(ccfg, self.host_detector)
            elif flags.iter_type == "recon":
                # the FFN adapter keys a step of its own, as in JAX, but
                # selects nothing: recon runs no FFN adapter
                # (`recon_uses_ffn_lora` is False)
                rcfg = dataclasses.replace(
                    self.cfg.recon_cfg, on_pure_noise=flags.normal_recon_on_pure_noise,
                    do_adv_attack=flags.do_adv_attack)
                loss_fn = make_recon_loss_fn(rcfg, self.host_detector)
            else:
                loss_fn = unet_distill_loss_fn
            self._steps[key] = make_train_step(loss_fn, self.frozen, self.schedule, self.tcfg)
        return self._steps[key]

    # ---------------------------------------------------------- host prep
    def draws_for(self, flags, loss: bool = False) -> Draws:
        """The step's draws for its batch (or, with `loss`, for its loss): a
        generator on the UNet's device seeded with (cfg.seed, flags.seed)."""
        seed = (self.cfg.seed << 32) + flags.seed
        gen = torch.Generator(self.device).manual_seed(seed ^ (1 << 62) if loss else seed)
        return Draws(generator=gen)

    @torch.no_grad()
    def _prepare_batch(self, examples: list[dict], flags, draws: Draws,
                       input_dets=None) -> Params:
        """One batch on the device. Draws, in order: x_start without a VAE,
        the random-ID path's x_start and ID draws, the perturbation's three,
        the noise, the timesteps (unet-distill [700, 900), the others [20,
        999), which the recon and comp losses do not read: they draw their
        own), the teacher's chain, the fg-seeded start's three noises. Recon
        and comp batches also carry the input pixels with their host
        detections (`input_dets`, or detected here); recon the attn-LoRA
        gate; comp the 5-block prompts, the fallback boxes from the input
        detection, the face-kept window and the fg percent."""
        dev = self.device
        batch = collate_batch(examples)
        b = len(examples)
        images = batch["image"]  # [B, S, S, 3] in [-1, 1]

        def sel(i, fallback):
            vals = batch.get(flags.prompt_keys[i], batch[fallback])
            return [p + flags.prompt_suffix for p in vals]

        prompts = [sel(0, "subj_single_prompt"), sel(1, "subj_comp_prompt"),
                   sel(2, "cls_single_prompt"), sel(3, "cls_comp_prompt")]
        hw = self.cfg.image_size // 8
        if self.vae is not None:
            px = torch.from_numpy(images.transpose(0, 3, 1, 2).copy()).to(dev)
            vae_dtype = next(self.vae.parameters()).dtype
            x_start = vae_encode(self.vae, px.to(vae_dtype)).float()
            hw = x_start.shape[-1]
        else:
            x_start = draws.normal((b, 4, hw, hw), dev)

        is_distill = flags.iter_type == "unet_distill"
        is_comp = flags.iter_type == "comp_distill"
        rs_iter = np.random.RandomState(flags.seed ^ 0x5EED)
        gen_rand_id = is_distill and rs_iter.rand() < self.cfg.p_gen_rand_id_for_id2img
        perturb_ids = (is_distill and not gen_rand_id
                       and rs_iter.rand() < self.cfg.p_perturb_face_id_embs)
        if gen_rand_id:
            id_embs = clip_feats = None
            x_start = draws.normal(x_start.shape, dev)
        else:
            uint8_imgs = ((images + 1) * 127.5).clip(0, 255).astype(np.uint8)
            _, id_embs, clip_feats = self.encoder.extract_init_id_embeds_from_images(
                list(uint8_imgs), skip_non_faces=False)
        _, _, img_prompt_embs, _ = self.encoder.get_batched_img_prompt_embs(
            b, id_embs, clip_feats, rng=draws)
        img_prompt_embs = img_prompt_embs.to(dev).float()

        if perturb_ids and b > 1:
            x_start = x_start[:1].repeat(b, 1, 1, 1)
            for key in ("image", "fg_mask", "aug_mask"):
                batch[key] = np.repeat(batch[key][:1], b, axis=0)
            rest = anneal_perturb_embedding(
                draws, img_prompt_embs[:1].repeat(b - 1, 1, 1), 0.0,
                tuple(self.cfg.perturb_face_id_embs_std_range), None, 1.0, keep_norm=True)
            img_prompt_embs = torch.cat([img_prompt_embs[:1], rest])

        if is_comp:
            # the 5-block batch [ss ‖ sc ‖ sc_rep ‖ cs ‖ cc]: sc_rep repeats the
            # compositional part (`ddpm.py:1386-1396`)
            sc_rep = make_comp_rep_prompts(prompts[1], batch["prompt_modifier"],
                                           batch["compos_partial_prompt"])
            pb = build_comp_prompt_batch(self.em, prompts[0], prompts[1], sc_rep, *prompts[2:])
        else:
            pb = build_4block_prompt_batch(self.em, *prompts)

        def as_t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        fg = as_t(batch["fg_mask"], torch.float32)[:, None]
        aug = as_t(batch["aug_mask"], torch.float32)[:, None]
        alpha = np.asarray(self.cfg.clip_skip_weights, np.float64)
        skip = (np.random.RandomState(flags.seed).dirichlet(self.cfg.clip_skip_weights)
                if self.cfg.randomize_clip_skip_weights else alpha / alpha.sum())
        noise = draws.normal(x_start.shape, dev)
        t = draws.integers((b,), *((700, 900) if is_distill else (20, 999)), dev)
        out: Params = {
            "x_start": x_start, "noise": noise, "t": t,
            "img_prompt_embs": img_prompt_embs,
            "prompt_ids": as_t(pb["prompt_ids"], torch.int64),
            "splice_map": as_t(pb["splice_map"], torch.int64),
            "prompt_emb_mask": as_t(pb["prompt_emb_mask"], torch.float32),
            "uncond_ids": as_t(pb["uncond_ids"], torch.int64),
            "img_mask": resize_nearest(aug, (hw, hw)),
            "fg_mask": resize_nearest(fg, (hw, hw)),
            "face_detected": torch.ones((b,), device=dev),
            "clip_skip_weights": as_t(skip, torch.float32),
            "clip_skip_weights_fixed": as_t(alpha / alpha.sum(), torch.float32),
        }
        if "prompt_pad_mask" in pb:
            out["prompt_pad_mask"] = as_t(pb["prompt_pad_mask"], torch.float32)
        if "merge_map" in pb:
            out["merge_map"] = as_t(pb["merge_map"], torch.int64)
        if flags.iter_type in ("recon", "comp_distill"):
            # the input faces: the reference side of the identity losses
            nchw = images.transpose(0, 3, 1, 2)
            det = input_dets if input_dets is not None else self.host_detector(nchw)
            self.face_stats.update("face_detected", float(np.mean(det.detected)))
            out["ref_images"] = as_t(nchw, torch.float32)
            out["ref_face_bboxes"] = as_t(det.fg_bboxes, torch.float32)
            out["ref_face_detected"] = as_t(det.detected, torch.float32)
        if flags.iter_type == "recon":
            out["recon_attn_lora_gate"] = torch.tensor(
                1.0 if flags.recon_enable_attn_lora else 0.0, device=dev)
        elif is_comp:
            self._prepare_comp(out, batch, flags, draws, hw)
        elif self.teacher is not None:
            cfg_scale = self.teacher.sample_cfg_scale(np.random.RandomState(flags.seed))
            with self._unet_lock:  # the teacher runs on the base weights
                preds, x_starts, noises, ts = self.teacher(
                    self.schedule, x_start, noise, t,
                    img_prompt_embs_to_context(img_prompt_embs), draws,
                    num_denoising_steps=flags.num_denoising_steps, cfg_scale=cfg_scale)
            # the teacher's x_t chain, for the student to denoise
            out["teacher_x_ts"] = torch.stack([self.schedule.q_sample(x0, ti, n) for x0, ti, n
                                               in zip(x_starts[:-1], ts, noises)])
            out["teacher_noise_preds"] = preds
            out["teacher_ts"] = ts
        else:
            out["teacher_noise_pred"] = noise
        return out

    def _prepare_comp(self, out: Params, batch: dict, flags, draws: Draws, hw: int) -> None:
        """The comp half of a batch (`trainer.py:478-511`): the fallback
        boxes from the input detection in latent coordinates, the face-kept
        window of earlier comp iterations, the fg percent, and with
        `p_init_fg_from_training_image` the fg-seeded start."""
        dev = self.device
        in_bb = out["ref_face_bboxes"] * (hw / self.cfg.image_size)
        out["ss_face_bboxes"] = in_bb
        out["sc_face_bboxes"] = in_bb.clone()
        kept = self.face_stats.buffers.get("comp_sc_face_kept")
        n = len(kept) if kept else 0
        out["comp_sc_face_detected_mean"] = torch.tensor(
            self.face_stats.mean("comp_sc_face_kept") if n else 1.0, device=dev)
        out["comp_sc_face_detected_n"] = torch.tensor(float(n), device=dev)
        fg_percent = float(np.mean(batch["fg_mask"]))
        out["sc_fg_mask_percent"] = torch.tensor(fg_percent, device=dev)
        rs = np.random.RandomState(flags.seed)
        if (rs.rand() < self.comp_cfg.p_init_fg_from_training_image
                and float(np.sum(batch["fg_mask"])) > 0):
            scale, dh, dw = plan_fg_init(fg_percent, rs, hw=tuple(out["x_start"].shape[-2:]))
            out["comp_x_base"], out["fg_mask"] = init_x_with_fg_from_training_image(
                out["x_start"], out["fg_mask"], draws, scale=scale, dh=dh, dw=dw)
            out["sc_fg_mask_percent"] = torch.tensor(fg_percent * scale * scale, device=dev)

    # ---------------------------------------------------------------- run
    def _batch_iterator(self, dataset: PersonalizedBase, num_steps: int, start_step: int = 0):
        """Yields (step, flags, batch) in step order; with cfg.prefetch > 0 a
        daemon thread prepares up to that many batches ahead. The producer
        is the only caller of the planner, the sampler, the dataset and the
        input detector, so their draws do not depend on the threads."""

        def produce():
            it = iter(SubjectSampler(dataset, self.cfg.batch_size, num_batches=num_steps,
                                     seed=self.cfg.seed))
            for step in range(start_step, start_step + num_steps):
                flags = self.planner.plan(step)
                examples = [dataset[next(it)] for _ in range(self.cfg.batch_size)]
                dets = None
                if self.cfg.skip_non_faces:
                    # resample the instances without a detected face, at most
                    # twice (`SubjectSampler` skip_non_faces)
                    for round_ in range(3):
                        imgs = np.stack([e["image"] for e in examples])
                        dets = self.host_detector(imgs.transpose(0, 3, 1, 2))
                        missing = np.nonzero(dets.detected == 0)[0]
                        if len(missing) == 0 or round_ == 2:
                            break
                        for j in missing:
                            examples[j] = dataset[next(it)]
                yield step, flags, self._prepare_batch(examples, flags, self.draws_for(flags),
                                                       dets)

        if self.cfg.prefetch <= 0:
            yield from produce()
            return
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        end, stop = object(), threading.Event()

        def worker():
            try:
                for item in produce():
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(end)
            except BaseException as e:  # raised again in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)

    def _post_step(self, step: int, flags, metrics: dict) -> None:
        """NaN trap (three non-finite losses in a row save and raise), the
        recon face-detection window, logging, profiler, checkpoint cadence."""
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            self._nan_streak += 1
            print(f"WARNING: non-finite loss at step {step} ({flags.iter_type})")
            if self._nan_streak >= 3:
                self.save(step)
                raise FloatingPointError(f"loss non-finite for {self._nan_streak} "
                                         "consecutive steps")
        else:
            self._nan_streak = 0
        # `normal_recon_face_images_on_image_stats` (`ddpm.py:213-224`)
        if "recon_face_detected_frac" in metrics:
            self.face_stats.update("face_detected", float(metrics["recon_face_detected_frac"]))
        # the comp identity losses' window (`comp_sc_face_detected_frac`)
        if "comp_sc_face_kept_any" in metrics:
            self.face_stats.update("comp_sc_face_kept", float(metrics["comp_sc_face_kept_any"]))
        self.logger.log_dict(step, {**metrics,
                                    "face_detected_window": self.face_stats.mean("face_detected"),
                                    "iter_type_id": ITER_TYPE_ID[flags.iter_type]})
        if self.profiler:
            self.profiler.maybe_start_stop(step)
        if self.cfg.ckpt_every and (step + 1) % self.cfg.ckpt_every == 0:
            self.save(step + 1)

    def fit(self, dataset: PersonalizedBase, num_steps: int | None = None,
            start_step: int = 0) -> dict:
        """Run `num_steps` micro-steps numbered from `start_step` (a resume
        continues the numbering; the optimizer restarts by design) → the last
        step's metrics."""
        num_steps = num_steps or self.cfg.max_steps
        metrics = {}
        self._nan_streak = 0
        for step, flags, batch in self._batch_iterator(dataset, num_steps, start_step):
            try:
                self._hot_swap_unet(flags.use_comp_distill_weights)
                self.state, metrics = self._get_step(flags)(self.state, batch,
                                                            self.draws_for(flags, loss=True))
            except KeyboardInterrupt:
                print(f"\ninterrupted at step {step}; checkpoint -> {self.save(step)}")
                raise
            finally:
                self._hot_swap_unet(False)
            self._post_step(step, flags, metrics)
        return metrics

    def set_comp_unet(self, weights: dict) -> None:
        """The comp iterations' UNet weights (`comp_unet_state_dict`): kept on
        the host as `frozen["comp_unet"]`, the base weights copied there
        beside them, and the planner told (`has_comp_unet_weights`)."""
        if self.cfg.unfreeze_unet:
            raise ValueError("comp_unet: the comp weights swap into a frozen UNet, "
                             "not one that trains (unfreeze_unet)")
        self.frozen["comp_unet"] = weights
        self._base_unet = _host_copy(self.frozen["unet"].state_dict())
        self.planner.has_comp_unet_weights = True

    def _hot_swap_unet(self, to_comp: bool) -> None:
        """The comp iterations' weights into the frozen UNet, or the base
        weights back (`trainer.py:307-312`, `ddpm.py:472-483`): copied in
        place, so the step functions and the captures see the same module.
        `fit` swaps in before a comp iteration's step (the planner's
        `use_comp_distill_weights`) and back right after it; while the comp
        weights are in, `_unet_lock` is held, so the prefetch thread's teacher
        waits for the base weights."""
        if self._base_unet is None or to_comp == self._comp_weights_in:
            return
        if to_comp:
            self._unet_lock.acquire()
        self.frozen["unet"].load_state_dict(self.frozen["comp_unet"] if to_comp
                                            else self._base_unet, strict=True)
        self._comp_weights_in = to_comp
        if not to_comp:
            self._unet_lock.release()

    # -------------------------------------------------------- checkpoints
    def save(self, step: int) -> str:
        """The SubjBasisGenerator(s) as an AdaFace checkpoint, with the
        adapters' state dicts under `unet_lora_modules` where they train;
        with `unfreeze_unet` also the UNet as `unet_fp16.safetensors` beside
        it, under the JAX UNet tree's flat names (`ddpm.py:4041-4062`)."""
        out = os.path.join(self.cfg.log_dir, f"checkpoints/embeddings_gs-{step}")
        out = save_adaface_ckpt(out, step, {"joint": trainable_state_dicts(self.state.params)},
                                unet_lora_params=lora_state_dicts(self.state.params))
        if self.cfg.unfreeze_unet and "unet" in self.state.params:
            from adaface_tpu_torch.core.bridge import tree_state_dict
            from adaface_tpu_torch.tools.ckpt_lib import cast_fp16, save_state_dict

            save_state_dict(cast_fp16(tree_state_dict(self.state.params["unet"])),
                            os.path.join(out, "unet_fp16.safetensors"))
        return out

    def load(self, ckpt_dir: str, extend_mkv_multiplier: int = 1,
             draws: Draws | None = None) -> int:
        """Warm-start the SubjBasisGenerator(s), and the adapters where the
        checkpoint and the trainer both have them (`trainer.py:747-751`),
        from a checkpoint, at the prompt2token_proj widths it holds; the
        optimizer restarts over the parameters as they now are. → the saved
        step. `extend_mkv_multiplier` > 1 multiplies each loaded
        SubjBasisGenerator's prompt2token_proj K/V copies (the round-2
        recipe, `trainer.py:710-745`); its perturbation draws come from
        `draws` (a generator seeded 0 if None), SubjBasisGenerator by
        SubjBasisGenerator."""
        state, manifest = load_adaface_ckpt(ckpt_dir)
        sbgs = state.get("subj_basis_generators", {})
        if sbgs:
            loaded = sbgs[next(iter(sbgs))]
            mods = self.state.params["sbg"]
            pairs = (list(zip(mods, loaded)) if isinstance(mods, (list, tuple))
                     else [(mods, loaded)])
            if extend_mkv_multiplier > 1:
                draws = draws or Draws(generator=torch.Generator().manual_seed(0))
            for mod, sd in pairs:
                if extend_mkv_multiplier > 1:
                    n_layers = len(layer_multipliers(sd, prefix="clip."))
                    sd = extend_prompt2token_proj_attention(
                        sd, [extend_mkv_multiplier] * n_layers, draws)
                load_sbg_state_dict(mod, sd, ckpt_dir)
            if extend_mkv_multiplier > 1:
                print(f"extended prompt2token_proj MKV attention x{extend_mkv_multiplier}")
        lora = state.get("unet_lora_modules") or {}
        for key in LORA_KEYS:
            if key in lora and key in self.state.params:
                self.state.params[key].load_state_dict(lora[key], strict=True)
        self.state = self._init_state(self.state.params)
        step = int(manifest.get("step", 0))
        print(f"warm-started from {ckpt_dir} (step {step})")
        return step

    @staticmethod
    def latest_ckpt(log_dir: str) -> str | None:
        """The newest `checkpoints/embeddings_gs-N` under a log dir."""
        d = os.path.join(log_dir, "checkpoints")
        if not os.path.isdir(d):
            return None
        cands = [(int(n.rsplit("-", 1)[1]), os.path.join(d, n)) for n in os.listdir(d)
                 if n.startswith("embeddings_gs-") and n.rsplit("-", 1)[1].isdigit()]
        return max(cands)[1] if cands else None


def _host_copy(sd: dict) -> dict:
    """A state dict's tensors copied to the host (pinned where a card is
    present, for the copies back)."""
    pin = torch.cuda.is_available()
    return {k: v.detach().cpu().pin_memory() if pin else v.detach().cpu().clone()
            for k, v in sd.items()}


def comp_unet_state_dict(unet: torch.nn.Module, tree: Params) -> dict:
    """The comp iterations' UNet weights (`--comp_unet_weight_path`): a JAX
    UNet tree (`tools/convert_sd.load_sd_towers`' "unet") as a host state
    dict in `unet`'s layout and dtypes, for `frozen["comp_unet"]`."""
    from adaface_tpu_torch.core import bridge

    ref = unet.state_dict()
    sd = bridge.fuse_projections(bridge.state_dict(tree), ref)
    if set(sd) != set(ref) or any(sd[k].shape != ref[k].shape for k in ref):
        raise ValueError("comp_unet: the weights do not match the UNet (keys "
                         f"{sorted(set(sd) ^ set(ref))[:8]})")
    return _host_copy({k: sd[k].to(v.dtype) for k, v in ref.items()})
