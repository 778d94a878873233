"""Training orchestrator for stage-1 unet-distill iterations.

Counterpart of `Trainer` in `adaface_tpu/train/trainer.py` for the
configurations whose every iteration is unet-distill
(`comp_distill_iter_gap: 0`, `unet_distill_iter_gap: 1`, e.g.
`configs/stage1-distill-arc2face.yaml`): the dataset and its sampler, the
host prep of each batch (VAE encode of the photos, face ID → image-prompt
embeddings, the perturbed-ID and random-ID draws, the 4-block prompt batch,
the Dirichlet CLIP-skip weights, the frozen teacher's denoising chain), an
optional background thread preparing batches ahead of the step, the
train step with accumulation (`optimizers.MultiSteps`), the NaN trap,
CSV logging, the profiler hook and checkpoints. Recon and comp-distill
iterations, the UNet hot-swap and data parallelism wait in ROADMAP §1: a
configuration whose plan has them raises at construction.

Random draws: each step's from a `torch.Generator` seeded with
(cfg.seed, the step's planner seed), so a step draws the same whatever
thread prepares it; the dataset, the planner, the CLIP-skip weights and the
perturbation decision draw from numpy RandomStates as the JAX package does.
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
from adaface_tpu_torch.models.vae import vae_encode
from adaface_tpu_torch.ops.resize import resize_nearest
from adaface_tpu_torch.ops.schedules import DiffusionSchedule
from adaface_tpu_torch.train.checkpoint import load_adaface_ckpt, save_adaface_ckpt
from adaface_tpu_torch.train.iteration_plan import IterationPlanner
from adaface_tpu_torch.train.optimizers import make_optimizer
from adaface_tpu_torch.train.prompt_batch import build_4block_prompt_batch
from adaface_tpu_torch.train.train_step import (State, TrainConfig, init_state, make_train_step,
                                                trainable_parameters, trainable_state_dicts,
                                                unet_distill_loss_fn)
from adaface_tpu_torch.utils.monitor import MetricsLogger, ProfilerHook, RollingStats
from adaface_tpu_torch.utils.tensor import Draws, anneal_perturb_embedding

Params = dict[str, Any]
NOT_PORTED = ("recon and comp-distill iterations are not ported (ROADMAP §1, item 7): the "
              "trainer takes comp_distill_iter_gap 0 and unet_distill_iter_gap 1")


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
    # batches prepared ahead by a background thread (VAE, face ID, teacher)
    prefetch: int = 2
    use_fp_trick: bool = True


def img_prompt_embs_to_context(img_prompt_embs: torch.Tensor) -> torch.Tensor:
    """The teacher's context: the Arc2Face teacher reads the 16 image-prompt
    tokens as they are."""
    return img_prompt_embs


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_cfg: TrainConfig, frozen: Params,
                 trainable: Params, id2ada_encoder, embedding_manager, vae=None, teacher=None):
        """frozen: {"unet", "text_encoder"} modules; trainable: {"sbg": a
        SubjBasisGenerator or a list}; vae: a `VAEEncoder` or None (then
        x_start is drawn from N(0, 1) at image_size / 8)."""
        if cfg.comp_distill_iter_gap != 0 or cfg.unet_distill_iter_gap != 1:
            raise NotImplementedError(NOT_PORTED)
        self.cfg = cfg
        self.tcfg = train_cfg
        self.frozen = frozen
        self.vae = vae
        self.encoder = id2ada_encoder
        self.em = embedding_manager
        self.teacher = teacher
        self.schedule = DiffusionSchedule.create()
        self.device = next(frozen["unet"].parameters()).device
        self.planner = IterationPlanner(
            comp_distill_iter_gap=cfg.comp_distill_iter_gap,
            unet_distill_iter_gap=cfg.unet_distill_iter_gap,
            unet_distill_steps_range=tuple(cfg.unet_distill_steps_range),
            use_fp_trick=cfg.use_fp_trick)
        self.state = self._init_state(trainable)
        self.logger = MetricsLogger(cfg.log_dir, echo_every=cfg.echo_every)
        self.face_stats = RollingStats(("face_detected",))
        self.profiler = ProfilerHook(cfg.log_dir) if cfg.profile else None
        self._step_fn = make_train_step(unet_distill_loss_fn, frozen, self.schedule, train_cfg)
        self._nan_streak = 0

    def _init_state(self, trainable: Params) -> State:
        cfg = self.cfg
        opt = make_optimizer(cfg.optimizer, trainable_parameters(trainable), cfg.lr,
                             warmup_steps=cfg.warmup_steps, total_steps=cfg.max_steps,
                             grad_clip=cfg.grad_clip, accum_steps=cfg.accum_steps,
                             **dict(cfg.optimizer_kwargs))
        return init_state(trainable, opt)

    # ---------------------------------------------------------- host prep
    def draws_for(self, flags) -> Draws:
        """The step's draws: a generator on the UNet's device seeded with
        (cfg.seed, flags.seed)."""
        gen = torch.Generator(self.device).manual_seed((self.cfg.seed << 32) + flags.seed)
        return Draws(generator=gen)

    @torch.no_grad()
    def _prepare_batch(self, examples: list[dict], flags, draws: Draws) -> Params:
        """One unet-distill batch on the device. Draws, in order: x_start
        without a VAE, the random-ID path's x_start and ID draws, the
        perturbation's three, the noise, the timesteps in [700, 900), the
        teacher's chain."""
        if flags.iter_type != "unet_distill":
            raise NotImplementedError(NOT_PORTED)
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

        rs_iter = np.random.RandomState(flags.seed ^ 0x5EED)
        gen_rand_id = rs_iter.rand() < self.cfg.p_gen_rand_id_for_id2img
        perturb_ids = not gen_rand_id and rs_iter.rand() < self.cfg.p_perturb_face_id_embs
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

        pb = build_4block_prompt_batch(self.em, *prompts)
        def as_t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        fg = as_t(batch["fg_mask"], torch.float32)[:, None]
        aug = as_t(batch["aug_mask"], torch.float32)[:, None]
        alpha = np.asarray(self.cfg.clip_skip_weights, np.float64)
        skip = (np.random.RandomState(flags.seed).dirichlet(self.cfg.clip_skip_weights)
                if self.cfg.randomize_clip_skip_weights else alpha / alpha.sum())
        noise = draws.normal(x_start.shape, dev)
        t = draws.integers((b,), 700, 900, dev)
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
        if "merge_map" in pb:
            out["merge_map"] = as_t(pb["merge_map"], torch.int64)
        if self.teacher is not None:
            cfg_scale = self.teacher.sample_cfg_scale(np.random.RandomState(flags.seed))
            preds, x_starts, noises, ts = self.teacher(
                self.schedule, x_start, noise, t, img_prompt_embs_to_context(img_prompt_embs),
                draws, num_denoising_steps=flags.num_denoising_steps, cfg_scale=cfg_scale)
            # the teacher's x_t chain, for the student to denoise
            out["teacher_x_ts"] = torch.stack([self.schedule.q_sample(x0, ti, n) for x0, ti, n
                                               in zip(x_starts[:-1], ts, noises)])
            out["teacher_noise_preds"] = preds
            out["teacher_ts"] = ts
        else:
            out["teacher_noise_pred"] = noise
        return out

    # ---------------------------------------------------------------- run
    def _batch_iterator(self, dataset: PersonalizedBase, num_steps: int, start_step: int = 0):
        """Yields (step, flags, batch) in step order; with cfg.prefetch > 0 a
        daemon thread prepares up to that many batches ahead. The producer
        is the only caller of the planner, the sampler and the dataset, so
        their draws do not depend on the threads."""

        def produce():
            it = iter(SubjectSampler(dataset, self.cfg.batch_size, num_batches=num_steps,
                                     seed=self.cfg.seed))
            for step in range(start_step, start_step + num_steps):
                flags = self.planner.plan(step)
                examples = [dataset[next(it)] for _ in range(self.cfg.batch_size)]
                yield step, flags, self._prepare_batch(examples, flags, self.draws_for(flags))

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
        """NaN trap (three non-finite losses in a row save and raise),
        logging, profiler, checkpoint cadence."""
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
        self.logger.log_dict(step, {**metrics,
                                    "face_detected_window": self.face_stats.mean("face_detected"),
                                    "iter_type_id": 1})
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
                self.state, metrics = self._step_fn(self.state, batch)
            except KeyboardInterrupt:
                print(f"\ninterrupted at step {step}; checkpoint -> {self.save(step)}")
                raise
            self._post_step(step, flags, metrics)
        return metrics

    # -------------------------------------------------------- checkpoints
    def save(self, step: int) -> str:
        out = os.path.join(self.cfg.log_dir, f"checkpoints/embeddings_gs-{step}")
        return save_adaface_ckpt(out, step, {"joint": trainable_state_dicts(self.state.params)})

    def load(self, ckpt_dir: str) -> int:
        """Warm-start the SubjBasisGenerator(s) from a checkpoint; the
        optimizer restarts. → the saved step."""
        state, manifest = load_adaface_ckpt(ckpt_dir)
        sbgs = state.get("subj_basis_generators", {})
        if sbgs:
            loaded = sbgs[next(iter(sbgs))]
            mods = self.state.params["sbg"]
            pairs = (zip(mods, loaded) if isinstance(mods, (list, tuple))
                     else [(mods, loaded)])
            for mod, sd in pairs:
                missing, unexpected = mod.load_state_dict(sd, strict=False)
                if unexpected or set(missing) - {"clip.token_embedding",
                                                 "clip.position_embedding"}:
                    raise ValueError(f"{ckpt_dir}: checkpoint does not match the "
                                     f"SubjBasisGenerator (missing {missing}, unexpected "
                                     f"{unexpected})")
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
