"""Host-side iteration planner.

Counterpart of `adaface_tpu/train/iteration_plan.py`, the same numpy code,
so both packages draw the same flags bit for bit. Rebuild of the
iteration-type scheduler in `DDPM.training_step` (`ddpm.py:434-503`): a
deterministic round-robin among comp-feat-distill
(every `comp_distill_iter_gap` global steps), unet-distill (every
`unet_distill_iter_gap` non-comp iterations) and normal-recon (the rest),
plus per-(rank, epoch, batch) seeding (`set_seed_per_rank_and_batch`,
`ldm/util.py:524-531`) and the UNet base↔comp weight hot-swap flag.

It also materializes the per-iteration probabilistic draws of
`shared_step` (`ddpm.py:956-1084`) that change the *shape* of the step —
pure-noise recon, fp-trick prompt-variant selection, 'clear face' /
'front view' suffixes, recon LoRA gates, the adversarial-attack gate —
so each combination maps to one pre-jitted step function (SURVEY §7:
"branch-by-schedule") and the device never sees data-dependent control
flow.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IterationFlags:
    step: int
    iter_type: str  # 'recon' | 'unet_distill' | 'comp_distill'
    use_comp_distill_weights: bool
    switch_weights: bool  # weights must be hot-swapped before this step
    seed: int
    do_prompt_emb_delta_reg: bool
    num_denoising_steps: int = 1
    # comp iterations alternate 4/3 priming steps (`ddpm.py:2388`:
    # comp_iters_count % 2 - 1 + max_num_comp_priming_denoising_steps)
    num_priming_steps: int = 4
    # --- per-iteration probabilistic draws (`ddpm.py:956-1084`) ---
    # recon from pure noise instead of the input latents
    # (p_normal_recon_on_pure_noise = 0.4, `ddpm.py:120,959-967`)
    normal_recon_on_pure_noise: bool = False
    # the 4 dataset prompt-variant keys [subj_single, subj_comp,
    # cls_single, cls_comp] chosen by the fp/p trick (`ddpm.py:972-1056`)
    prompt_keys: tuple = ("subj_single_prompt", "subj_comp_prompt",
                          "cls_single_prompt", "cls_comp_prompt")
    # ', clear face' / ', front view' suffix (`ddpm.py:1063-1084`)
    prompt_suffix: str = ""
    # 50% attn-LoRA gate on recon-on-image iterations (`ddpm.py:2317`)
    recon_enable_attn_lora: bool = False
    # recon ffn adapter: 'comp_distill' ~25% of the time when
    # comp_uses_ffn_lora, to prevent lora degeneration (`ddpm.py:2319-2325`;
    # the reference draws via torch.randn<0.25 ≈ p=0.6 — we follow the
    # stated intent of 25%); only consulted when recon_uses_ffn_lora
    recon_ffn_adapter: str = "recon_loss"
    # adversarial ArcFace grad attack on recon inputs
    # (p_do_adv_attack_when_recon_on_images, default 0, `ddpm.py:2336`)
    do_adv_attack: bool = False
    # running comp-iteration counter (drives the cls p-trick alternation
    # `ddpm.py:1041` and priming-step alternation)
    comp_iters_count: int = 0


@dataclasses.dataclass
class IterationPlanner:
    comp_distill_iter_gap: int = 0  # 0 = disabled (stage 1)
    unet_distill_iter_gap: int = 0
    do_prompt_emb_delta_reg: bool = True
    has_comp_unet_weights: bool = False
    rank: int = 0
    # distill step-count buckets to bound the number of compiled graphs
    # (SURVEY §7 hard part 3: steps ∈ {2,3,4,5})
    unet_distill_steps_range: tuple[int, int] = (2, 4)
    # max_num_comp_priming_denoising_steps (`ddpm.py:105`)
    max_priming_steps: int = 4
    # pin the comp priming count instead of the reference's 3/4
    # alternation (`ddpm.py:2388`): opt-in compile-budget knob for
    # relay-constrained environments — halves the number of compiled
    # comp graphs. None = reference-exact alternation.
    fixed_comp_priming_steps: int | None = None
    # --- probabilistic-draw knobs (reference ctor defaults) ---
    p_normal_recon_on_pure_noise: float = 0.4  # `ddpm.py:120`
    use_fp_trick: bool = True  # `--use_fp_trick`, default on in README
    unet_uses_attn_lora: bool = True
    recon_uses_ffn_lora: bool = False  # `ddpm.py:129`
    comp_uses_ffn_lora: bool = True
    p_recon_ffn_comp_adapter: float = 0.25
    p_do_adv_attack_when_recon_on_images: float = 0.0  # `ddpm.py:123`

    def __post_init__(self):
        self.non_comp_iters = 0
        self.comp_iters = 0
        self.unet_distill_iters = 0
        self.recon_iters = 0
        self._prev_comp_weights = False

    def seed_for(self, epoch: int, batch_idx: int) -> int:
        return (self.rank * 100_000 + epoch * 10_000 + batch_idx) % (2**31)

    # ---------------------------------------------------------- prompts
    def _select_prompts(self, rng: np.random.RandomState, iter_type: str,
                        on_pure_noise: bool) -> tuple[tuple, str]:
        """fp/p-trick prompt-variant selection + face-quality suffixes
        (`ddpm.py:972-1084`). → (4 dataset keys, suffix string)."""
        is_comp = iter_type == "comp_distill"
        is_recon = iter_type == "recon"

        if self.use_fp_trick:
            if is_comp:
                p_fp = 0.5
            elif is_recon and self.comp_distill_iter_gap > 0:
                p_fp = 1.0
            else:
                p_fp = 0.0
        else:
            p_fp = 0.0
        use_fp = rng.rand() < p_fp

        def keys(mid: str, tag: str = "") -> tuple:
            sfx = f"_{tag}" if tag else ""
            return (f"subj_single{mid}prompt{sfx}",
                    f"subj_comp{mid}prompt{sfx}",
                    f"cls_single{mid}prompt{sfx}",
                    f"cls_comp{mid}prompt{sfx}")

        if on_pure_noise:
            # no GT images → mod prompts; fp 50% / p 50% (`ddpm.py:999-1009`)
            chosen = keys("_mod_", "fp" if rng.rand() < 0.5 else "p")
        elif use_fp:
            chosen = keys("_mod_", "fp") if is_comp else keys("_", "fp")
        elif is_comp:
            # subj single stays fp; cls prompts use the p trick 75% of the
            # time (`ddpm.py:1035-1046`, alternation on comp_iters_count)
            use_p = self.comp_iters % 4 != 0
            cls_tag = "p" if use_p else ""
            ss, _, _, _ = keys("_mod_", "fp")
            _, sc, _, _ = keys("_mod_")
            _, _, cs, cc = keys("_mod_", cls_tag)
            chosen = (ss, sc, cs, cc)
        else:
            chosen = keys("_")

        # 'clear face'/'front view' suffixes: comp iterations only
        # (p=0.8 each, `ddpm.py:1063-1084`); never stacked on the fp trick
        suffix = ""
        if is_comp:
            if rng.rand() < 0.8 and not use_fp:
                suffix += ", clear face"
            if rng.rand() < 0.8:
                suffix += ", front view"
        return chosen, suffix

    def plan(self, global_step: int, epoch: int = 0,
             batch_idx: int | None = None) -> IterationFlags:
        batch_idx = batch_idx if batch_idx is not None else global_step
        seed = self.seed_for(epoch, batch_idx)
        rng = np.random.RandomState(seed)

        n_prime = 4
        on_pure_noise = False
        attn_lora_gate = False
        ffn_adapter = "recon_loss"
        do_adv = False
        if (self.comp_distill_iter_gap > 0
                and global_step % self.comp_distill_iter_gap == 0):
            iter_type = "comp_distill"
            self.comp_iters += 1
            delta_reg = self.do_prompt_emb_delta_reg
            n_steps = 4
            n_prime = (self.fixed_comp_priming_steps
                       if self.fixed_comp_priming_steps is not None
                       else self.comp_iters % 2 - 1 + self.max_priming_steps)
        else:
            self.non_comp_iters += 1
            if (self.unet_distill_iter_gap > 0
                    and self.non_comp_iters % self.unet_distill_iter_gap == 0):
                iter_type = "unet_distill"
                self.unet_distill_iters += 1
                delta_reg = False
                # deterministic round-robin over [lo, hi], NOT a random
                # draw — the reference cycles `iters_count % 3 + 2` so
                # all DDP ranks agree without synchronization
                # (`ddpm.py:1266-1270`); hi comes from
                # --max_num_unet_distill_denoising_steps (3 in stage 2)
                lo, hi = self.unet_distill_steps_range
                n_steps = lo + (self.unet_distill_iters - 1) % (hi - lo + 1)
            else:
                iter_type = "recon"
                self.recon_iters += 1
                delta_reg = self.do_prompt_emb_delta_reg
                n_steps = 1
                on_pure_noise = rng.rand() < self.p_normal_recon_on_pure_noise
                if not on_pure_noise:
                    # 50% attn-LoRA on recon-on-image (`ddpm.py:2317`)
                    attn_lora_gate = (self.unet_uses_attn_lora
                                      and rng.rand() < 0.5)
                    if (self.comp_uses_ffn_lora
                            and rng.rand() < self.p_recon_ffn_comp_adapter):
                        ffn_adapter = "comp_distill"
                    do_adv = (rng.rand()
                              < self.p_do_adv_attack_when_recon_on_images)

        prompt_keys, suffix = self._select_prompts(rng, iter_type,
                                                   on_pure_noise)

        use_comp_w = (iter_type == "comp_distill"
                      and self.has_comp_unet_weights)
        switch = use_comp_w != self._prev_comp_weights
        self._prev_comp_weights = use_comp_w
        return IterationFlags(
            step=global_step, iter_type=iter_type,
            use_comp_distill_weights=use_comp_w, switch_weights=switch,
            seed=seed, do_prompt_emb_delta_reg=delta_reg,
            num_denoising_steps=n_steps, num_priming_steps=n_prime,
            normal_recon_on_pure_noise=on_pure_noise,
            prompt_keys=prompt_keys, prompt_suffix=suffix,
            recon_enable_attn_lora=attn_lora_gate,
            recon_ffn_adapter=ffn_adapter, do_adv_attack=do_adv,
            comp_iters_count=self.comp_iters,
        )
