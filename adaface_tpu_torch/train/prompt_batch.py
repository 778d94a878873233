"""Host-side assembly of the training prompt batches.

Counterpart of `adaface_tpu/train/prompt_batch.py` (pure numpy, the same
code): the 4-block batch [subj_single, subj_comp, cls_single, cls_comp] of
the unet-distill and recon iterations, and the two builders of the 5-block
comp-distill batch. The token planning (ids, ada splice maps, embedding
masks) runs on the host through the EmbeddingManager.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from adaface_tpu_torch.text.embedding_manager import EmbeddingManager


def build_4block_prompt_batch(
    em: EmbeddingManager,
    subj_single: Sequence[str],
    subj_comp: Sequence[str],
    cls_single: Sequence[str],
    cls_comp: Sequence[str],
    max_length: int = 77,
    placeholder: str | None = None,
) -> dict[str, np.ndarray]:
    """→ {'prompt_ids' [4B,S], 'splice_map' [4B,S], 'prompt_emb_mask'
    [4B,S,1]} with block order ss ‖ sc ‖ cs ‖ cc."""
    prompts = list(subj_single) + list(subj_comp) + list(cls_single) + list(cls_comp)
    plan = em.plan(prompts, max_length=max_length)
    placeholder = placeholder or em.placeholders[0].string
    out = {
        "prompt_ids": plan["ids"],
        "splice_map": plan["splice_maps"][placeholder],
        "prompt_emb_mask": plan["prompt_emb_mask"],
        # uncond ids for the compel-style embedding CFG of the distribute
        # step (`distribute_embedding_to_M_tokens`, `ldm/util.py:585-589`)
        "uncond_ids": em.tokenizer([""], max_length=max_length),
    }
    if plan.get("merge_map") is not None:
        # multi-token cls-delta strings summed into one slot + left shift
        # (`merge_cls_token_embeddings`, `ldm/util.py:683-760`)
        out["merge_map"] = plan["merge_map"]
    return out


def make_comp_rep_prompts(
    subj_comp: Sequence[str],
    prompt_modifier: Sequence[str],
    compos_partial: Sequence[str],
    subj_rep_prompts_count: int = 2,
) -> list[str]:
    """subj-comp-rep prompts: the comp part repeated
    `subj_rep_prompts_count` times after the subj-comp prompt, replicating
    the reference's exact concatenation (`ddpm.py:1393-1396` — note: no
    separator between the subj-comp prompt and the first repeat)."""
    return [
        sc + ", ".join([m + ", " + c] * subj_rep_prompts_count)
        for sc, m, c in zip(subj_comp, prompt_modifier, compos_partial)
    ]


def build_comp_prompt_batch(
    em: EmbeddingManager,
    subj_single: Sequence[str],
    subj_comp: Sequence[str],
    subj_comp_rep: Sequence[str],
    cls_single: Sequence[str],
    cls_comp: Sequence[str],
    max_length: int = 77,
    placeholder: str | None = None,
) -> dict[str, np.ndarray]:
    """5-block comp-iteration prompt batch [ss ‖ sc ‖ sc_rep ‖ cs ‖ cc]
    (`LatentDiffusion.forward` comp branch, `ddpm.py:1386-1530`): the
    denoise batch takes blocks [ss, sc, sc_rep, cc(+mix)], the delta loss
    takes [ss, sc, cs_dist, cc_dist]."""
    prompts = (list(subj_single) + list(subj_comp) + list(subj_comp_rep)
               + list(cls_single) + list(cls_comp))
    plan = em.plan(prompts, max_length=max_length)
    placeholder = placeholder or em.placeholders[0].string
    out = {
        "prompt_ids": plan["ids"],
        "splice_map": plan["splice_maps"][placeholder],
        "prompt_emb_mask": plan["prompt_emb_mask"],
        "prompt_pad_mask": plan["prompt_pad_mask"],
        "uncond_ids": em.tokenizer([""], max_length=max_length),
    }
    if plan.get("merge_map") is not None:
        out["merge_map"] = plan["merge_map"]
    return out
