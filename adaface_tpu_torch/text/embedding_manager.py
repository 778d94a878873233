"""Ada-embedding splicing into prompts.

Counterpart of `adaface_tpu/text/embedding_manager.py`: the token-position
planning runs on the host on numpy token ids (`build_splice_map`,
`prompt_masks`, `scan_cls_delta_spans`, `build_merge_map`, the
`EmbeddingManager`), the embedding math in torch as differentiable gathers
and scatter-adds (`splice_ada_embeddings`, `apply_merge_map`,
`distribute_embedding_to_M_tokens`), so that the ada embeddings' gradients
reach the SubjBasisGenerator.

- placeholder + filler walk: prompts carry "z" + ", " * (K - 1); vector k
  goes to the k-th placeholder-or-filler position after the first
  placeholder, skipping any other token;
- prompt masks: the embedding mask leaves out BOS and EOS/pad;
- cls-delta merging: in class prompts without the placeholder, a
  multi-token class-delta string is summed into one embedding and the tail
  shifted left;
- distribution: the merged class embedding, with an embedding CFG against
  the unconditional prompt, copied onto the M positions of the subject.

The table growth for added tokens (`extend_token_embedding`) serves the
inference path as well.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from adaface_tpu_torch.text.tokenizer import CLIPTokenizer


# ---------------------------------------------------------------------------
# host-side index planning (numpy)
# ---------------------------------------------------------------------------


def build_splice_map(ids: np.ndarray, placeholder_id: int, filler_id: int,
                     num_vectors: int) -> np.ndarray:
    """[B, S] int32: position → ada-vector index k in [0, K), or -1. From the
    first placeholder of each row, vector k goes to the k-th position whose
    token is the placeholder or the filler."""
    b, s = ids.shape
    out = np.full((b, s), -1, np.int32)
    for bi in range(b):
        pos = np.where(ids[bi] == placeholder_id)[0]
        if len(pos) == 0:
            continue
        p, k = int(pos[0]), 0
        while k < num_vectors and p < s:
            if ids[bi, p] == placeholder_id or ids[bi, p] == filler_id:
                out[bi, p] = k
                k += 1
            p += 1
    return out


def prompt_masks(ids: np.ndarray, bos_id: int, eos_id: int):
    """(emb_mask [B, S, 1], pad_mask [B, S, 1]) float32: the embedding mask
    leaves out BOS and every EOS; pads are the EOS after the first."""
    emb = (ids != bos_id) & (ids != eos_id)
    is_eos = ids == eos_id
    pad = is_eos.copy()
    pad[np.arange(ids.shape[0]), np.argmax(is_eos, axis=1)] = False
    return emb[..., None].astype(np.float32), pad[..., None].astype(np.float32)


def scan_cls_delta_spans(ids: np.ndarray, subj_rows_pos: list[tuple[int, int]],
                         cls_delta_tokens: dict[str, list[int]],
                         max_search_span: int = 5) -> list[tuple[int, int, int, str]]:
    """(batch row, start, M, name) of each class-delta token run in the rows
    without the placeholder: the second half of the batch, searched from
    the aligned subject row's start position."""
    b = ids.shape[0]
    half = len(subj_rows_pos)
    found = []
    for i, (_, start_pos) in enumerate(subj_rows_pos):
        batch_i = half + i
        if batch_i >= b:
            break
        row = ids[batch_i]
        done = False
        for j in range(max_search_span + 1):
            start = start_pos + j
            for name, toks in cls_delta_tokens.items():
                m = len(toks)
                if start + m <= len(row) and np.array_equal(row[start:start + m],
                                                            np.asarray(toks)):
                    found.append((batch_i, start, m, name))
                    done = True
                    break
            if done:
                break
    return found


def build_merge_map(b: int, s: int, spans: list[tuple[int, int, int, str]]) -> np.ndarray:
    """[B, S, 2] int32 merge plan: `[..., 0]` the destination → source
    gather map of the left shift, `[..., 1]` each span member's merged slot
    (-1 elsewhere); the reference's sequential writes, replayed."""
    gather_src = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    span_dest = np.full((b, s), -1, np.int32)
    by_row: dict[int, list[tuple[int, int]]] = {}
    for batch_i, start, m, _ in sorted(spans, key=lambda x: (x[0], x[1])):
        by_row.setdefault(batch_i, []).append((start, m))
    for bi, row_spans in by_row.items():
        off = 0
        for start, m in row_spans:
            span_dest[bi, start:start + m] = start - off
            if off + m - 1 > 0:
                lo, hi = start - off + 1, s - (off + m - 1)
                gather_src[bi, lo:hi] = np.arange(start + m, s, dtype=np.int32)
            off += m - 1
    return np.stack([gather_src, span_dest], axis=-1)


# ---------------------------------------------------------------------------
# embedding math (torch, differentiable)
# ---------------------------------------------------------------------------


def splice_ada_embeddings(base_embs: torch.Tensor, ada_embs: torch.Tensor,
                          splice_map: torch.Tensor) -> torch.Tensor:
    """base [B, S, D] with position p replaced by ada [B, K, D][k] where
    splice_map [B, S] holds k >= 0."""
    idx = splice_map.clamp_min(0).long()[..., None].expand(-1, -1, ada_embs.shape[-1])
    gathered = torch.gather(ada_embs, 1, idx).to(base_embs.dtype)
    return torch.where((splice_map >= 0)[..., None], gathered, base_embs)


def apply_merge_map(embs: torch.Tensor, merge_map: torch.Tensor) -> torch.Tensor:
    """Gather the shifted layout, then overwrite each span's merged slot with
    the sum of its members' embeddings (all read from the input)."""
    d = embs.shape[-1]
    gather_src = merge_map[..., 0].long()
    span_dest = merge_map[..., 1].long()
    out = torch.gather(embs, 1, gather_src[..., None].expand(-1, -1, d))
    member = (span_dest >= 0).to(embs.dtype)
    dest = span_dest.clamp_min(0)
    sums = torch.zeros_like(embs).scatter_add(1, dest[..., None].expand(-1, -1, d),
                                              embs * member[..., None])
    n_members = torch.zeros_like(member).scatter_add(1, dest, member)
    return torch.where((n_members > 0)[..., None], sums, out)


def distribute_embedding_to_M_tokens(embs: torch.Tensor, splice_map: torch.Tensor,
                                     uncond_embs: torch.Tensor | None = None,
                                     divide_scheme: str = "sqrt_M", emb_cfg: float = 2.0,
                                     emb_extra_boost: float = 2.0) -> torch.Tensor:
    """Each row's embedding at k = 0, with embedding CFG against the uncond
    embedding at that position (cls·cfg − uncond·(cfg − 1)), boosted by
    `emb_extra_boost` and divided by √M (or M, or 1), written onto all M
    marked positions; rows with M = 1 stay as they are."""
    is_first = splice_map == 0
    first_pos = is_first.int().argmax(dim=1)
    rows = torch.arange(embs.shape[0], device=embs.device)
    first = embs[rows, first_pos].float()
    if uncond_embs is not None and emb_cfg != 1.0:
        u = uncond_embs.expand_as(embs)[rows, first_pos]
        first = first * emb_cfg - u.float() * (emb_cfg - 1.0)
    m = (splice_map >= 0).sum(dim=1).float()
    if divide_scheme == "sqrt_M":
        div = m.clamp_min(1.0).sqrt()
    elif divide_scheme == "M":
        div = m.clamp_min(1.0)
    else:
        div = torch.ones_like(m)
    first = first * (emb_extra_boost / div)[:, None]
    marked = ((splice_map >= 0)[..., None] & is_first.any(dim=1)[:, None, None]
              & (m > 1.0)[:, None, None])
    return torch.where(marked, first[:, None, :].to(embs.dtype), embs)


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlaceholderSpec:
    string: str  # e.g. "z"
    num_vectors: int  # K (16 for arc2face, 4 for consistentID, 20 joint)


class EmbeddingManager:
    """Host-side planner: tokenize prompts and build the splice and merge
    maps and the masks for `CLIPTextModel(input_embs=…)`."""

    def __init__(self, tokenizer: CLIPTokenizer, placeholders: list[PlaceholderSpec],
                 filler_string: str = ",", cls_delta_tokens: dict[str, list[int]] | None = None,
                 max_search_span: int = 5):
        self.tokenizer = tokenizer
        self.placeholders = placeholders
        self.placeholder_ids = {p.string: tokenizer.add_tokens([p.string])[0]
                                for p in placeholders}
        self.filler_id = tokenizer.encode_text(filler_string)[0]
        self.cls_delta_tokens = cls_delta_tokens or {}
        self.max_search_span = max_search_span

    def expand_placeholder(self, spec: PlaceholderSpec) -> str:
        """'z' → 'z, , , …' with K - 1 fillers."""
        return spec.string + ", " * (spec.num_vectors - 1)

    def plan(self, prompts: list[str], max_length: int = 77) -> dict:
        """→ ids [B, S], splice maps by placeholder, masks, and the cls-delta
        merge map (or None)."""
        ids = self.tokenizer(prompts, max_length=max_length)
        splice_maps = {}
        subj_rows_pos: list[tuple[int, int]] = []
        for spec in self.placeholders:
            smap = build_splice_map(ids, self.placeholder_ids[spec.string], self.filler_id,
                                    spec.num_vectors)
            splice_maps[spec.string] = smap
            for bi in range(ids.shape[0]):
                pos = np.where(smap[bi] == 0)[0]
                if len(pos):
                    subj_rows_pos.append((bi, int(pos[0])))
        emb_mask, pad_mask = prompt_masks(ids, self.tokenizer.bos_token_id,
                                          self.tokenizer.eos_token_id)
        merge_map = None
        if self.cls_delta_tokens and subj_rows_pos:
            if len({r for r, _ in subj_rows_pos}) < ids.shape[0]:
                spans = scan_cls_delta_spans(ids, sorted(subj_rows_pos), self.cls_delta_tokens,
                                             self.max_search_span)
                if spans:
                    merge_map = build_merge_map(*ids.shape, spans)
        return {"ids": ids, "splice_maps": splice_maps, "prompt_emb_mask": emb_mask,
                "prompt_pad_mask": pad_mask, "merge_map": merge_map}

    def embed(self, token_embedding_table: torch.Tensor, plan: dict,
              ada_embs: dict[str, torch.Tensor]) -> torch.Tensor:
        """→ input embeddings [B, S, D] for `CLIPTextModel(input_embs=…)`."""
        device = token_embedding_table.device
        base = token_embedding_table[torch.as_tensor(plan["ids"], device=device).long()]
        for name, smap in plan["splice_maps"].items():
            if name in ada_embs:
                base = splice_ada_embeddings(base, ada_embs[name],
                                             torch.as_tensor(smap, device=device))
        if plan["merge_map"] is not None:
            base = apply_merge_map(base, torch.as_tensor(plan["merge_map"], device=device))
        return base


def extend_token_embedding(token_embedding: torch.Tensor, n_new: int) -> torch.Tensor:
    """[V, D] → [V + n_new, D]; the new rows are the table's mean row."""
    mean = token_embedding.mean(dim=0, keepdim=True).to(token_embedding.dtype)
    return torch.cat([token_embedding, mean.expand(n_new, -1)], dim=0)
