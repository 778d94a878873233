"""Token merging (ToMe) for the SD UNet's spatial transformer blocks.

Counterpart of `adaface_tpu/ops/tome.py`: bipartite soft matching between a
strided destination grid (one token per sx×sy cell, at a seeded in-cell
offset) and the other, source, tokens (Bolya & Hoffman, "Token Merging for
Fast Stable Diffusion", arXiv:2303.17604). The r sources most similar to any
destination are averaged into their match before an op and copied back from
it after ("unmerge"). The merge is rebuilt in each block from the block's
own tokens.

As in the JAX function, r and the partition are fixed by the shapes and the
config, and only the match indices depend on the data: nothing is read back
to the host, so a request stays one stream of launches. The partition is
computed once per shape with numpy (cached as numpy; its device copies are
cached per device). The cosine scores are fp32 products of the tokens'
dtype (JAX's `preferred_element_type=float32`); the matching takes the first
index on ties and a stable sort, as `jnp.argmax` and `jnp.argsort` do.

The merged sums are taken in a fixed order: `index_put_(accumulate=True)`
sorts the targets (stably) and sums each target's run of sources in that
order, on the CPU and on CUDA alike, with no float atomics, so two runs of a
ToMe request give the same bits (`chip_smoke.py` checks it). `index_add_`
and `scatter_add_` would add with atomics on CUDA, in an order that changes
from run to run.

`match` is the whole data-dependent part: `chip_smoke.py` records its
decisions in one run and replays them in another to hold two paths to each
other without a discrete choice between them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ToMeConfig:
    """ratio: fraction of all tokens merged away (0.5: 4096 → 2048 tokens).
    min_tokens: merge only in blocks with at least this many spatial tokens
    (4096 = SD1.5's level 0; 1024 adds level 1). merge_crossattn /
    merge_mlp: also run the cross-attention's queries / the GEGLU
    feed-forward on the merged tokens. rand_seed: seeds the per-cell
    destination offsets (None: the top-left of each cell)."""

    ratio: float = 0.5
    min_tokens: int = 4096
    sx: int = 2
    sy: int = 2
    merge_crossattn: bool = False
    merge_mlp: bool = False
    rand_seed: int | None = 0


@functools.lru_cache(maxsize=None)
def _partition(h: int, w: int, sx: int, sy: int, rand_seed: int | None = 0):
    """→ (dst_idx, src_idx, inv), int32 numpy: the destination and source
    tokens of the row-major (h, w) grid, one destination per sx×sy cell at a
    seeded offset (clipped at the ragged right and bottom edges), and the
    permutation that takes concat([dst, src]) back to token order."""
    hh, ww = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    if rand_seed is None:
        is_dst = ((hh % sy == 0) & (ww % sx == 0)).reshape(-1)
    else:
        rs = np.random.RandomState(rand_seed)
        n_cy = (h + sy - 1) // sy
        n_cx = (w + sx - 1) // sx
        dy = rs.randint(0, sy, size=(n_cy, n_cx))
        dx = rs.randint(0, sx, size=(n_cy, n_cx))
        cy, cx = hh // sy, ww // sx
        ty = np.minimum(cy * sy + dy[cy, cx], h - 1)
        tx = np.minimum(cx * sx + dx[cy, cx], w - 1)
        is_dst = ((hh == ty) & (ww == tx)).reshape(-1)
    dst_idx = np.nonzero(is_dst)[0]
    src_idx = np.nonzero(~is_dst)[0]
    inv = np.empty(h * w, np.int32)
    inv[dst_idx] = np.arange(len(dst_idx))
    inv[src_idx] = len(dst_idx) + np.arange(len(src_idx))
    return dst_idx.astype(np.int32), src_idx.astype(np.int32), inv


@functools.lru_cache(maxsize=None)
def _partition_on(h: int, w: int, sx: int, sy: int, rand_seed, device: torch.device):
    """`_partition` as int64 tensors on `device`, copied there once."""
    return tuple(torch.as_tensor(a, dtype=torch.long, device=device)
                 for a in _partition(h, w, sx, sy, rand_seed))


def match(x: torch.Tensor, h: int, w: int, r: int, sx: int = 2, sy: int = 2,
          rand_seed: int | None = 0):
    """The matching of `build_merge`: → (merged_pos [B, r], kept_pos
    [B, Nsrc - r], tgt [B, r]), int64: positions into the source list,
    ordered by each source's best cosine score, highest first, and the
    destination each merged source goes to."""
    dst_idx, src_idx, _ = _partition_on(h, w, sx, sy, rand_seed, x.device)
    norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
    metric = x / (norm + 1e-6).to(x.dtype)
    scores = torch.bmm(metric[:, src_idx].float(),
                       metric[:, dst_idx].float().transpose(1, 2))  # [B, Nsrc, Ndst]
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)  # the first index on ties
    order = torch.argsort(-node_max, dim=-1, stable=True)
    merged_pos, kept_pos = order[:, :r], order[:, r:]
    return merged_pos, kept_pos, torch.gather(node_idx, 1, merged_pos)


def build_merge(x: torch.Tensor, h: int, w: int, r: int, sx: int = 2, sy: int = 2,
                rand_seed: int | None = 0):
    """→ (merge, unmerge, n_kept), as `adaface_tpu/ops/tome.py:build_merge`.

    x [B, N, C] (N = h·w) gives the cosine metric; merge / unmerge then apply
    to any [B, N, C'] tensor. merge: [B, N, C'] → [B, N - r, C'] in the
    layout [dst ‖ kept src], each destination the fp32 mean of itself and
    its merged sources. unmerge: [B, N - r, C'] → [B, N, C'], each merged
    source a copy of its destination's output."""
    b, n, _ = x.shape
    if n != h * w:
        raise ValueError(f"ToMe: {n} tokens for a {h}x{w} map")
    dst_idx, src_idx, inv = _partition_on(h, w, sx, sy, rand_seed, x.device)
    n_dst, n_src = dst_idx.shape[0], src_idx.shape[0]
    r = max(0, min(int(r), n_src))
    merged_pos, kept_pos, tgt = match(x, h, w, r, sx, sy, rand_seed)
    brow = torch.arange(b, device=x.device)[:, None].expand(b, r)
    merged_tok = src_idx[merged_pos]  # [B, r] token positions
    kept_tok = src_idx[kept_pos]
    cnt = torch.zeros(b, n_dst, dtype=torch.float32, device=x.device)
    cnt.index_put_((brow, tgt), torch.ones(b, r, device=x.device), accumulate=True)
    # unmerge as one gather: token t reads its destination's row, a kept
    # source its own row after the destinations, a merged source its target's
    rank = torch.empty(b, n_src, dtype=torch.long, device=x.device)
    rank.scatter_(1, torch.cat([merged_pos, kept_pos], dim=1),
                  torch.arange(n_src, device=x.device).expand(b, n_src))
    tgt_of_rank = torch.cat([tgt, torch.zeros_like(kept_pos)], dim=1)
    src_row = torch.where(rank < r, torch.gather(tgt_of_rank, 1, rank), n_dst + rank - r)
    rows = torch.cat([torch.arange(n_dst, device=x.device).expand(b, n_dst), src_row], dim=1)
    rows = rows[:, inv]  # [B, N]: the row of the merged tensor each token reads

    def rows_of(t, idx):
        return torch.gather(t, 1, idx[..., None].expand(*idx.shape, t.shape[-1]))

    def merge(tokens: torch.Tensor) -> torch.Tensor:
        xd = tokens[:, dst_idx]
        acc = torch.zeros(xd.shape, dtype=torch.float32, device=tokens.device)
        acc.index_put_((brow, tgt), rows_of(tokens, merged_tok).float(), accumulate=True)
        xd = ((xd.float() + acc) / (1.0 + cnt)[..., None]).to(tokens.dtype)
        return torch.cat([xd, rows_of(tokens, kept_tok)], dim=1)

    def unmerge(y: torch.Tensor) -> torch.Tensor:
        return rows_of(y, rows)

    return merge, unmerge, n - r
