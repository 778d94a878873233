"""Token-embedding table growth for added placeholder tokens.

Counterpart of `extend_token_embedding` in
`adaface_tpu/text/embedding_manager.py:305-312` (`extend_nn_embedding`,
`adaface/util.py:77-94` in the reference).
"""

from __future__ import annotations

import torch


def extend_token_embedding(token_embedding: torch.Tensor, n_new: int) -> torch.Tensor:
    """[V, D] → [V + n_new, D]; the new rows are the table's mean row."""
    mean = token_embedding.mean(dim=0, keepdim=True).to(token_embedding.dtype)
    return torch.cat([token_embedding, mean.expand(n_new, -1)], dim=0)
