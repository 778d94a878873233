"""CLIP text transformer (text side only).

Counterpart of the text half of `adaface_tpu/models/clip.py`: `text_encode`
with `input_embs` injection and CLIP-skip `skip_weights`, token lookup, and
position-embedding extension. Attention here is plain PyTorch (77 tokens,
causal), as the JAX tower ran through XLA and never through the flash
kernel. The module's parameter names mirror the JAX pytree (`layers.3.attn.q`
is `p["layers"][3]["attn"]["q"]`), which is what `core/bridge.py` relies on.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from adaface_tpu_torch.core.params import normal_


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # OpenAI CLIP; laion towers use "gelu"


CLIP_L_TEXT = CLIPTextConfig()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": quick_gelu,
         "gelu": lambda x: nn.functional.gelu(x, approximate="tanh")}


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = nn.ModuleDict({n: nn.Linear(d, d) for n in ("q", "k", "v", "o")})
        self.ln2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(d, cfg.intermediate_size),
                                  "fc2": nn.Linear(cfg.intermediate_size, d)})
        self.num_heads = cfg.num_heads
        self.act = _ACTS[cfg.hidden_act]

    def _attention(self, x):
        """Causal self-attention, fp32 softmax (`_mkv_attention`, mult 1)."""
        b, s, d = x.shape
        hd = d // self.num_heads
        split = lambda t: t.reshape(b, s, self.num_heads, hd).transpose(1, 2)
        q, k, v = (split(self.attn[n](x)) for n in ("q", "k", "v"))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        rows = torch.arange(s, device=x.device)[:, None]
        cols = torch.arange(s, device=x.device)[None, :]
        logits = logits + torch.where(cols <= rows, 0.0, -1e9)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs.float(), v.float()).to(x.dtype)
        return self.attn["o"](out.transpose(1, 2).reshape(b, s, d))

    def forward(self, x):
        x = x + self._attention(self.ln1(x))
        return x + self.mlp["fc2"](self.act(self.mlp["fc1"](self.ln2(x))))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIP_L_TEXT):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, input_embs=None, skip_weights=None):
        """→ last_hidden_state [B, S, D] (`text_encode`, `clip.py:303-365`).

        input_embs [B, S, D] replaces the token lookup; skip_weights [k] or
        [k, D] weights the last k hidden states (embeddings + layer outputs),
        normalised over k, before the final LayerNorm.
        """
        if input_embs is None:
            input_embs = self.token_embedding[input_ids]
        s = input_embs.shape[1]
        x = input_embs + self.position_embedding[None, :s]
        states = [x]
        for layer in self.layers:
            x = layer(x)
            states.append(x)
        if skip_weights is not None:
            w = skip_weights.float()
            if w.dim() == 1:
                w = w[:, None]
            w = w / w.sum(dim=0, keepdim=True)
            stacked = torch.stack(states[-w.shape[0]:], dim=0).float()
            x = (stacked * w[:, None, None, :]).sum(dim=0).to(x.dtype)
        return self.final_ln(x)


def token_embeddings(model: CLIPTextModel, input_ids):
    """Token lookup alone (`clip.py:367`)."""
    return model.token_embedding[input_ids]


def extend_position_embedding(model: CLIPTextModel, new_len: int) -> None:
    """Grow the position table to new_len by repeating its last rows
    (`clip.py:454-464`). Updates the module in place."""
    pe = model.position_embedding
    cur = pe.shape[0]
    if new_len <= cur:
        return
    with torch.no_grad():
        grown = torch.cat([pe, pe[-(new_len - cur):]], dim=0)
    model.position_embedding = nn.Parameter(grown, requires_grad=pe.requires_grad)


def init_text_weights_(model: CLIPTextModel, gen: torch.Generator) -> None:
    """`init_text_params` scales: linears N(0, 0.02²), token table
    N(0, 0.02²), positions N(0, 0.01²), norms 1/0, biases 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            normal_(m.weight, 0.02, gen)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    normal_(model.token_embedding, 0.02, gen)
    normal_(model.position_embedding, 0.01, gen)
