"""HF transformers CLIP checkpoints → parameter trees and configs.

Counterpart of `adaface_tpu/tools/convert_clip.py`, in numpy: any mapping
of parameter name → array (a torch state dict as numpy, a safetensors
file). The SD1.5 text encoder, Arc2Face's finetuned one, and the OpenAI
CLIP-L and laion CLIP-H vision towers share these layouts. Linear weights
go from torch's [out, in] to [in, out]. The trees are the JAX package's
(`convert_sd.arr` canonicalizes dtypes as `jax.numpy.asarray` does); the
configs are the port's `CLIPTextConfig` / `CLIPVisionConfig`.

MKV-extended k/v projections (an out-dimension a multiple of the hidden
size) convert as they are; `core.bridge.load` builds the tower's layers at
those widths (`models.clip`'s MKV attention).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from adaface_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from adaface_tpu_torch.tools.convert_sd import arr


def _ln(sd: Mapping[str, np.ndarray], prefix: str):
    return {"scale": arr(sd[f"{prefix}.weight"]), "bias": arr(sd[f"{prefix}.bias"])}


def _linear(sd: Mapping[str, np.ndarray], prefix: str):
    return {"w": arr(np.asarray(sd[f"{prefix}.weight"]).T.copy()),
            "b": arr(sd[f"{prefix}.bias"])}


def _encoder_layer(sd, prefix: str):
    return {"ln1": _ln(sd, f"{prefix}.layer_norm1"),
            "attn": {name: _linear(sd, f"{prefix}.self_attn.{hf}")
                     for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                      ("o", "out_proj"))},
            "ln2": _ln(sd, f"{prefix}.layer_norm2"),
            "mlp": {"fc1": _linear(sd, f"{prefix}.mlp.fc1"),
                    "fc2": _linear(sd, f"{prefix}.mlp.fc2")}}


def _num_layers(sd, stem: str) -> int:
    n = 0
    while f"{stem}.layers.{n}.layer_norm1.weight" in sd:
        n += 1
    return n


def convert_text_model(sd: Mapping[str, np.ndarray], prefix: str = "text_model.",
                       num_heads: int | None = None,
                       hidden_act: str = "quick_gelu") -> tuple[dict, CLIPTextConfig]:
    """An HF CLIPTextModel state dict → (tree, config) (`convert_clip.py:63`).
    The head count is not in the shapes: head dim 64 (every shipped CLIP
    text tower) unless `num_heads` is given. A `text_projection.weight`
    (CLIPTextModelWithProjection: SDXL's and SD3's towers) is carried into
    the tree as the bias-free `text_projection`, its width into the
    config's `projection_dim`."""
    tok = np.asarray(sd[f"{prefix}embeddings.token_embedding.weight"])
    pos = np.asarray(sd[f"{prefix}embeddings.position_embedding.weight"])
    stem = f"{prefix}encoder"
    n_layers = _num_layers(sd, stem)
    d = tok.shape[1]
    fc1 = np.asarray(sd[f"{stem}.layers.0.mlp.fc1.weight"])
    proj = next((np.asarray(sd[key]) for key in ("text_projection.weight",
                                                  f"{prefix}text_projection.weight")
                 if key in sd), None)
    cfg = CLIPTextConfig(vocab_size=tok.shape[0], hidden_size=d, num_layers=n_layers,
                         num_heads=num_heads if num_heads is not None else max(d // 64, 1),
                         intermediate_size=fc1.shape[0], max_position_embeddings=pos.shape[0],
                         hidden_act=hidden_act,
                         projection_dim=None if proj is None else proj.shape[0])
    params = {"token_embedding": arr(tok), "position_embedding": arr(pos),
              "layers": [_encoder_layer(sd, f"{stem}.layers.{i}") for i in range(n_layers)],
              "final_ln": _ln(sd, f"{prefix}final_layer_norm")}
    if proj is not None:
        params["text_projection"] = {"w": arr(proj.T.copy())}
    return params, cfg


def convert_vision_model(sd: Mapping[str, np.ndarray], prefix: str = "vision_model.",
                         num_heads: int | None = None) -> tuple[dict, CLIPVisionConfig]:
    """An HF CLIPVisionModel state dict → (tree, config)
    (`convert_clip.py:109`). Head dim 80 for a 1280-wide tower (ViT-H/14),
    else 64, unless `num_heads` is given."""
    patch = np.asarray(sd[f"{prefix}embeddings.patch_embedding.weight"])
    pos = np.asarray(sd[f"{prefix}embeddings.position_embedding.weight"])
    stem = f"{prefix}encoder"
    n_layers = _num_layers(sd, stem)
    d = patch.shape[0]
    fc1 = np.asarray(sd[f"{stem}.layers.0.mlp.fc1.weight"])
    n_patches = pos.shape[0] - 1
    patch_size = patch.shape[-1]
    has_proj = "visual_projection.weight" in sd
    cfg = CLIPVisionConfig(
        hidden_size=d, num_layers=n_layers,
        num_heads=num_heads if num_heads is not None else (
            d // 80 if d == 1280 else max(d // 64, 1)),
        intermediate_size=fc1.shape[0], image_size=int(np.sqrt(n_patches)) * patch_size,
        patch_size=patch_size,
        projection_dim=np.asarray(sd["visual_projection.weight"]).shape[0] if has_proj else None)
    params = {"class_embedding": arr(sd[f"{prefix}embeddings.class_embedding"]),
              "patch_embedding": arr(patch), "position_embedding": arr(pos),
              "pre_ln": _ln(sd, f"{prefix}pre_layrnorm"),  # HF's spelling
              "layers": [_encoder_layer(sd, f"{stem}.layers.{i}") for i in range(n_layers)],
              "post_ln": _ln(sd, f"{prefix}post_layernorm")}
    if has_proj:
        w = np.asarray(sd["visual_projection.weight"]).T.copy()
        b = sd.get("visual_projection.bias")
        params["visual_projection"] = {
            "w": arr(w), "b": arr(b) if b is not None else np.zeros((w.shape[1],), np.float32)}
    return params, cfg

