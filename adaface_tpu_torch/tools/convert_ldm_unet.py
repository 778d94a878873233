"""LDM (CompVis) UNet state dicts → diffusers names → the UNet tree.

Counterpart of `adaface_tpu/tools/convert_ldm_unet.py:33-134`: the
`model.diffusion_model.*` keys of a single file (`v1-5-pruned.ckpt`) are
renamed to the diffusers `UNet2DConditionModel` layout, then converted by
`convert_sd.convert_unet`. The renaming is one table of (LDM prefix,
diffusers prefix) pairs, `ldm_unet_key_pairs`, which a writer of single
files can also read the other way.

Per down block i, input_blocks[3i+1, 3i+2] hold (resnet, attention) pairs
and input_blocks[3i+3] the downsampler; the output blocks mirror this with
three resnets a block and the upsampler on the last entry.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np

from adaface_tpu_torch.models.unet import SD15_UNET, UNetConfig
from adaface_tpu_torch.tools.convert_sd import convert_unet

RESNET_MAP = [("in_layers.0", "norm1"), ("in_layers.2", "conv1"),
              ("emb_layers.1", "time_emb_proj"), ("out_layers.0", "norm2"),
              ("out_layers.3", "conv2"), ("skip_connection", "conv_shortcut")]
_BLOCK_INNER = ("norm1", "attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0", "norm2",
                "attn2.to_q", "attn2.to_k", "attn2.to_v", "attn2.to_out.0", "norm3",
                "ff.net.0.proj", "ff.net.2")


def _attn_map(depth: int = 1) -> list[tuple[str, str]]:
    """A spatial transformer's pairs for `depth` stacked blocks: LDM and
    diffusers use the same inner names."""
    pairs = [("norm", "norm"), ("proj_in", "proj_in"), ("proj_out", "proj_out")]
    for d in range(depth):
        pairs += [(f"transformer_blocks.{d}.{inner}",) * 2 for inner in _BLOCK_INNER]
    return pairs


def ldm_unet_key_pairs(cfg: UNetConfig = SD15_UNET) -> Iterator[tuple[str, str]]:
    """(LDM prefix, diffusers prefix) of every module of the UNet, without
    `model.diffusion_model.`; each prefix takes `.weight` and `.bias`."""
    n_blocks = len(cfg.block_channels)
    lpb = cfg.layers_per_block
    depth = getattr(cfg, "transformer_depth", (1,) * n_blocks)

    def block_attn_map(bi: int):
        return _attn_map(depth[bi] if bi < len(depth) else 1)

    yield from [("time_embed.0", "time_embedding.linear_1"),
                ("time_embed.2", "time_embedding.linear_2"),
                ("label_emb.0.0", "add_embedding.linear_1"),  # SDXL's text_time MLP
                ("label_emb.0.2", "add_embedding.linear_2"),
                ("input_blocks.0.0", "conv_in"), ("out.0", "conv_norm_out"),
                ("out.2", "conv_out")]
    # down: lpb (resnet[, attention]) entries a block, then its downsampler
    idx = 1
    for bi in range(n_blocks):
        for li in range(lpb):
            for ls, ds in RESNET_MAP:
                yield f"input_blocks.{idx}.0.{ls}", f"down_blocks.{bi}.resnets.{li}.{ds}"
            if cfg.down_has_attn[bi]:
                for ls, ds in block_attn_map(bi):
                    yield f"input_blocks.{idx}.1.{ls}", f"down_blocks.{bi}.attentions.{li}.{ds}"
            idx += 1
        if bi < n_blocks - 1:
            yield f"input_blocks.{idx}.0.op", f"down_blocks.{bi}.downsamplers.0.conv"
            idx += 1
    for ls, ds in RESNET_MAP:
        yield f"middle_block.0.{ls}", f"mid_block.resnets.0.{ds}"
        yield f"middle_block.2.{ls}", f"mid_block.resnets.1.{ds}"
    for ls, ds in _attn_map(getattr(cfg, "mid_transformer_depth", 1)):
        yield f"middle_block.1.{ls}", f"mid_block.attentions.0.{ds}"
    # up: lpb + 1 entries a block, the upsampler in the last sub-module of
    # the last entry; up block bi mirrors down block n - 1 - bi
    idx = 0
    for bi in range(n_blocks):
        for li in range(lpb + 1):
            for ls, ds in RESNET_MAP:
                yield f"output_blocks.{idx}.0.{ls}", f"up_blocks.{bi}.resnets.{li}.{ds}"
            if cfg.up_has_attn[bi]:
                for ls, ds in block_attn_map(n_blocks - 1 - bi):
                    yield f"output_blocks.{idx}.1.{ls}", f"up_blocks.{bi}.attentions.{li}.{ds}"
            if li == lpb and bi < n_blocks - 1:
                sub = 2 if cfg.up_has_attn[bi] else 1
                yield f"output_blocks.{idx}.{sub}.conv", f"up_blocks.{bi}.upsamplers.0.conv"
            idx += 1


def ldm_unet_to_diffusers_keys(sd: Mapping[str, np.ndarray],
                               cfg: UNetConfig = SD15_UNET) -> dict[str, np.ndarray]:
    """`model.diffusion_model.*` keys (or the same without the prefix) →
    diffusers UNet keys."""
    pre = "model.diffusion_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    src = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out: dict[str, np.ndarray] = {}
    for ldm_key, df_key in ldm_unet_key_pairs(cfg):
        for suf in (".weight", ".bias"):
            if ldm_key + suf in src:
                out[df_key + suf] = src[ldm_key + suf]
    return out


def convert_ldm_unet(sd: Mapping[str, np.ndarray], cfg: UNetConfig = SD15_UNET) -> dict:
    """An LDM single file's state dict → the UNet tree."""
    return convert_unet(ldm_unet_to_diffusers_keys(sd, cfg), cfg)
