"""Flat state dicts on disk: `.safetensors` and `.npz`.

Counterpart of the io half of `adaface_tpu/tools/ckpt_lib.py` (`:23-86`,
`cast_fp16` `:143`): `flatten_tree` (a nested tree → dot-keyed numpy arrays),
`unflatten_tree` (its inverse), `extract_subtree` (`:114`), `cast_fp16`,
`save_state_dict` and `load_state_dict`. So that training needs
no `safetensors` package, the format is written and read here: an 8-byte little-endian header length, a JSON header (each tensor's
dtype, shape and byte offsets, padded with spaces to 8 bytes), then the raw
little-endian data of the tensors back to back. Files it writes load with
`safetensors.numpy.load_file`, and files that writes load here.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping

import numpy as np

StateDict = dict[str, np.ndarray]

# safetensors dtype names (bf16 has no numpy dtype and is not read or written here)
_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def flatten_tree(tree, prefix: str = "") -> StateDict:
    """Nested dicts and lists → a flat dot-keyed dict of numpy arrays (list
    items keyed by index); None leaves are dropped."""
    flat: StateDict = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}{i}."))
    elif tree is not None:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    """A flat dot-keyed dict → nested dicts (the inverse of `flatten_tree`
    up to lists, which come back as dicts keyed "0", "1", ...)."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def extract_subtree(sd: StateDict, prefix: str, strip: bool = True) -> StateDict:
    """The entries under `prefix` (e.g. `model.diffusion_model.`), the
    prefix stripped unless `strip` is False; raises where there is none."""
    out = {k[len(prefix):] if strip else k: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys under '{prefix}'")
    return out


def cast_fp16(sd: StateDict) -> StateDict:
    """Floating arrays to fp16, the others as they are."""
    return {k: v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in sd.items()}


def save_safetensors(sd: Mapping[str, np.ndarray], path: str) -> None:
    """Write `sd` in the safetensors format, tensors in key order."""
    header, offset, blobs = {}, 0, []
    for key in sorted(sd):
        a = np.ascontiguousarray(sd[key])
        if a.dtype not in _NAMES:
            raise ValueError(f"{key}: dtype {a.dtype} has no safetensors name here")
        data = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[key] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape),
                       "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)
    os.replace(tmp, path)


def load_safetensors(path: str) -> StateDict:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        body = f.read()
    out: StateDict = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {key} has dtype {info['dtype']}, not read here")
        begin, end = info["data_offsets"]
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[key] = np.frombuffer(body[begin:end], dtype=dtype).reshape(info["shape"]).copy()
    return out


def load_state_dict(path: str) -> StateDict:
    """`.safetensors`, `.npz`, or a torch checkpoint (`.ckpt`, `.pt`,
    `.pth`, `.bin`; its `state_dict` where it has one) → numpy arrays."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors":
        return load_safetensors(path)
    if ext == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    if ext in (".ckpt", ".pt", ".pth", ".bin"):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=True)
        sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
        return {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
                for k, v in sd.items()}
    raise ValueError(f"unsupported checkpoint format: {path}")


def save_state_dict(sd: Mapping[str, np.ndarray], path: str) -> None:
    """`.safetensors` or `.npz` by the path's extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".safetensors":
        save_safetensors(sd, path)
    elif ext == ".npz":
        np.savez(path, **sd)
    else:
        raise ValueError(f"unsupported save format: {path} (use .safetensors or .npz)")
