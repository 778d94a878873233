"""Flat state dicts on disk (`.safetensors`, `.npz`) and checkpoint surgery.

Counterpart of `adaface_tpu/tools/ckpt_lib.py`, in numpy: `flatten_tree`
(a nested tree → dot-keyed numpy arrays), `unflatten_tree` (its inverse),
`save_state_dict` and `load_state_dict` (`:23-86`), and the surgeries of the
reference's checkpoint scripts: `replace_subtree` (`:94`), `extract_subtree`
(`:114`), `average_state_dicts` (`:123`), `cast_fp16` (`:143`),
`model_diff` (`:150`), `check_weights` (`:166`), `replace_by_pattern`
(`:183`) and `clean_log_folders` (`:200`); `scripts/ckpt_tool_torch.py` is
their command line. So that training needs
no `safetensors` package, the format is written and read here: an 8-byte little-endian header length, a JSON header (each tensor's
dtype, shape and byte offsets, padded with spaces to 8 bytes), then the raw
little-endian data of the tensors back to back. Files it writes load with
`safetensors.numpy.load_file`, and files that writes load here.
"""

from __future__ import annotations

import fnmatch
import json
import os
import re
import shutil
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


def replace_subtree(base: StateDict, donor: StateDict, prefix: str,
                    donor_prefix: str | None = None) -> StateDict:
    """Every `prefix*` key of `base` that the donor has under `donor_prefix`
    (default `prefix`) takes the donor's value (`repl_vae.py`,
    `repl_textencoder.py`); raises where none matched."""
    donor_prefix = prefix if donor_prefix is None else donor_prefix
    out = dict(base)
    replaced = 0
    for k in base:
        dk = donor_prefix + k[len(prefix):]
        if k.startswith(prefix) and dk in donor:
            out[k] = donor[dk]
            replaced += 1
    if replaced == 0:
        raise KeyError(f"no keys under '{prefix}' matched the donor")
    return out


def extract_subtree(sd: StateDict, prefix: str, strip: bool = True) -> StateDict:
    """The entries under `prefix` (e.g. `model.diffusion_model.`), the
    prefix stripped unless `strip` is False; raises where there is none."""
    out = {k[len(prefix):] if strip else k: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no keys under '{prefix}'")
    return out


def average_state_dicts(sds: list[StateDict], weights: list[float] | None = None) -> StateDict:
    """The weighted average of the keys every state dict has, summed in fp64
    and cast back to the first one's dtype; non-float arrays are the first
    one's (`avg_models.py`). Weights default to 1/n each."""
    weights = weights or [1.0 / len(sds)] * len(sds)
    if len(weights) != len(sds):
        raise ValueError(f"{len(weights)} weights for {len(sds)} state dicts")
    keys = set(sds[0]).intersection(*sds[1:])
    out: StateDict = {}
    for k in keys:
        first = sds[0][k]
        if not np.issubdtype(first.dtype, np.floating):
            out[k] = first
            continue
        acc = np.zeros_like(first, np.float64)
        for w, sd in zip(weights, sds):
            acc += w * sd[k].astype(np.float64)
        out[k] = acc.astype(first.dtype)
    return out


def cast_fp16(sd: StateDict) -> StateDict:
    """Floating arrays to fp16, the others as they are."""
    return {k: v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in sd.items()}


def model_diff(a: StateDict, b: StateDict, topk: int = 20):
    """(the `topk` keys both have with the largest mean |a - b| (fp64), inf
    where the shapes differ, largest first; the keys only in b; the keys
    only in a) (`modeldiff.py`)."""
    rows = []
    for k in sorted(set(a) & set(b)):
        if a[k].shape != b[k].shape:
            rows.append((k, float("inf")))
        elif np.issubdtype(a[k].dtype, np.floating):
            rows.append((k, float(np.abs(a[k].astype(np.float64)
                                         - b[k].astype(np.float64)).mean())))
    rows.sort(key=lambda r: -r[1])
    return rows[:topk], sorted(set(b) - set(a)), sorted(set(a) - set(b))


def check_weights(sd: StateDict) -> dict:
    """Parameter and tensor counts, and the float keys holding a NaN, an inf
    or only zeros (`chk_ckpt_weights.py`)."""
    stats = {"n_params": 0, "n_tensors": len(sd), "nan_keys": [], "inf_keys": [],
             "zero_keys": []}
    for k, v in sd.items():
        stats["n_params"] += int(v.size)
        if not np.issubdtype(v.dtype, np.floating):
            continue
        if np.isnan(v).any():
            stats["nan_keys"].append(k)
        if np.isinf(v).any():
            stats["inf_keys"].append(k)
        if np.abs(v).max() == 0:
            stats["zero_keys"].append(k)
    return stats


def replace_by_pattern(base: StateDict, donor: StateDict, patterns: list[str],
                       use_regex: bool = False) -> StateDict:
    """The keys of `base` that match a glob (or, with `use_regex`, a regex
    searched anywhere in the key) and that the donor has take the donor's
    value (`repl_by_pat.py`); raises where none did."""
    out = dict(base)
    n = 0
    for k in base:
        if k in donor and any(re.search(p, k) if use_regex else fnmatch.fnmatch(k, p)
                              for p in patterns):
            out[k] = donor[k]
            n += 1
    if n == 0:
        raise KeyError(f"no keys matched {patterns}")
    return out


STEP_ENTRY = re.compile(r"embeddings_gs-(\d+)(\.pt|\.ckpt|\.safetensors)?$")


def clean_log_folders(root: str, pat: str, skip_pat: str | None = None, keep: int = 1,
                      del_samples: bool = False, mock: bool = False) -> int:
    """Prune old periodic checkpoints under a root of training-log folders:
    in every `<root>/<run>/checkpoints` whose path matches the regex `pat`
    and not `skip_pat`, all but the `keep` largest-step `embeddings_gs-<step>`
    entries (directories or single files) are removed, and with
    `del_samples` the run's `samples/` folder too. → the number of
    checkpoints removed (with `mock`, that would be; nothing is removed)."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    n_deleted = 0
    for run in sorted(os.listdir(root)):
        ckpt_dir = os.path.join(root, run, "checkpoints")
        if not os.path.isdir(ckpt_dir) or not re.search(pat, ckpt_dir):
            continue
        if skip_pat and re.search(skip_pat, ckpt_dir):
            print(f"skipping: {ckpt_dir}")
            continue
        entries = sorted((int(m.group(1)), name) for name in os.listdir(ckpt_dir)
                         if (m := STEP_ENTRY.fullmatch(name)))
        drop, kept = (entries[:-keep], entries[-keep:]) if keep > 0 else (entries, [])
        for _, name in drop:
            path = os.path.join(ckpt_dir, name)
            print(f"{'would delete' if mock else 'deleting'}: {path}")
            if not mock and os.path.isdir(path):
                shutil.rmtree(path)
            elif not mock:
                os.remove(path)
            n_deleted += 1
        for _, name in kept:
            print(f"keeping:  {os.path.join(ckpt_dir, name)}")
        samples = os.path.join(root, run, "samples")
        if del_samples and os.path.isdir(samples):
            print(f"{'would delete' if mock else 'deleting'}: {samples}")
            if not mock:
                shutil.rmtree(samples)
    return n_deleted


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
