"""The YAML of the training configurations, without PyYAML.

The card's machine need not have PyYAML, so `train_torch.py` reads its
configurations with this parser of the subset `configs/*.yaml` use: nested
block mappings by indentation, inline lists `[a, b]` and mappings
`{k: v}`, `#` comments, and PyYAML's (YAML 1.1) scalars: null, booleans,
integers, floats with a dot, quoted and plain strings. Anything else (block
sequences, anchors, multi-line scalars) raises. `apply_dotlist` applies
`key.path=value` overrides as `train.py` does.
"""

from __future__ import annotations

import re

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|^[-+]?\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_SPECIAL_FLOATS = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
                   ".nan": float("nan")}


def scalar(text: str):
    """A plain or quoted YAML 1.1 scalar → None, bool, int, float or str."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if t.lower() in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[t.lower()]
    return t


def _split_flow(body: str) -> list[str]:
    """Top-level comma-separated items of a flow collection's body."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def value(text: str):
    """A scalar or an inline list / mapping."""
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"unterminated list: {text!r}")
        return [value(i) for i in _split_flow(t[1:-1])]
    if t.startswith("{"):
        if not t.endswith("}"):
            raise ValueError(f"unterminated mapping: {text!r}")
        out = {}
        for item in _split_flow(t[1:-1]):
            key, sep, val = item.partition(":")
            if not sep:
                raise ValueError(f"mapping item without a key: {item!r}")
            out[scalar(key)] = value(val)
        return out
    if t.startswith(("- ", "&", "*", "|", ">", "!")) or t == "-":
        raise ValueError(f"YAML construct not supported: {text!r}")
    return scalar(t)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Block(dict):
    """A mapping opened by a 'key:' line (None if nothing follows it)."""


def _close(d: dict) -> dict:
    return {k: (_close(v) if v else None) if isinstance(v, _Block) else v for k, v in d.items()}


def loads(text: str) -> dict:
    """A configuration's text → nested dicts."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or (rest and not rest.startswith((" ", "\t"))):
            raise ValueError(f"line {n}: not a 'key: value' line: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest.strip():
            parent[scalar(key)] = value(rest)
        else:
            child = _Block()
            parent[scalar(key)] = child
            stack.append((indent, child))
    return _close(root)


def load(path: str) -> dict:
    with open(path) as f:
        return loads(f.read())


def apply_dotlist(cfg: dict, overrides: list[str]) -> dict:
    """`a.b=v` overrides into cfg, v read as a YAML value."""
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value(val)
    return cfg
