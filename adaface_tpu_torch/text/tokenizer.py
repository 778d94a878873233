"""CLIP BPE tokenizer (host-side, numpy outputs).

Standalone implementation of the OpenAI CLIP tokenization scheme used by
the reference through HF `CLIPTokenizer` (`ldm/modules/encoders/modules.py:
464-470`): lowercase, whitespace-normalize, regex word split, byte→unicode
mapping, BPE merges with `</w>` end-of-word markers, bos/eos wrapping,
padding to max_length with the eos token (so `argmax(ids)` pooling finds
the first real eos).

Loads the standard `vocab.json` + `merges.txt` when available. With no
vocab files in the environment, `character_fallback()` builds a
deterministic character-level vocab with the same special-token layout
(vocab size 49408, bos 49406, eos 49407) so the rest of the stack —
placeholder extension, embedding splicing, argmax pooling — runs
identically offline.

A copy of `adaface_tpu/text/tokenizer.py` (numpy only): the port imports
nothing of the JAX package, so that it runs where JAX is not installed.
The one change is where `default_tokenizer` looks for the vocabulary: in
the repository's `assets/` directory only.

Placeholder tokens (`z_0_0` … per-encoder subject tokens,
`adaface_wrapper.py:415-457`) are appended past the base vocab; callers
extend the embedding table to match (`extend_token_embedding`).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import pathlib
import re

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


class CLIPTokenizer:
    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder[bos_token]
        self.eos_token_id = self.encoder[eos_token]
        self.pad_token_id = self.eos_token_id
        self.base_vocab_size = len(self.encoder)
        self.added_tokens: dict[str, int] = {}
        self.cache: dict[str, str] = {
            bos_token: bos_token, eos_token: eos_token}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPTokenizer":
        with open(vocab_path) as f:
            vocab = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines[1:]:  # first line is a version header
            parts = line.split()
            if len(parts) == 2:
                merges.append(tuple(parts))
        return cls(vocab, merges)

    @classmethod
    def character_fallback(cls, vocab_size: int = 49408) -> "CLIPTokenizer":
        """Deterministic character-level vocab with CLIP's special layout."""
        chars = list(bytes_to_unicode().values())
        vocab: dict[str, int] = {}
        for ch in chars:
            vocab[ch] = len(vocab)
        for ch in chars:
            vocab[ch + "</w>"] = len(vocab)
        i = 0
        while len(vocab) < vocab_size - 2:
            vocab[f"<unused{i}>"] = len(vocab)
            i += 1
        vocab["<|startoftext|>"] = vocab_size - 2
        vocab["<|endoftext|>"] = vocab_size - 1
        return cls(vocab, merges=[])

    # -- BPE ----------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    # -- public API ---------------------------------------------------------
    def add_tokens(self, tokens: list[str]) -> list[int]:
        """Append placeholder tokens; returns their ids."""
        ids = []
        for tok in tokens:
            if tok in self.added_tokens:
                ids.append(self.added_tokens[tok])
                continue
            new_id = self.base_vocab_size + len(self.added_tokens)
            self.added_tokens[tok] = new_id
            self.decoder[new_id] = tok
            ids.append(new_id)
        return ids

    @property
    def vocab_size(self) -> int:
        return self.base_vocab_size + len(self.added_tokens)

    def encode_text(self, text: str) -> list[int]:
        """Text → token ids (no special tokens, no padding)."""
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        # split out added placeholder tokens first (longest match wins)
        if self.added_tokens:
            pattern = "(" + "|".join(
                re.escape(t) for t in sorted(self.added_tokens, key=len, reverse=True)
            ) + ")"
            segments = re.split(pattern, text)
        else:
            segments = [text]
        for seg in segments:
            if seg in self.added_tokens:
                ids.append(self.added_tokens[seg])
                continue
            for token in _WORD_RE.findall(seg):
                token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(
                    self.encoder[t] for t in self.bpe(token).split(" ")
                )
        return ids

    def __call__(
        self,
        texts: str | list[str],
        max_length: int = 77,
        truncation: bool = True,
        padding: bool = True,
    ) -> np.ndarray:
        """→ int32 ids [B, max_length] with bos/eos and eos-padding."""
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for text in texts:
            ids = self.encode_text(text)
            if truncation:
                ids = ids[: max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding:
                row = row + [self.pad_token_id] * (max_length - len(row))
            rows.append(row)
        return np.asarray(rows, np.int32)

    def decode(self, ids) -> str:
        toks = [self.decoder.get(int(i), "") for i in ids]
        words: list[str] = []
        cur: list[str] = []
        for t in toks:
            if t in ("<|startoftext|>", "<|endoftext|>") or not t:
                continue
            if t in self.added_tokens:
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(t)
            elif t.endswith("</w>"):
                cur.append(t[:-4])
                words.append("".join(cur))
                cur = []
            else:
                cur.append(t)
        if cur:
            words.append("".join(cur))

        def debyte(word: str) -> str:
            if word in self.added_tokens:
                return word
            raw = bytearray(
                self.byte_decoder[c] for c in word if c in self.byte_decoder
            )
            return raw.decode("utf-8", errors="replace")

        return " ".join(debyte(w) for w in words).strip()


def zero_pad_after_eos(ids, eos_id: int) -> np.ndarray:
    """Every id after a row's first eos set to 0 (`zero_pad_after_eos`,
    `adaface_tpu/text/tokenizer.py:249-262`): the OpenCLIP-bigG tokenizer
    of SDXL and SD3 (their tokenizer_2) pads with 0 where CLIP-L pads with
    eos, and every position's hidden state feeds the context."""
    ids = np.asarray(ids)
    first_eos = np.argmax(ids == eos_id, axis=1)
    past = np.arange(ids.shape[1])[None, :] > first_eos[:, None]
    return np.where(past, 0, ids)


_default: CLIPTokenizer | None = None

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "assets"


def default_tokenizer() -> CLIPTokenizer:
    """Real vocab from the repository's assets/ if present, else the
    character fallback. A process-wide instance: `add_tokens` on it is seen
    by every caller."""
    global _default
    if _default is None:
        vocab, merges = ASSETS / "clip_vocab.json", ASSETS / "clip_merges.txt"
        if vocab.exists() and merges.exists():
            _default = CLIPTokenizer.from_files(str(vocab), str(merges))
        else:
            _default = CLIPTokenizer.character_fallback()
    return _default
