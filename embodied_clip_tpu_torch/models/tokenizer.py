"""CLIP-compatible byte-pair-encoding tokenizer (pure Python; a copy of
`embodied_clip_tpu/models/tokenizer.py`, which imports no JAX).

Functional equivalent of the tokenizer in the pinned openai/CLIP dep (reference
environment.yml:22) used for zero-shot text goals (readme_files/zeroshot_objectnav.md).
Byte-level BPE over a merges table: pass the official
`bpe_simple_vocab_16e6.txt(.gz)` path to reproduce OpenAI token ids exactly; without a
merges file the tokenizer degrades to byte-level (functional, different ids).
`tokenize` returns int32 numpy ids, as the JAX package's does; the text tower takes
them as they are.

Deviation noted: openai/CLIP runs ftfy.fix_text (mojibake repair) in basic_clean; ftfy
isn't in this environment, so we apply html.unescape twice + strip, which matches on
well-formed input.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SimpleTokenizer", "tokenize"]


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 byte↔unicode table: maps every byte to a printable unicode char."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# \p{L} → [^\W\d_], \p{N} → \d, [^\s\p{L}\p{N}] → (?:[^\s\w]|_) in python `re`.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


class SimpleTokenizer:
    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[Sequence[Tuple[str, str]]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if bpe_path is not None:
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # Official file: header line, then merges; openai slices [1:49152-256-2+1].
            merge_lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(l.split()) for l in merge_lines if l.strip()]
        merges = list(merges or [])

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(_PAT, text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


def tokenize(texts, tokenizer: SimpleTokenizer, context_length: int = 77,
             truncate: bool = False) -> np.ndarray:
    """Texts → (N, context_length) int32 with <sot> ... <eot> padding-zero layout,
    matching openai/CLIP `tokenize` semantics."""
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tokenizer.sot_token] + tokenizer.encode(text) + [tokenizer.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tokenizer.eot_token
        result[i, : len(ids)] = ids
    return result
