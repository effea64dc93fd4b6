"""CLIP byte-pair-encoding tokenizer (the port's own numpy-only copy of
``panacea_tpu/data/tokenizer.py``).

Equivalent of ``open_clip.tokenize`` used by the reference text embedder
(sgm/modules/encoders/modules.py:559-632): lowercase + whitespace-clean, byte
to unicode mapping, greedy BPE merges, 77-token context with start/end tokens,
truncation keeps the end token.

The merge table (``bpe_simple_vocab_16e6.txt.gz``) ships with open_clip and is
not redistributable from this offline build; pass its path explicitly or via
``PANACEA_CLIP_BPE``. Without it a deterministic hash fallback produces stable
(but meaningless) token ids — fine for shape/integration tests, NOT for real
text conditioning.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2 scheme)."""
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


def get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE; mirrors the open_clip tokenizer behavior."""

    try:
        import regex as _regex

        PAT = _regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            _regex.IGNORECASE,
        )
    except ImportError:  # pragma: no cover - regex is present in this image
        PAT = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("PANACEA_CLIP_BPE")
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
            merges = merges[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merges]
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            for m in merges:
                vocab.append("".join(m))
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = dict(zip(vocab, range(len(vocab))))
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            self.real_vocab = True
        else:
            self.encoder = {}
            self.bpe_ranks = {}
            self.real_vocab = False
        self.sot = VOCAB_SIZE - 2
        self.eot = VOCAB_SIZE - 1
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

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
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
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

    def encode(self, text: str) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        if not self.real_vocab:
            # deterministic fallback: stable FNV-1a per word, mapped into the
            # non-special id range — structure-preserving for tests only
            ids = []
            for tok in re.findall(r"\S+", text):
                h = 2166136261
                for ch in tok.encode("utf-8"):
                    h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
                ids.append(h % (VOCAB_SIZE - 2))
            return ids
        bpe_tokens: List[int] = []
        for token in re.findall(self.PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def __call__(self, texts: Sequence[str],
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to (B, context_length) int32 with SOT/EOT, zero padding,
        truncation keeping EOT (open_clip semantics)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot
            result[i, : len(tokens)] = tokens
        return result


def has_real_vocab() -> bool:
    """True when the BPE merge table is found (real CLIP token ids). False
    means the hash fallback is active: stable ids for shape tests, garbage for
    real text conditioning — callers doing real inference must refuse it."""
    return SimpleTokenizer().real_vocab
