"""CLIP's byte-level BPE tokenizer, written out plainly for the reference.

OpenAI's ``simple_tokenizer`` (the vocabulary beside this file is its public
``bpe_simple_vocab_16e6.txt.gz``): lower-cased text, the CLIP word pattern,
byte-pair merges by rank, start and end tokens, zero padding to 77. The
prompt sentences are ASCII, so its text repair (``ftfy``) is the identity on
them and is left out.
"""
from __future__ import annotations

import functools
import gzip
import html
import os

import numpy as np
import regex

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")
PATTERN = regex.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    regex.IGNORECASE)


def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@functools.lru_cache()
def _tables():
    with gzip.open(VOCAB, "rt", encoding="utf-8") as f:
        merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
    merges = [tuple(m.split()) for m in merges]
    byte_enc = _bytes_to_unicode()
    vocab = list(byte_enc.values())
    vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return byte_enc, {v: i for i, v in enumerate(vocab)}, {m: i for i, m in enumerate(merges)}


def _bpe(token: str, ranks) -> list:
    word = tuple(token[:-1]) + (token[-1] + "</w>",)
    while len(word) > 1:
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        first, second = min(pairs, key=lambda p: ranks.get(p, float("inf")))
        if (first, second) not in ranks:
            break
        out, i = [], 0
        while i < len(word):
            if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                out.append(first + second)
                i += 2
            else:
                out.append(word[i])
                i += 1
        word = tuple(out)
    return list(word)


def encode(text: str) -> list:
    byte_enc, encoder, ranks = _tables()
    text = " ".join(html.unescape(html.unescape(text)).split()).lower()
    ids = []
    for token in regex.findall(PATTERN, text):
        token = "".join(byte_enc[b] for b in token.encode("utf-8"))
        ids.extend(encoder[p] for p in _bpe(token, ranks))
    return ids


def tokenize(texts, context_length: int = 77) -> np.ndarray:
    """(N, context_length) int64: start token, the text's tokens, end token,
    zeros."""
    _, encoder, _ = _tables()
    out = np.zeros((len(texts), context_length), np.int64)
    for i, text in enumerate(texts):
        ids = [encoder["<|startoftext|>"]] + encode(text) + [encoder["<|endoftext|>"]]
        if len(ids) > context_length:
            raise ValueError(f"{text!r} is longer than {context_length} tokens")
        out[i, :len(ids)] = ids
    return out
