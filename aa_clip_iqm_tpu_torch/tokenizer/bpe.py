"""CLIP byte-level BPE tokenizer (pure Python, no torch / no ftfy required).

Token-for-token parity with the reference tokenizer (model/tokenizer.py:74-186)
on the prompt ensembles used by the framework: same vocab
(bpe_simple_vocab_16e6.txt.gz, the public OpenAI artifact, vendored here as
data), same merge table slice, same regex, same SOT/EOT framing and 77-token
zero padding.

``ftfy.fix_text`` in the reference's ``basic_clean`` is text repair; it is the
identity on the ASCII prompt sentences this framework generates (property
pinned in tests/test_tokenizer.py). We use ftfy when installed; the fallback
transcribes the fix_text transforms that matter for prompt-like inputs —
fullwidth->ASCII width folding, Latin ligature expansion, quote uncurling and
NFC normalization (ftfy's fix_character_width / fix_latin_ligatures /
uncurl_quotes / normalization="NFC" defaults) — so pasted class names with
curly apostrophes or fullwidth text tokenize identically either way. NOT
transcribed (documented divergence, pinned by test): mojibake repair
(fix_encoding) and the rarer fixers (terminal escapes, surrogates, C1
controls); genuinely corrupted non-ASCII input needs real ftfy.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import List, Union

import numpy as np
import regex as re

# ftfy uncurl_quotes + fix_latin_ligatures, transcribed
# (ftfy/fixes.py: UNCURL_QUOTES_RE and LIGATURES).
_UNCURL = {0x2018: "'", 0x2019: "'", 0x201C: '"', 0x201D: '"'}
_LIGATURES = {0x0132: "IJ", 0x0133: "ij", 0xFB00: "ff", 0xFB01: "fi",
              0xFB02: "fl", 0xFB03: "ffi", 0xFB04: "ffl", 0xFB05: "st",
              0xFB06: "st"}
# fix_character_width for the fullwidth-ASCII block + ideographic space
# (the prompt-relevant subset of ftfy's W/F width folding).
_WIDTH = {0x3000: " ", **{c: chr(c - 0xFEE0) for c in range(0xFF01, 0xFF5F)}}
_FALLBACK_TABLE = {**_WIDTH, **_LIGATURES, **_UNCURL}

def _fallback_fix_text(t: str) -> str:
    """The transcribed fix_text subset (module docstring); always defined so
    tests pin it against the transcription whether or not ftfy exists."""
    return unicodedata.normalize("NFC", t.translate(_FALLBACK_TABLE))


try:  # optional; the fallback transcribes the prompt-relevant subset
    import ftfy

    def _fix_text(t: str) -> str:
        return ftfy.fix_text(t)
except ImportError:  # pragma: no cover - environment dependent
    _fix_text = _fallback_fix_text


VOCAB_PATH = os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz")

_WORD_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)


@functools.lru_cache()
def byte_unicode_table():
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP scheme).

    Insertion order matters: the base vocabulary is enumerated in this
    order (printable byte ranges first, then remapped control bytes), and
    token ids depend on it.
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


def _clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.strip()


class ClipTokenizer:
    def __init__(self, vocab_path: str = VOCAB_PATH):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # identical slice to the reference (model/tokenizer.py:79):
        # drop header, keep 49152-256-2 merge rules
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        base = list(self.byte_encoder.values())
        vocab = base + [tok + "</w>" for tok in base]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache = {
            "<|startoftext|>": ["<|startoftext|>"],
            "<|endoftext|>": ["<|endoftext|>"],
        }
        self.pattern = re.compile(_WORD_PATTERN, re.IGNORECASE)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token[:-1]) + [token[-1] + "</w>"]
        if len(word) == 1:
            return word

        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged

        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pattern, _clean(text).lower()):
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(token_bytes))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """Tokenize into a (N, context_length) int32 array, SOT/EOT framed and
    zero-padded — parity with reference tokenize (model/tokenizer.py:150-186).
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot
        result[i, : len(ids)] = ids
    return result


#: SigLIP's end and pad id (its SentencePiece vocabulary's ``</s>``).
PAD_ID = 1


def tokenize_padded(texts: Union[str, List[str]], context_length: int,
                    vocab_size: int) -> np.ndarray:
    """A SigLIP tower's prompts as the port makes them: each text's BPE ids
    (no start or end token) modulo ``vocab_size``, then :data:`PAD_ID` as its
    end, truncated to ``context_length`` and padded there with it,
    (N, context_length) int32. SigLIP's own SentencePiece vocabulary is not
    in the repository: these ids stand in for its ids."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    result = np.full((len(texts), context_length), PAD_ID, dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [t % vocab_size for t in tok.encode(text)][:context_length - 1] + [PAD_ID]
        result[i, : len(ids)] = ids
    return result
