r"""CLIP BPE tokenizer of the port (counterpart of
``ctrlora_tpu/utils/tokenizer.py``, which the port cannot import: the JAX
package's ``__init__`` imports JAX).

Byte-level BPE with an end-of-word marker over the public OpenAI merges
table ``assets/bpe_simple_vocab_16e6.txt.gz``, numpy only. The pre-tokenizer
pattern uses ``regex``'s Unicode classes where that package is installed and
falls back to ``re``. The fallback splits letters, single digits and other
runs as the ``regex`` pattern does, so the two give the same ids on ASCII
text (the JAX module's ``\w+`` fallback keeps "8k" or "12" whole). Output: [B, windows * 77] int64 ids, SOT/EOT framed and EOT
padded (HF CLIPTokenizer padding='max_length').
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import List, Sequence

import numpy as np

try:
    import regex as re
except ImportError:  # the GPU host may lack regex
    import re  # type: ignore

DEFAULT_BPE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 style reversible byte <-> unicode mapping."""
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


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def basic_clean(text: str) -> str:
    # ftfy is unavailable offline; double html-unescape + NFC normalization
    # covers the practically-occurring cases (ftfy additionally repairs
    # mojibake, which clean prompt text doesn't contain)
    import unicodedata

    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text).strip()


class CLIPTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH, max_length: int = 77):
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT, EOT])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {SOT: SOT, EOT: EOT}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if re.__name__ == "regex"
            # letters, single digits, and runs of anything else but space:
            # the same classes as above on ASCII text
            else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:_|[^\s\w])+""",
            re.IGNORECASE,
        )
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

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
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(
        self, texts: str | Sequence[str], max_length: int | None = None, windows: int = 1
    ) -> np.ndarray:
        """Tokenize to [B, windows*max_length] int64 with SOT/EOT framing and
        EOT padding (HF CLIPTokenizer padding='max_length' semantics).

        windows > 1 implements the reference's 3x77 'clip hack'
        (cldm/hack.py:32-68): content is split across consecutive windows,
        each framed with SOT/EOT.
        """
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        body = L - 2
        out = np.full((len(texts), windows * L), self.eot_token, dtype=np.int64)
        for i, text in enumerate(texts):
            toks = self.encode(text)[: body * windows]
            for w in range(windows):
                chunk = toks[w * body : (w + 1) * body]
                row = [self.sot_token] + chunk + [self.eot_token]
                out[i, w * L : w * L + len(row)] = row
        return out


@functools.lru_cache()
def default_tokenizer() -> CLIPTokenizer:
    return CLIPTokenizer()
