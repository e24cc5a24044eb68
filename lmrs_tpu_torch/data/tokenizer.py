"""Tokenization authority (pure-Python copy of the reference's tokenizers).

* ``ApproxTokenizer`` — deterministic ~4 chars/token counter.
* ``ByteTokenizer`` — reversible UTF-8 byte mapping (pad 0, bos 1, eos 2,
  byte b -> id b+3, vocab 259): the vocabulary of random-init models.
"""

from __future__ import annotations

import re
import zlib
from typing import Protocol, Sequence


class Tokenizer(Protocol):
    """Minimal surface every stage relies on."""

    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def count(self, text: str) -> int: ...


class ApproxTokenizer:
    """Heuristic counter: ~4 chars/token with a word-boundary floor."""

    bos_id = 1
    eos_id = 2
    pad_id = 0
    vocab_size = 32768

    _word_re = re.compile(r"\S+")

    def count(self, text: str) -> int:
        if not text:
            return 0
        return max(len(text) // 4, len(self._word_re.findall(text)) // 2, 1)

    def encode(self, text: str) -> list[int]:
        return [
            3 + (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 3))
            for w in self._word_re.findall(text)
        ]

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids)


class ByteTokenizer:
    """Reversible UTF-8 byte-level tokenizer."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [b + 3 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside [3, 258] (specials, or a vocabulary rounded up past
        # the byte range) are skipped
        return bytes(i - 3 for i in ids if 3 <= i <= 258).decode("utf-8", errors="replace")

    def count(self, text: str) -> int:
        return len(text.encode("utf-8"))


def get_tokenizer(name: str = "approx") -> Tokenizer:
    """Resolve a tokenizer spec: "approx" or "byte"."""
    if name == "approx":
        return ApproxTokenizer()
    if name == "byte":
        return ByteTokenizer()
    raise ValueError(f"tokenizer {name!r} is not ported; the port has "
                     "'approx' and 'byte' (checkpoint vocabularies arrive "
                     "with real weights)")
