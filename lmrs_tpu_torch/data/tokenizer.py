"""Tokenization authority (a copy of the reference's tokenizers).

* ``ApproxTokenizer`` — deterministic ~4 chars/token counter (the native
  runtime's count unless ``LMRS_NATIVE=0``).
* ``ByteTokenizer`` — reversible UTF-8 byte mapping (pad 0, bos 1, eos 2,
  byte b -> id b+3, vocab 259): the vocabulary of random-init models.
* ``HFTokenizer`` — a checkpoint's local ``tokenizer.json`` through the
  ``tokenizers`` package (the reference wraps ``transformers``; this keeps
  its ids, specials and decode rules, see the class).
* ``SentencePieceTokenizer`` — a local ``*.model`` file through
  ``sentencepiece``.

Either package is imported by the constructor that needs it; a missing
package raises ``ImportError`` naming it (no fallback to approx or byte).
"""

from __future__ import annotations

import json
import re
import zlib
from pathlib import Path
from typing import Protocol, Sequence

from lmrs_tpu_torch.runtime import native


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

    def count_py(self, text: str) -> int:
        """The Python counter: the plain version of the native count."""
        if not text:
            return 0
        return max(len(text) // 4, len(self._word_re.findall(text)) // 2, 1)

    def count(self, text: str) -> int:
        if not text:
            return 0
        if native.enabled():
            return native.count_approx_native(text)
        return self.count_py(text)

    def count_batch(self, texts: list[str]) -> list[int]:
        """Counts of many strings: one native call (the chunker's hot
        loop), or the Python counter under ``LMRS_NATIVE=0``."""
        if native.enabled():
            return native.count_approx_batch(texts)
        return [self.count_py(t) for t in texts]

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


class SentencePieceTokenizer:
    """Adapter over a local ``.model`` SentencePiece file (Gemma/Llama-2)."""

    def __init__(self, model_path: str):
        try:
            import sentencepiece as spm
        except ImportError as e:
            raise ImportError(
                f"tokenizer {model_path!r} needs the 'sentencepiece' package, "
                "which is not installed") from e
        self._sp = spm.SentencePieceProcessor(model_file=model_path)
        self.bos_id = self._sp.bos_id()
        self.eos_id = self._sp.eos_id()
        self.pad_id = max(self._sp.pad_id(), 0)
        self.vocab_size = self._sp.vocab_size()

    def encode(self, text: str) -> list[int]:
        return list(self._sp.encode(text))

    def decode(self, ids: Sequence[int]) -> str:
        return self._sp.decode(list(ids))

    def count(self, text: str) -> int:
        return len(self.encode(text))


# the special-token attributes of a transformers tokenizer config
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


def _content(tok) -> str | None:
    """A special token as a config writes it: a string or an AddedToken
    dict (``{"content": ...}``)."""
    return tok.get("content") if isinstance(tok, dict) else tok


class HFTokenizer:
    """Adapter over a local HuggingFace tokenizer directory (Llama-3 BPE,
    Mixtral, Gemma): ``tokenizer.json`` through the ``tokenizers`` package,
    the special tokens from ``tokenizer_config.json`` (and, for a config
    without ``added_tokens_decoder``, ``special_tokens_map.json`` over it),
    read here as ``transformers.PreTrainedTokenizerFast`` reads them: the
    config's added tokens and special tokens missing from the vocabulary
    are added as special tokens.  Then, as the reference's adapter:
    ``bos_id = bos or 1``, ``eos_id = eos or 2``, ``pad_id = pad or 0``
    (an id of 0 counts as missing), ``vocab_size`` counts the added tokens,
    ``encode`` adds no special tokens, ``decode`` skips them and cleans up
    tokenization spaces when the config asks for it."""

    def __init__(self, path: str):
        try:
            from tokenizers import AddedToken, Tokenizer
        except ImportError as e:
            raise ImportError(
                f"tokenizer {path!r} needs the 'tokenizers' package, which "
                "is not installed") from e
        root = Path(path)
        file = root / "tokenizer.json" if root.is_dir() else root
        if not file.is_file():
            raise FileNotFoundError(
                f"tokenizer {path!r}: no tokenizer.json there (the port "
                "reads local tokenizer directories only)")
        self._tok = Tokenizer.from_file(str(file))
        conf = self._json(file.parent / "tokenizer_config.json")
        if "added_tokens_decoder" not in conf:
            conf.update(self._json(file.parent / "special_tokens_map.json"))
        specials = [_content(conf.get(k)) for k in _SPECIAL_KEYS]
        specials += [_content(t) for t in conf.get("additional_special_tokens") or []]
        added = {t.content for t in self._tok.get_added_tokens_decoder().values()}
        new = []
        for _, t in sorted(conf.get("added_tokens_decoder", {}).items(),
                           key=lambda kv: int(kv[0])):
            c = t["content"]
            if c not in added:
                new.append(AddedToken(
                    c, single_word=t.get("single_word", False),
                    lstrip=t.get("lstrip", False), rstrip=t.get("rstrip", False),
                    normalized=t.get("normalized", True),
                    special=bool(t.get("special")) or c in specials))
                added.add(c)
        for c in specials:
            if c is not None and c not in added:
                new.append(AddedToken(c, special=True))
                added.add(c)
        if new:
            self._tok.add_tokens(new)
        self._clean = bool(conf.get("clean_up_tokenization_spaces", False))

        def token_id(key):
            c = _content(conf.get(key))
            return None if c is None else self._tok.token_to_id(c)

        self.bos_id = token_id("bos_token") or 1
        self.eos_id = token_id("eos_token") or 2
        self.pad_id = token_id("pad_token") or 0
        self.vocab_size = self._tok.get_vocab_size(with_added_tokens=True)

    @staticmethod
    def _json(path: Path) -> dict:
        return json.loads(path.read_text(encoding="utf-8")) if path.is_file() else {}

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode(list(ids), skip_special_tokens=True)
        if self._clean:  # transformers' clean_up_tokenization
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                         (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                         (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                text = text.replace(a, b)
        return text

    def count(self, text: str) -> int:
        return len(self.encode(text))


def get_tokenizer(name: str = "approx") -> Tokenizer:
    """Resolve a tokenizer spec: "approx", "byte", a ``*.model``
    SentencePiece path, or a local HF tokenizer directory."""
    if name == "approx":
        return ApproxTokenizer()
    if name == "byte":
        return ByteTokenizer()
    if name.endswith(".model"):
        return SentencePieceTokenizer(name)
    return HFTokenizer(name)
