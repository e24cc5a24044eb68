"""Port parity, tokenizers: the port's ``HFTokenizer`` (``tokenizer.json``
through the ``tokenizers`` package, special tokens read by hand) against
the JAX package's (``transformers.AutoTokenizer``) on a BPE tokenizer
trained here on the synthetic corpus, as ``tests/test_hf_tokenizer.py``
trains it, in three config layouts:

* ``plain``: ``tokenizer_config.json`` names the four specials as strings;
* ``added``: a current config (``added_tokens_decoder``) with a mask token
  missing from the vocabulary (added, so the vocabulary grows), no pad
  token (the pad id falls back to 0) and ``clean_up_tokenization_spaces``;
* ``legacy``: a config without ``added_tokens_decoder`` whose
  ``special_tokens_map.json`` overrides the eos token with an AddedToken
  dict.

Exact agreement is required: ids and counts of every corpus text, decoded
texts of every corpus text and of id runs with specials among them, and
``bos_id``/``eos_id``/``pad_id``/``vocab_size``.  Then ``get_tokenizer``'s
resolution, and the refusals: without the ``tokenizers`` (or
``sentencepiece``) package, construction raises ``ImportError`` naming it."""

import json
import sys

import pytest

pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

from lmrs_tpu.data import tokenizer as jtok  # noqa: E402
from lmrs_tpu_torch.data import tokenizer as ttok  # noqa: E402

from conftest import make_segments  # noqa: E402

CORPUS = [s["text"] for s in make_segments(400, seed=7)]


@pytest.fixture(scope="module")
def tok_json(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<pad>", "<s>", "</s>", "<unk>"]))
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path.read_text()


def _special(content, special=True):
    return {"content": content, "lstrip": False, "normalized": False,
            "rstrip": False, "single_word": False, "special": special}


LAYOUTS = {
    "plain": ({"tokenizer_class": "PreTrainedTokenizerFast",
               "bos_token": "<s>", "eos_token": "</s>",
               "pad_token": "<pad>", "unk_token": "<unk>"}, None),
    "added": ({"tokenizer_class": "PreTrainedTokenizerFast",
               "added_tokens_decoder": {"0": _special("<pad>"),
                                        "1": _special("<s>"),
                                        "2": _special("</s>"),
                                        "3": _special("<unk>")},
               "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
               "mask_token": "<mask>",
               "clean_up_tokenization_spaces": True}, None),
    "legacy": ({"tokenizer_class": "PreTrainedTokenizerFast",
                "bos_token": "<s>", "eos_token": "<unk>",
                "pad_token": "<pad>", "unk_token": "<unk>"},
               {"eos_token": {"content": "</s>", "lstrip": False,
                              "normalized": False, "rstrip": False,
                              "single_word": False}}),
}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def tok_dir(request, tok_json, tmp_path_factory):
    config, special_map = LAYOUTS[request.param]
    d = tmp_path_factory.mktemp(f"hf_{request.param}")
    (d / "tokenizer.json").write_text(tok_json)
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    if special_map is not None:
        (d / "special_tokens_map.json").write_text(json.dumps(special_map))
    return request.param, str(d)


def test_hf_tokenizer_matches_reference(tok_dir):
    layout, d = tok_dir
    want, got = jtok.HFTokenizer(d), ttok.HFTokenizer(d)
    assert (got.bos_id, got.eos_id, got.pad_id, got.vocab_size) == \
        (want.bos_id, want.eos_id, want.pad_id, want.vocab_size)
    if layout == "added":  # <mask> joined the vocabulary; no pad token
        from tokenizers import Tokenizer

        base = Tokenizer.from_file(d + "/tokenizer.json").get_vocab_size()
        assert got.vocab_size == base + 1 and got.pad_id == 0
    if layout == "legacy":  # special_tokens_map.json won over the config
        assert got.eos_id == 2
    specials = [got.bos_id, got.eos_id, got.vocab_size - 1]
    for i, text in enumerate(CORPUS):
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.count(text) == want.count(text) == len(ids)
        assert got.decode(ids) == want.decode(ids), text
        mixed = ids[:5] + [specials[i % 3]] + ids[5:]
        assert got.decode(mixed) == want.decode(mixed), text
    punct = "well , it 's done . is n't it ? yes !"
    ids = got.encode(punct)
    assert got.decode(ids) == want.decode(ids)


def test_get_tokenizer_resolution(tok_dir, tmp_path):
    _, d = tok_dir
    assert isinstance(ttok.get_tokenizer(d), ttok.HFTokenizer)
    assert isinstance(ttok.get_tokenizer(d + "/tokenizer.json"), ttok.HFTokenizer)
    assert isinstance(ttok.get_tokenizer("byte"), ttok.ByteTokenizer)
    assert isinstance(ttok.get_tokenizer("approx"), ttok.ApproxTokenizer)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        ttok.get_tokenizer(str(tmp_path / "no-such-dir"))


def test_missing_tokenizers_package_raises_by_name(tok_dir, monkeypatch):
    _, d = tok_dir
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError, match="'tokenizers' package"):
        ttok.get_tokenizer(d)


def test_sentencepiece_branch_raises_by_name(monkeypatch):
    """A ``*.model`` path resolves to the SentencePiece adapter, which
    names its package when it is absent."""
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    with pytest.raises(ImportError, match="'sentencepiece' package"):
        ttok.get_tokenizer("/nonexistent/vocab.model")
