"""Port parity of the host layers: the port keeps its own copies of the
reference's pure-Python tokenizer, preprocessor, chunker, prompt helpers and
stop-sequence rule.  The same transcript and text through both give equal
results, compared exactly (the copies run the same arithmetic)."""

import copy

import pytest

from lmrs_tpu import prompts as jprompts
from lmrs_tpu.data import chunker as jchunker
from lmrs_tpu.data import preprocessor as jpre
from lmrs_tpu.data import tokenizer as jtok
from lmrs_tpu.engine import api as japi
from lmrs_tpu_torch import prompts as tprompts
from lmrs_tpu_torch.data import chunker as tchunker
from lmrs_tpu_torch.data import preprocessor as tpre
from lmrs_tpu_torch.data import tokenizer as ttok
from lmrs_tpu_torch.engine import api as tapi

from conftest import make_segments

TEXTS = ["", "hello world", "naïve café, 日本語 {transcript} {x}", "a b " * 150,
         "  spaces\tand\nnewlines  [00:12] Speaker 1: ok."]


@pytest.mark.parametrize("name", ["byte", "approx"])
def test_tokenizer_matches_reference(name):
    jt, tt = jtok.get_tokenizer(name), ttok.get_tokenizer(name)
    for text in TEXTS:
        assert tt.count(text) == jt.count(text)
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    if name == "byte":
        assert (tt.pad_id, tt.eos_id, tt.vocab_size) == (0, 2, 259)
        assert (tt.bos_id, tt.eos_id, tt.vocab_size) == (jt.bos_id, jt.eos_id,
                                                         jt.vocab_size)


@pytest.mark.parametrize("merge,interval,tokenizer", [
    (True, None, "byte"), (False, 60.0, "approx")])
def test_preprocess_and_chunk_match_reference(merge, interval, tokenizer):
    segs = make_segments(120, n_speakers=3, seed=5)
    kw = dict(merge_same_speaker=merge, time_interval_seconds=interval,
              max_segment_duration=90.0)
    jp = jpre.preprocess_transcript(copy.deepcopy(segs), **kw)
    tp = tpre.preprocess_transcript(copy.deepcopy(segs), **kw)
    assert tp == jp
    assert tpre.extract_speakers(tp) == jpre.extract_speakers(jp)
    assert tpre.get_transcript_duration(tp) == jpre.get_transcript_duration(jp)
    ck = dict(max_tokens_per_chunk=400, overlap_tokens=50, context_tokens=60,
              tokenizer=tokenizer)
    jc = jchunker.TranscriptChunker(**ck).chunk_transcript(jp)
    tc = tchunker.TranscriptChunker(**ck).chunk_transcript(tp)
    fields = ("chunk_index", "total_chunks", "text", "text_with_context",
              "token_count", "start_time", "end_time", "speakers",
              "position_percentage")
    assert len(tc) == len(jc) > 3
    for t, j in zip(tc, jc):
        assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]


def test_prompts_match_reference(tmp_path):
    assert tprompts.list_builtin_prompts() == jprompts.list_builtin_prompts()
    for name in tprompts.list_builtin_prompts():
        assert tprompts.builtin_prompt(name) == jprompts.builtin_prompt(name)
    no_placeholder = tmp_path / "p.txt"
    no_placeholder.write_text("Summarize this.", encoding="utf-8")
    for args in [(None, None), ("T {transcript}", None), (None, str(no_placeholder))]:
        assert tprompts.resolve_map_prompt(*args) == jprompts.resolve_map_prompt(*args)
        assert (tprompts.resolve_system_prompt(*args)
                == jprompts.resolve_system_prompt(*args))
        assert (tprompts.resolve_reduce_prompt(*args)
                == jprompts.resolve_reduce_prompt(*args))
    template = "{transcript} | {summary_type} | {other} | {}"
    kw = dict(transcript="a {summary_type} b", summary_type="notes")
    assert tprompts.safe_format(template, **kw) == jprompts.safe_format(template, **kw)


@pytest.mark.parametrize("stops", [(), ("",), ("b",), ("zz", "cd", "bc"), ("x",)])
def test_stop_sequences_match_reference(stops):
    text = "abcdbcd"
    assert tapi.apply_stop_sequences(text, stops) == japi.apply_stop_sequences(text, stops)


def test_prefix_hints_match_reference():
    """``shared_prefix_chars`` on the default map / reduce templates and
    ``preamble_text`` / ``preamble_key`` for every hint kind."""
    for template, varying, const in [
            (tprompts.DEFAULT_MAP_PROMPT, ("transcript",), {"summary_type": "notes"}),
            (tprompts.DEFAULT_REDUCE_PROMPT, ("summaries", "metadata", "num_summaries"), {}),
            ("no placeholder", ("transcript",), {})]:
        assert (tprompts.shared_prefix_chars(template, *varying, **const)
                == jprompts.shared_prefix_chars(template, *varying, **const))
    for system in (None, "Be brief."):
        for hint in (None, 0, 5, -1):
            args = (system, "shared head | body", hint)
            assert tapi.preamble_text(*args) == japi.preamble_text(*args)
            assert tapi.preamble_key(*args) == japi.preamble_key(*args)


def test_prefix_cache_matches_reference():
    """One sequence of insert, match (full, partial -> split, miss), budget
    trimming and LRU eviction against the reference's PrefixCache on its
    own allocator: every return value, the retained pages, the stats and
    the refcounts agree, and both audits stay clean."""
    from lmrs_tpu.engine.kv_cache import PageAllocator as JAlloc
    from lmrs_tpu.engine.prefix_cache import PrefixCache as JCache
    from lmrs_tpu_torch.engine.kv_cache import PageAllocator as TAlloc
    from lmrs_tpu_torch.engine.prefix_cache import PrefixCache as TCache

    ps, n_pages = 4, 40
    ja, ta = JAlloc(n_pages), TAlloc(n_pages)
    jc, tc = JCache(ja, ps, max_pages=9), TCache(ta, ps, max_pages=9)
    a = list(range(100, 118))                      # 18 tokens: 4 full pages
    b = a[:8] + list(range(200, 210))              # shares 2 pages with a
    c = list(range(300, 313))
    log = []

    def both(fn):
        out = (fn(jc, ja), fn(tc, ta))
        log.append(out)
        assert out[0] == out[1], (len(log), out)
        return out[1]

    def seq(ids):  # a live sequence: pages for every token
        pj = ja.alloc(-(-len(ids) // ps))
        pt = ta.alloc(len(pj))
        assert pj == pt
        return pt

    pa, pb, pc = seq(a), seq(b), seq(c)
    both(lambda cache, _: cache.insert(a, pa))                   # 4 pages
    both(lambda cache, _: cache.match(a + [1]))                  # full hit
    both(lambda cache, _: cache.match(b))                        # split at 8
    both(lambda cache, _: cache.insert(b, pb))                   # 2 new pages
    both(lambda cache, _: cache.insert(c, pc, max_tokens=5))     # cap: 2 pages
    both(lambda cache, _: cache.match([7, 7, 7, 7, 7]))          # miss
    tail = seq([0])
    both(lambda cache, _: cache.insert(b + [9] * 6, pb + tail))  # budget trim
    for pages in (pa, pb, pc, tail):  # sequences close: nodes evictable
        ja.free(pages)
        ta.free(pages)
    both(lambda cache, _: cache.evict(3))
    both(lambda cache, _: sorted(cache.retained_pages()))
    both(lambda cache, _: cache.stats())
    both(lambda cache, alloc: [alloc.refcount(p) for p in range(n_pages)])
    both(lambda cache, _: cache.audit())
    assert tc.audit() == [] and tc.cached_pages > 0
    both(lambda cache, _: cache.clear())
    both(lambda cache, alloc: (cache.cached_pages, alloc.free_count))
