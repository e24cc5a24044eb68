"""The port's native host runtime (``lmrs_tpu_torch/runtime/native.py``,
C++ in ``lmrs_tpu_torch/csrc/lmrs_runtime.cc``) against the JAX package's
and against the port's own Python versions: text cleaning, approximate
counts, and the KV page allocator on seeded op scripts.  The library is
built with ``g++`` once per process; a failed build is a failure here, and
with ``LMRS_NATIVE`` on it raises instead of degrading."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lmrs_tpu.data.preprocessor import clean_text_py as j_clean_py
from lmrs_tpu.data.tokenizer import ApproxTokenizer as JApprox
from lmrs_tpu.engine.kv_cache import PageAllocator as JAlloc
from lmrs_tpu.runtime import native as jnative

from lmrs_tpu_torch.data import preprocessor as tpre
from lmrs_tpu_torch.data.tokenizer import ApproxTokenizer as TApprox
from lmrs_tpu_torch.engine.kv_cache import (OutOfPages, PageAllocator,
                                            PagedKVCache, make_page_allocator)
from lmrs_tpu_torch.runtime import native
from lmrs_tpu_torch.testing.alloc_script import make_script, replay
from lmrs_tpu_torch.utils.demo import load_demo_transcript

REPO = Path(__file__).resolve().parents[1]

# the reference's clean cases (tests/test_native.py), unicode ones included
CASES = [
    "", "   ", "hello world", "  hello   world  ", "the the the end",
    "The the plan", "word word, word", "end.Next sentence",
    "a,b then x;Y plus q:r", "tabs\tand\nnewlines\r\nhere",
    "one two  three   four", "Dr. Smith said hello.Goodbye",
    "numbers 12 12 stay? no: 12", "Hello!World again?Yes",
    "foofoo foo foofoo", "a a a a a a", "trailing space dedup dedup ",
    "mixed CASE case Case words", "punct.[bracket]",
    "unicode café café test", "nbsp space here", "wide　space",
    "emoji \U0001f600 \U0001f600 twice", "Straße straße", "Привет привет мир",
]


def random_ascii(seed: int, n: int) -> list[str]:
    """Seeded strings over letters, digits, the punctuation the cleaner
    rewrites and every ASCII whitespace, with repeated words."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcAB xyzXYZ019_ .!?,;:\t\n\r\x0b\x0c-'[]")
    words = ["the", "The", "THE", "a", "end.", "Next", "x", "foo", "foofoo"]
    out = []
    for _ in range(n):
        if rng.random() < 0.5:
            out.append("".join(rng.choice(alphabet, rng.integers(0, 120))))
        else:
            out.append(" ".join(rng.choice(words, rng.integers(0, 12))))
    return out


@pytest.fixture(scope="module")
def texts() -> list[str]:
    demo = [s.get("text") or "" for s in load_demo_transcript()["segments"]]
    return CASES + random_ascii(0, 400) + demo


def test_clean_text_matches_the_jax_package_and_the_python_version(texts):
    want = [j_clean_py(t) for t in texts]
    assert [jnative.clean_text_native(t) for t in texts] == want
    assert [native.clean_text_native(t) for t in texts] == want
    assert [tpre.clean_text_py(t) for t in texts] == want
    assert [tpre.clean_text(t) for t in texts] == want
    assert native.clean_text_batch(texts) == want
    assert jnative.clean_text_batch(texts) == want


def test_clean_all_turns_null_segments_into_empty_strings(texts):
    mixed = [None, 5, *texts[:50], None]
    want = ["", ""] + [j_clean_py(t) for t in texts[:50]] + [""]
    assert tpre._clean_all(mixed) == want
    assert native.clean_text_batch([]) == []


def test_counts_match_the_jax_package(texts):
    j, t = JApprox(), TApprox()
    want = [j.count_py(x) for x in texts]
    assert [t.count_py(x) for x in texts] == want
    assert [t.count(x) for x in texts] == want
    assert t.count_batch(texts) == want
    assert native.count_approx_batch(texts) == want
    assert jnative.count_approx_batch(texts) == want
    assert [native.count_approx_native(x) for x in texts] == want
    assert t.count_batch([]) == []


def test_python_versions_run_under_native_off(monkeypatch, texts):
    """``LMRS_NATIVE=0`` selects the Python cleaner and counter by name,
    with the same outputs."""
    monkeypatch.setenv("LMRS_NATIVE", "0")
    monkeypatch.setattr(native, "load", lambda: pytest.fail("loaded"))
    assert [tpre.clean_text(t) for t in texts] == [j_clean_py(t) for t in texts]
    assert TApprox().count_batch(texts) == [JApprox().count_py(t) for t in texts]


def _allocators(num_pages: int) -> dict:
    return {"jax-python": JAlloc(num_pages),
            "jax-native": jnative.NativePageAllocator(num_pages),
            "port-python": PageAllocator(num_pages),
            "port-native": native.NativePageAllocator(num_pages)}


@pytest.mark.parametrize("seed,num_pages", [(0, 112), (1, 9), (2, 2)])
def test_allocators_agree_on_a_seeded_op_script(seed, num_pages):
    """One script through four allocators: the same pages in the same
    order, the same refusals (``OutOfPages``, ``ValueError`` on a double
    free, an incref of a free page, page 0, an id past the pool), then the
    same free count and refcounts."""
    script, outcomes = make_script(seed, 3000, num_pages)
    kinds = {o for o in outcomes if isinstance(o, str)}
    assert kinds == {"OutOfPages", "ValueError"}
    ref = JAlloc(num_pages)
    replay(ref, script)
    want = (ref.free_count, [ref.refcount(p) for p in range(num_pages)])
    for name, alloc in _allocators(num_pages).items():
        assert replay(alloc, script) == outcomes, name
        got = (alloc.free_count, [alloc.refcount(p) for p in range(num_pages)])
        assert got == want, name


def test_native_allocator_refuses_before_any_change():
    a = native.NativePageAllocator(6)
    pages = a.alloc(3)
    assert pages == [1, 2, 3] and a.free_count == 2
    for bad in ([0], [6], [-1], [pages[0], pages[0]], [4]):
        with pytest.raises(ValueError):
            a.free(bad)
        assert a.free_count == 2 and [a.refcount(p) for p in pages] == [1] * 3
    with pytest.raises(ValueError):
        a.incref([5])
    with pytest.raises(OutOfPages):
        a.alloc(3)
    a.incref([pages[1]])
    a.free(pages)
    assert a.free_count == 4 and a.refcount(pages[1]) == 1
    assert a.alloc(2) == [3, 1]  # LIFO: the last freed first
    assert a.RESERVED == 1 and a.refcount(0) == 0
    with pytest.raises(ValueError):
        a.refcount(6)
    with pytest.raises(ValueError):
        native.NativePageAllocator(1)


def test_native_allocator_conserves_pages_under_threads():
    """Eight threads churn one allocator (each call holds its mutex and
    releases the GIL): no page is handed out twice and every page comes
    back."""
    import sys
    import threading

    a = native.NativePageAllocator(64)
    seen_twice: list[int] = []
    held: set[int] = set()
    guard = threading.Lock()

    def churn(seed: int) -> None:
        rng = np.random.default_rng(seed)
        for _ in range(2000):
            try:
                pages = a.alloc(int(rng.integers(1, 4)))
            except OutOfPages:
                continue
            with guard:
                seen_twice.extend(p for p in pages if p in held)
                held.update(pages)
            a.incref(pages)
            a.free(pages)
            with guard:
                held.difference_update(pages)
            a.free(pages)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert seen_twice == []
    assert a.free_count == 63 and not any(a.refcount(p) for p in range(64))


def test_paged_kv_cache_picks_the_allocator_by_switch(monkeypatch):
    import torch

    from lmrs_tpu_torch.config import ModelConfig

    cfg = ModelConfig(name="t", vocab_size=64, dim=32, n_layers=1,
                      n_heads=2, n_kv_heads=1, hidden_dim=64,
                      max_seq_len=64)
    args = (cfg, 8, 16, 4, "cpu", torch.float32)
    assert type(PagedKVCache(*args).allocator) is native.NativePageAllocator
    assert type(make_page_allocator(4)) is native.NativePageAllocator
    monkeypatch.setenv("LMRS_NATIVE", "0")
    assert type(PagedKVCache(*args).allocator) is PageAllocator
    mine = PageAllocator(8)
    assert PagedKVCache(*args, allocator=mine).allocator is mine


def test_failed_build_raises_and_nothing_degrades(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(native.NativeBuildError, match="build failed"):
        native.build()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError):
        tpre.clean_text("the the end")
    with pytest.raises(native.NativeBuildError):
        TApprox().count_batch(["a b"])
    with pytest.raises(native.NativeBuildError):
        make_page_allocator(4)
    monkeypatch.setenv("LMRS_NATIVE", "0")
    assert tpre.clean_text("the the end") == "the end"
    assert type(make_page_allocator(4)) is PageAllocator


def test_runtime_source_and_library_are_the_ports_own():
    """The port builds ``lmrs_tpu_torch/csrc/lmrs_runtime.cc`` into
    ``build/lmrs_tpu_torch`` and loads that library, never anything under
    ``native/`` (the JAX package's build)."""
    assert native.SRC == REPO / "lmrs_tpu_torch" / "csrc" / "lmrs_runtime.cc"
    assert native.lib_path().parent == REPO / "build" / "lmrs_tpu_torch"
    code = (
        "from lmrs_tpu_torch.data.preprocessor import _clean_all\n"
        "from lmrs_tpu_torch.data.tokenizer import ApproxTokenizer\n"
        "from lmrs_tpu_torch.engine.kv_cache import make_page_allocator\n"
        "from lmrs_tpu_torch.runtime import native\n"
        "assert _clean_all(['a  a b']) == ['a b']\n"
        "assert ApproxTokenizer().count_batch(['a b c d']) == [2]\n"
        "assert make_page_allocator(4).alloc(2) == [1, 2]\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native.lib_path()) in maps\n"
        "assert 'liblmrs_runtime.so' not in maps, maps\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
