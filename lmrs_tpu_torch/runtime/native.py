"""ctypes bindings for the port's native host runtime.

``lmrs_tpu_torch/csrc/lmrs_runtime.cc`` (the reference's C++ runtime,
copied whole: ABI 2) is compiled at first use with ``$CXX`` (default
``g++``) into ``build/lmrs_tpu_torch/liblmrs_runtime-<digest>.so``, named
by a digest of the source and the flags as ``ops/kernels`` names its CUDA
builds, written to a temporary path and renamed into place so a
concurrent process never loads half a file.

``LMRS_NATIVE`` (on by default) routes the port's text cleaning, its
approximate token counts and its KV page allocator through the library;
``LMRS_NATIVE=0`` selects the Python versions by name.  With the switch
on, a failed build, a failed load or an ABI mismatch raises
``NativeBuildError`` (the compiler's stderr in the message): nothing falls
back to Python on its own.

Exposed surface, each held against its Python version in the tests:

* ``clean_text_native`` / ``clean_text_batch`` — ``data/preprocessor``
* ``count_approx_native`` / ``count_approx_batch`` — ``ApproxTokenizer``
* ``NativePageAllocator`` — ``engine/kv_cache.PageAllocator``

The library is bound with ``ctypes.CDLL``, not ``PyDLL``: a call releases
the GIL, as the kernels' wrappers do.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from lmrs_tpu_torch.utils.env import env_bool

logger = logging.getLogger("lmrs_torch.native")

SRC = Path(__file__).resolve().parents[1] / "csrc" / "lmrs_runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmrs_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-fvisibility=hidden")
ABI_VERSION = 2  # v2: ref-counted allocator (incref/refcount entry points)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # guarded-by: _lock


class NativeBuildError(RuntimeError):
    """The native runtime could not be built or loaded with LMRS_NATIVE on."""


def enabled() -> bool:
    """``LMRS_NATIVE`` (default on), read on every call."""
    return env_bool("LMRS_NATIVE", True)


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblmrs_runtime-{digest}.so"


def build() -> Path:
    """The library's path, compiling it first unless it is up to date.
    Raises ``NativeBuildError`` with the compiler's stderr."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX") or "g++"
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"native runtime build failed "
                               f"({' '.join(cmd)}): {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native runtime build failed ({' '.join(cmd)}, exit "
            f"{r.returncode}); LMRS_NATIVE=0 selects the Python versions:\n"
            f"{r.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    logger.info("built native runtime: %s", out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    p32, p64, s = (ctypes.POINTER(i32), ctypes.POINTER(i64),
                   ctypes.c_char_p)
    sigs = {
        "lmrs_abi_version": (i32, []),
        "lmrs_clean_text": (i64, [s, i64, s, i64]),
        "lmrs_clean_text_batch": (i64, [s, p64, i64, s, i64, p64]),
        "lmrs_count_approx": (i64, [s, i64]),
        "lmrs_count_approx_batch": (None, [s, p64, i64, p64]),
        "lmrs_palloc_create": (ptr, [i32]),
        "lmrs_palloc_destroy": (None, [ptr]),
        "lmrs_palloc_free_count": (i32, [ptr]),
        "lmrs_palloc_alloc": (i32, [ptr, i32, p32]),
        "lmrs_palloc_free": (i32, [ptr, p32, i32]),
        "lmrs_palloc_incref": (i32, [ptr, p32, i32]),
        "lmrs_palloc_refcount": (i32, [ptr, i32]),
    }
    try:
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
    except AttributeError as e:
        raise NativeBuildError(f"native runtime lacks a symbol: {e}") from e
    abi = lib.lmrs_abi_version()
    if abi != ABI_VERSION:
        raise NativeBuildError(f"native runtime ABI {abi}, expected "
                               f"{ABI_VERSION}")
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built at first use (one build per process)."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise NativeBuildError(f"could not load {path}: {e}") from e
        return _lib


def _spans(raws: list[bytes]) -> tuple[bytes, np.ndarray]:
    """Concatenated strings and their n+1 offsets (the batch ABI)."""
    offsets = np.zeros(len(raws) + 1, np.int64)
    np.cumsum([len(r) for r in raws], out=offsets[1:])
    return b"".join(raws), offsets


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# ------------------------------------------------------------------- text


def clean_text_native(text: str) -> str:
    """``clean_text`` in C++.  Non-ASCII strings go to the Python cleaner:
    the regex ``\\w`` / ``IGNORECASE`` semantics are Unicode-aware and the
    C++ scan reproduces them exactly only for ASCII."""
    lib = load()
    if not text.isascii():
        from lmrs_tpu_torch.data.preprocessor import clean_text_py

        return clean_text_py(text)
    raw = text.encode("utf-8")
    cap = 2 * len(raw) + 16  # the output never exceeds 2n + 1 bytes
    buf = ctypes.create_string_buffer(cap)
    n = lib.lmrs_clean_text(raw, len(raw), buf, cap)
    if n < 0:  # too small after all: -n is the capacity it needs
        buf = ctypes.create_string_buffer(-n)
        n = lib.lmrs_clean_text(raw, len(raw), buf, -n)
    return buf.raw[:n].decode("utf-8")


def clean_text_batch(texts: list[str]) -> list[str]:
    """Clean a batch in one call; non-ASCII entries through the Python
    cleaner (see ``clean_text_native``)."""
    lib = load()
    if not all(t.isascii() for t in texts):
        from lmrs_tpu_torch.data.preprocessor import clean_text_py

        cleaned = iter(clean_text_batch([t for t in texts if t.isascii()]))
        return [next(cleaned) if t.isascii() else clean_text_py(t)
                for t in texts]
    if not texts:
        return []
    buf, offsets = _spans([t.encode("utf-8") for t in texts])
    cap = 2 * len(buf) + 16
    out = ctypes.create_string_buffer(cap)
    out_off = np.zeros(len(texts) + 1, np.int64)
    rc = lib.lmrs_clean_text_batch(buf, _p64(offsets), len(texts), out, cap,
                                   _p64(out_off))
    if rc < 0:  # too small after all: -rc is the capacity it needs
        out = ctypes.create_string_buffer(-rc)
        lib.lmrs_clean_text_batch(buf, _p64(offsets), len(texts), out, -rc,
                                  _p64(out_off))
    raw = out.raw
    return [raw[out_off[i]:out_off[i + 1]].decode("utf-8")
            for i in range(len(texts))]


def count_approx_native(text: str) -> int:
    raw = text.encode("utf-8")
    return int(load().lmrs_count_approx(raw, len(raw)))


def count_approx_batch(texts: list[str]) -> list[int]:
    """Approximate counts of a batch in one call."""
    lib = load()
    buf, offsets = _spans([t.encode("utf-8") for t in texts])
    out = np.zeros(len(texts), np.int64)
    lib.lmrs_count_approx_batch(buf, _p64(offsets), len(texts), _p64(out))
    return out.tolist()


# -------------------------------------------------------------- allocator


class NativePageAllocator:
    """The C++ free-list page allocator, with ``PageAllocator``'s contract:
    page 0 reserved, pages handed out lowest id first from a LIFO free
    list, ``OutOfPages`` when fewer are free than asked (nothing is taken),
    per-page refcounts (``incref``/``refcount``; ``free`` drops one and
    raises ``ValueError`` on a double free or an unowned page), every id
    of a call validated before any page changes.  Each call holds the
    allocator's own mutex."""

    RESERVED = 1  # page 0

    def __init__(self, num_pages: int):
        from lmrs_tpu_torch.engine.kv_cache import OutOfPages

        if num_pages <= self.RESERVED:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self._lib = load()
        self._out_of_pages = OutOfPages
        self.num_pages = num_pages
        self._h = self._lib.lmrs_palloc_create(num_pages)
        if not self._h:
            raise NativeBuildError("lmrs_palloc_create failed")

    @property
    def free_count(self) -> int:
        return int(self._lib.lmrs_palloc_free_count(self._h))

    # ctypes arrays, not numpy: an allocator call is a few microseconds,
    # and a numpy round trip would double it
    def alloc(self, n: int) -> list[int]:
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.lmrs_palloc_alloc(self._h, n, out) != 0:
            raise self._out_of_pages(f"need {n} pages, {self.free_count} free")
        return out[:n]

    def _call(self, fn, pages: list[int], op: str) -> None:
        rc = fn(self._h, (ctypes.c_int32 * len(pages))(*pages), len(pages))
        if rc == -3:
            raise ValueError(f"{op} of a page with too few references in "
                             f"{pages}: double-free / unowned page")
        if rc != 0:
            raise ValueError(f"bad page id in {pages}")

    def free(self, pages: list[int]) -> None:
        """Release one reference per listed page; pages reaching refcount 0
        return to the free list."""
        self._call(self._lib.lmrs_palloc_free, pages, "free")

    def incref(self, pages: list[int]) -> None:
        """Add one reference per listed page; only live pages may gain
        holders."""
        self._call(self._lib.lmrs_palloc_incref, pages, "incref")

    def refcount(self, page: int) -> int:
        rc = int(self._lib.lmrs_palloc_refcount(self._h, page))
        if rc < 0:
            raise ValueError(f"bad page id {page}")
        return rc

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            try:
                self._lib.lmrs_palloc_destroy(h)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
