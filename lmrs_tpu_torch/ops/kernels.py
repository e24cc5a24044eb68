"""Build and load the port's hand-written CUDA kernels.

Each source under ``lmrs_tpu_torch/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  The int8-pool kernels are further ``extern "C"`` symbols of the
same sources, sharing ``csrc/kv_int8.cuh``; the split-sequence kernels
share ``csrc/split_merge.cuh``, and the span and verify kernels their tile
walk, ``csrc/tile_attn.cuh``.  Libraries land in
``build/lmrs_tpu_torch/`` at the repo root, named by a hash of the source,
the shared headers and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Building happens at first use (never at
import): the CPU tests import every module without a CUDA toolkit.

``build_all`` starts one ``nvcc`` per library, all at once, and waits for
them together.  A library is a source compiled with its own defines
(``BUILDS``): the span kernel's ancestor-mask build is ``ragged_spans.cu``
under ``-DLMRS_SPAN_ANC``, a library of its own, so its instantiations
compile beside the others instead of lengthening the span kernel's
``nvcc``.

``shape_problems`` / ``check_shapes`` state the one shape rule every
attention kernel here is built for (head dims, query heads per kv head,
page size, the verify kernel's query rows).  The wrappers check a call
against it, and ``TorchEngine`` checks a model and engine configuration
against it before it runs anything on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmrs_tpu_torch"
SOURCES = ("flash_prefill", "paged_decode", "ragged_spans",
           "paged_decode_multi", "ragged_spans_anc")
# library -> (source under csrc/, extra nvcc defines); every other library
# is its own source without any
BUILDS = {"ragged_spans_anc": ("ragged_spans", ("-DLMRS_SPAN_ANC",))}
# never --use_fast_math: the int8 kernels' quantizing division must stay
# IEEE to match torch.round(x / s) bit for bit (csrc/kv_int8.cuh)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# the dispatch watchdog of the scheduler run on this thread (set for the
# length of a run): a build at first use opens its grace window, so a cold
# nvcc never reads as a wedge (engine/watchdog.py)
_build_watch = threading.local()

# the template builds of the attention kernels (csrc/*.cu dispatch)
HEAD_DIMS = (32, 64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head, H / K
PAGE_MULTIPLE = 32          # decode tiles of 32 tokens lie inside one page
MULTI_QROWS = 64            # the verify kernel's query tile: T x H/K rows


def shape_problems(hd: int, n_heads: int, n_kv_heads: int,
                   page_size: int | None = None,
                   verify_tokens: int | None = None) -> list[str]:
    """What the CUDA attention kernels refuse in these shapes, one phrase
    each (empty: they take them).  ``page_size`` applies to the paged
    kernels, ``verify_tokens`` (T) to the multi-token verify kernel."""
    out = []
    if hd not in HEAD_DIMS:
        out.append(f"hd in {HEAD_DIMS} (got hd={hd})")
    n_rep = n_heads // n_kv_heads if n_kv_heads > 0 else 0
    if n_rep not in GROUP_SIZES or n_rep * n_kv_heads != n_heads:
        out.append(f"H/K in {GROUP_SIZES} (got H={n_heads}, K={n_kv_heads})")
    if page_size is not None and page_size % PAGE_MULTIPLE:
        out.append(f"page_size % {PAGE_MULTIPLE} == 0 (got {page_size})")
    if verify_tokens is not None and not 1 <= verify_tokens * n_rep <= MULTI_QROWS:
        out.append(f"T x H/K <= {MULTI_QROWS} query rows per kv head (got "
                   f"T={verify_tokens}, H/K={n_rep})")
    return out


def check_shapes(op: str, hd: int, n_heads: int, n_kv_heads: int,
                 page_size: int | None = None,
                 verify_tokens: int | None = None) -> None:
    """Raise ``ValueError`` naming ``op`` if ``shape_problems`` finds any."""
    problems = shape_problems(hd, n_heads, n_kv_heads, page_size, verify_tokens)
    if problems:
        raise ValueError(f"{op}: the CUDA kernels take " + "; ".join(problems))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """A library's source file and its extra ``nvcc`` defines."""
    src, defines = BUILDS.get(name, (name, ()))
    return CSRC / f"{src}.cu", defines


def _lib_path(name: str) -> Path:
    path, defines = _source(name)
    src = path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + defines)
    digest = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every listed library that is not up to date, one ``nvcc``
    process each, all started together.  Returns per-library
    ``{"seconds", "cached", "ptxas"}`` (``ptxas`` = the register/shared
    memory report of ``-Xptxas -v``).  Raises on a failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not _lib_path(n).exists() for n in names) else ""
    procs, info = {}, {}
    t0 = time.time()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        path, defines = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        info[name] = {"seconds": round(time.time() - t0, 3), "cached": False,
                      "ptxas": log.strip()}
    return info


def set_build_watchdog(wd) -> None:
    """Name the watchdog (or None) of the scheduler run on this thread."""
    _build_watch.wd = wd


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` unless ``BUILDS``
    says otherwise), building it if needed; a build inside a watched run
    runs in the watchdog's grace window.  ``ctypes.CDLL``, never
    ``PyDLL``: a call into the library releases the GIL, so a launch that
    blocks on a full launch queue leaves the watching thread free to
    declare a wedge."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            wd = getattr(_build_watch, "wd", None)
            if wd is not None:
                wd.grace_cold()
            try:
                build_all((name,))
            finally:
                if wd is not None:
                    wd.grace_end()
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def check_launch(fn_name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error (its
    ``cudaGetLastError()`` right after the launch)."""
    if code != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {code}")
