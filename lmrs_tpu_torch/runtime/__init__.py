"""The port's native host runtime (C++ through ctypes): text cleaning,
approximate token counts and the KV page allocator, built at first use
from ``lmrs_tpu_torch/csrc/lmrs_runtime.cc`` (``runtime/native.py``).
``LMRS_NATIVE=0`` selects the Python versions; with it on, a failed build
raises."""

from lmrs_tpu_torch.runtime.native import (  # noqa: F401
    NativeBuildError,
    NativePageAllocator,
    clean_text_batch,
    clean_text_native,
    count_approx_batch,
    count_approx_native,
)
