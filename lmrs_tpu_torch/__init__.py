"""lmrs_tpu_torch — the PyTorch/CUDA port of the map-reduce summarizer.

A package of its own beside ``lmrs_tpu`` (the JAX reference, which it never
imports).  Plain tensor code is PyTorch; every TPU kernel on the ported path
is a CUDA C++ kernel written for Hopper (``csrc/``), built at first use and
bound with ``ctypes``.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version instead.
"""

__version__ = "0.1.0"
