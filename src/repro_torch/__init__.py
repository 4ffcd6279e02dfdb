"""repro_torch — the GraphPi reproduction on PyTorch and CUDA (NVIDIA H100).

A sibling of the JAX package `repro`, module for module: each port
module keeps its counterpart's name (`repro_torch/core/executor.py` ↔
`repro/core/executor.py`).  Plain tensor code is PyTorch; the one
kernel on the counting path (`kernels/csrc/level_expand.cu`) is CUDA
C++ for `sm_90a`, built with `nvcc` at first use.  Entry points take an
explicit `device` (default ``"cuda"``) and raise when no card is
present, unless the caller asks for ``device="cpu"``.

Importing this package needs neither CUDA nor JAX.
"""
