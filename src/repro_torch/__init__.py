"""PyTorch/CUDA port of the Epiphany run-time reproduction.

A second package beside ``repro`` (the JAX reference).  It imports nothing
from ``repro`` and nothing from JAX: it keeps its own copies of the
configuration modules it needs.  Its kernels are CUDA C++ written for
Hopper (``sm_90a``) under ``kernels/csrc/``; a tensor on the CPU takes
each kernel's plain PyTorch version, a tensor on the card launches the
kernel or raises.
"""
