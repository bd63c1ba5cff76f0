"""pl_bert_tpu_torch — the PyTorch/CUDA port of pl_bert_tpu, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference. This package imports torch
and never jax or flax; it reuses the JAX package's host layers that
import without jax (the symbol table, the serving batcher, HTTP server
and client). Every TPU kernel on a ported path is a kernel written by
hand for Hopper: CUDA C++ under ``csrc/`` (built by ``runtime/build.py``
with nvcc, bound with ctypes) or Triton. Each kernel's wrapper runs its
plain PyTorch version for CPU tensors, so the package also runs, slowly,
on a CPU.

Layer map (the serving slice):

    serving/   HTTP front-end over the encoder (JAX package's server reused)
    models/    PhonemeEncoder (inference.py), ALBERT encoder (albert.py)
    ops/       attention dispatch, attention-block kernel, fused-LN kernel
    csrc/      CUDA C++ kernel sources
    runtime/   kernel build (nvcc -> .so, ctypes) and launch counters
    export/    weights across the two packages (reference .pth, flax trees)
"""

__version__ = "0.1.0"
