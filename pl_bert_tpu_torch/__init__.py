"""pl_bert_tpu_torch — the PyTorch/CUDA port of pl_bert_tpu, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference. This package imports torch
and never jax, flax or any module of ``pl_bert_tpu``: what it needs of
the JAX package's host side (the symbol table, the config, masking and
collation, the packed datasets and the data pipeline, the metrics
logger, the serving batcher, pool and HTTP handler, the weight key map)
it keeps as its own copies. Every TPU kernel on a ported path is a
kernel written by hand for Hopper: CUDA C++ under ``csrc/`` (built by
``runtime/build.py`` with nvcc, bound with ctypes) or Triton. Each
kernel's wrapper runs its plain PyTorch version for CPU tensors, so the
package also runs, slowly, on a CPU.

Layer map (the serving and training slices):

    serving/    HTTP front-end, dynamic batcher, replica pool
    training/   Trainer entry point (train.py), train and eval steps (AdamW,
                grad accumulation, on-device masking), checkpoints (.pth),
                metrics log, step profiler
    models/     PhonemeEncoder (inference.py), ALBERT + phoneme head (albert.py)
    data/       whole-word masking, fixed-shape collation, dataset, packed
                datasets (sequence packing), pipeline + prefetch, bench batches
    ops/        attention dispatch (block | flash | eager), attention-block
                kernels (K1-K4), flash-attention kernels (K7/K8), fused-LN
                kernels and the copy anchor (K5/K6, K9), on-device masking,
                masked cross-entropy
    csrc/       CUDA C++ kernel sources
    runtime/    kernel build (nvcc -> .so, ctypes) and launch counters
    tools/      the fused-LN microbench
    utils/      the step-window profiler hook
    export/     weights across the two packages (reference .pth, flax trees)
    text/       the phoneme symbol table
    config.py   the training config (YAML sections)
"""

__version__ = "0.3.0"
