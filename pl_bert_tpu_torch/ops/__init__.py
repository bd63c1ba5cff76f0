"""Attention dispatch (attention.py), the masked cross-entropy
(masked_ce.py), on-device masking (ondevice_masking.py) and the
hand-written kernels: the attention block's forward and backward
(attention_block.py, CUDA C++), the per-head flash attention's
(flash_attention.py, CUDA C++), and the fused dropout + residual add +
LayerNorm forward and backward with its copy anchor (fused_ln.py,
Triton)."""
