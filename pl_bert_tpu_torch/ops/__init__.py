"""Attention dispatch (attention.py), the masked cross-entropy
(masked_ce.py) and the hand-written kernels: the attention block's
forward and backward (attention_block.py, CUDA C++) and the fused
dropout + residual add + LayerNorm forward and backward (fused_ln.py,
Triton)."""
