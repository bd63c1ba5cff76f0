"""Attention dispatch (attention.py) and the hand-written kernels:
the attention block (attention_block.py, CUDA C++) and the fused
dropout + residual add + LayerNorm (fused_ln.py, Triton)."""
