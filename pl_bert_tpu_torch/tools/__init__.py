"""Measurement tools that run on the card (bench_fused_ln.py)."""
