"""Weights across the JAX and PyTorch packages, in the reference's torch
naming (bridge.py)."""
