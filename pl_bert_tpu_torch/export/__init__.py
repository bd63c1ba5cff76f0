"""Weights across the JAX and PyTorch packages (bridge.py)."""
