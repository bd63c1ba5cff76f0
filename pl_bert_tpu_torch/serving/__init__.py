"""HTTP serving over the PyTorch encoder (server.py)."""
