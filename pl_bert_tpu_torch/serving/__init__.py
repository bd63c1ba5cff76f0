"""HTTP serving over the PyTorch encoder (server.py), with its dynamic
batcher (batcher.py) and replica pool (pool.py)."""
