"""The ALBERT encoder, its training forward and the phoneme-only model
(albert.py), and the inference API (inference.py)."""
