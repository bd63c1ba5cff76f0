"""The ALBERT encoder (albert.py) and the inference API (inference.py)."""
