"""Kernel build and launch bookkeeping (``build.py``)."""
