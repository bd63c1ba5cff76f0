"""The step-window profiler (profiler.py)."""
