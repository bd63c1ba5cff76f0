"""Corpus preprocessing, as far as the pack stage needs it: the
``records.jsonl`` dataset format (``shard_engine.py``) and the pack stage
of ``pipeline.py``."""
