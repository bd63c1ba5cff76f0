"""Host-side masking, collation and the masked-phoneme dataset, copies of
the JAX package's (masking.py, collate.py, dataset.py), and bench.py's
workload as batches (synthetic.py)."""
