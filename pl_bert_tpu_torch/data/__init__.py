"""Host-side masking, collation, the masked-phoneme dataset, the packed
datasets and the data pipeline, copies of the JAX package's (masking.py,
collate.py, dataset.py, packed.py, pipeline.py), and bench.py's workload
as batches (synthetic.py)."""
