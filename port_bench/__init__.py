"""The benchmark of ``pl_bert_tpu_torch``, PL-BERT's PyTorch/CUDA port on
one H100: ``python3 -m port_bench --workload <name> --seed <n> --seconds
<s> --trace <0|1>``."""
