"""The card's peaks that a reader of any model family divides by.

NVIDIA H100 SXM5, dense, at its 700 W limit (NVIDIA's data sheet). A
family's work counts keep their own copy beside the terms they weigh
(``cost.py`` for PL-BERT); ``tests/test_port_bench_family.py`` holds
the two equal.
"""

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
