"""Data, tensor and sequence parallelism over ``torch.distributed``."""
