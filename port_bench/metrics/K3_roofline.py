"""K3's share of its roofline, %: the attention block's training forward
(csrc/attention_block.cu: its projections on wgmma and the attention
pass). The least time the traced steps' inputs need for its work (the
model family's ``kernel_bound_s``) over its kernels' device time in the
trace, found by name."""

from port_bench import trace

KERNELS = ("attention_fwd", "gemm_bias_sm90<false>")


def read(w: dict):
    tr = w["trace"]
    spent = trace.device_seconds(tr, KERNELS) if tr else 0.0
    if spent <= 0:
        return None
    bound = sum(w["family"].kernel_bound_s("K3", w["model"], m)
                for step in tr["stats"] for m in step)
    return 100.0 * bound / spent
