"""Device milliseconds a step of the grapheme head: the kernels launched
inside the program's ``lm_head.*`` ranges (gather, capacity read,
logits, CE, dh, dW) in the traced steps."""


def read(w: dict):
    trace = w["trace"]
    if not trace or not trace["ranges"] or not trace["steps"]:
        return None
    return 1e3 * sum(trace["ranges"].values()) / trace["steps"]
