"""Host milliseconds a step waited for its batch from the Trainer's
prefetch thread (the benchmark's span around the fetch), mean over the
window's steps."""


def read(w: dict):
    waits = w["feed_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
