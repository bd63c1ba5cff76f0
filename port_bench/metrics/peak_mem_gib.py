"""Peak device memory the caching allocator held during the window
(``max_memory_allocated`` after a reset at its start), GiB."""


def read(w: dict):
    return w["peak_bytes"] / 2**30 if w["peak_bytes"] else None
