"""The 90th percentile (nearest rank) of the window's step times, each
from CUDA events recorded before and after the step."""

import math


def read(w: dict):
    times = sorted(w["step_ms"])
    if not times:
        return None
    return times[min(len(times) - 1, math.ceil(0.9 * len(times)) - 1)]
