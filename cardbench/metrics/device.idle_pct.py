"""Share of the window in which no kernel ran on the card (one stream),
from the profiler's trace of the window."""


def read(rec):
    if "busy_s" not in rec:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
