"""K1's share of its roofline: the least time of the window's K1 launches
(the family's closed form of the unmasked pairs, ``families/<family>.py``,
at the card's peaks) over the device time of the kernels of K1's category
(``harness/trace.py``: names holding ``flash_fwd``) that start inside the
window.  Nothing where the trace holds none."""
from harness.trace import K1, category


def read(rec):
    k1 = [(a, b) for n, a, b in rec.get("kernels", ()) if category(n) == K1]
    if not k1:
        return None
    ms = sum(b - a for a, b in k1) * 1e3
    return 100.0 * len(k1) * rec["k1_bound_ms"] / ms
