"""K4's share of its roofline: the window's K4 launches (the kernels whose
name bears K4's mark, ``ssm_state_update``, that start inside the window),
each at the least time of the family's closed form of one launch
(``k4_work``, ``families/<family>.py``: fp32 operations and bytes at the
card's peaks, ``harness/peaks.py``), over their device time.  Nothing
where the trace holds none."""
from harness import manifest
from harness.peaks import PEAKS, bound

MARK = "ssm_state_update"


def read(rec):
    k4 = [(a, b) for n, a, b in rec.get("kernels", ()) if MARK in n]
    if not k4 or "bf16_peak" not in rec:
        return None
    (_, fp32, bw), = [p for p in PEAKS.values() if p[0] == rec["bf16_peak"]]
    work = manifest.family(rec["cfg"]["family"]).k4_work(rec["cfg"], rec["batch_size"])
    ms = sum(b - a for a, b in k4) * 1e3
    return 100.0 * len(k4) * bound(*work, fp32, bw)[0] / ms
