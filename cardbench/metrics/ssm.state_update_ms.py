"""Device time of the Mamba-2 state updates of one decode step: the device
time of the kernels whose name bears K4's mark (``ssm_state_update``) that
start inside the window, over the window's decode steps.  Nothing where
the trace holds none."""
MARK = "ssm_state_update"


def read(rec):
    k4 = [b - a for n, a, b in rec.get("kernels", ()) if MARK in n]
    steps = sum(len(b["decode_ms"]) for b in rec["batches"])
    if not k4 or not steps:
        return None
    return sum(k4) * 1e3 / steps
