"""Device time of one ``Model.decode_step`` call: CUDA events around every
decode step the window drove, the total over the count."""


def read(rec):
    ms = [m for b in rec["batches"] for m in b["decode_ms"]]
    return sum(ms) / len(ms) if ms else None
