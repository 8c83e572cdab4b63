"""Device time of one ``Model.prefill`` call: CUDA events around every
prefill the window drove, the total over the count."""


def read(rec):
    ms = [b["prefill_ms"] for b in rec["batches"]]
    return sum(ms) / len(ms) if ms else None
