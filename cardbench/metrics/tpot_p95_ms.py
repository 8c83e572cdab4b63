"""Time per output token, 95th percentile over every gap between two
consecutive output tokens of every request of the window."""
from harness.stats import percentile


def read(rec):
    vals = []
    for b in rec["batches"]:
        t = b["t_tok"]
        gaps = [(t[j] - t[j - 1]) * 1e3 for j in range(1, len(t))
                if rec["t0"] <= t[j] <= rec["t1"]]
        vals += gaps * rec["batch_size"]
    return percentile(vals, 95)
