"""Time to first token, 95th percentile over every request of the window:
from the start of its batch (all of a closed-loop batch's requests are
sent together) to the copy of its first token landing on the host."""
from harness.stats import percentile


def read(rec):
    vals = []
    for b in rec["batches"]:
        if rec["t0"] <= b["t_tok"][0] <= rec["t1"]:
            vals += [(b["t_tok"][0] - b["t_start"]) * 1e3] * rec["batch_size"]
    return percentile(vals, 95)
