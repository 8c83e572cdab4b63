"""Output tokens per second: every output token (the first included) of
the window's requests that reached the host, over the window's length
(from the first batch's start to the end of the last)."""


def read(rec):
    n = sum(1 for b in rec["batches"] for t in b["t_tok"] if rec["t0"] <= t <= rec["t1"])
    return n * rec["batch_size"] / rec["seconds"]
