"""Model FLOPs utilisation of the whole window: the closed-form FLOPs
(``families/<family>.py``) of every prefill and decode step of the window's
batches whose token reached the host, over the window's length times the
card's bf16 peak."""


def read(rec):
    if "bf16_peak" not in rec:
        return None
    flops = 0.0
    for b in rec["batches"]:
        t = b["t_tok"]
        if rec["t0"] <= t[0] <= rec["t1"]:
            flops += b["prefill_flops"]
        flops += sum(f for f, ti in zip(b["decode_flops"], t[1:])
                     if rec["t0"] <= ti <= rec["t1"])
    return 100.0 * flops / (rec["seconds"] * rec["bf16_peak"])
