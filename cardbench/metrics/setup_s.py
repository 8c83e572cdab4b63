"""Set-up: from the start of the process to the start of the first measured
batch (imports, the kernels' build or load, the weights drawn on the card,
the warm-up batch and its analysis window)."""


def read(rec):
    return rec["setup_s"]
