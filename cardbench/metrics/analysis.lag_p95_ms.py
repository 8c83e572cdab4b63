"""Analysis lag, 95th percentile over the window's batches: host clock from
``submit_recorder`` to the port's ``AsyncAnalysisSession`` calling
``on_window`` for that batch's window."""
from harness.stats import percentile


def read(rec):
    return percentile(rec["lags_ms"], 95)
