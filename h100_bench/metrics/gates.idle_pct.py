"""The share of the traced window in which no kernel ran on the card
(rank 0's card on several)."""
import devtrace


def read(run):
    return devtrace.idle_pct(run.trace)
