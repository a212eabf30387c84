"""The 95th percentile of every operation's latency in the window, in ms:
each from the call to the synchronise on its result."""
import numpy as np


def read(run):
    if run.traffic["kind"] != "cipher_ops" or not run.jobs:
        return None
    return float(np.percentile([1e3 * (j.end - j.start) for j in run.jobs], 95))
