"""Seconds from the window's start to the last completed matrix product,
over the products completed."""


def read(run):
    if run.traffic["kind"] != "matmul" or not run.jobs:
        return None
    return run.window_s / len(run.jobs)
