"""Device kernels of the traced window over the operations completed in it."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    return len(run.trace["kernels"]) / len(run.jobs)
