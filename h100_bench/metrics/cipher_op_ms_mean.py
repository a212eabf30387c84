"""The window over the CipherInt operations completed in it, in ms."""


def read(run):
    if run.traffic["kind"] != "cipher_ops" or not run.jobs:
        return None
    return 1e3 * run.window_s / len(run.jobs)
