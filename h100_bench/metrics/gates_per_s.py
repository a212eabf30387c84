"""Gates completed in the window over the window: host clock from the
window's start to the synchronise on its last completed step."""


def read(run):
    if run.traffic["kind"] != "gate_chain" or not run.jobs:
        return None
    return run.units / run.window_s
