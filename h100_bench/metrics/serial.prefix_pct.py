"""The share of the adders' prefix-or-ripple decisions that took the
parallel-prefix arm: ``arith.ADDER_ARMS["prefix"]`` over both arms' counts at
the end of the run (the warm-up's calls included; a replayed graph counts the
decisions of its capture, as the launch counters do). A program without the
counter reports nothing. ``matmul.prefix_pct`` reads the same in the matrix
cell."""


def read(run):
    from tfhe_tpu_torch import arith
    arms = getattr(arith, "ADDER_ARMS", None)
    total = sum(arms.values()) if arms else 0
    return 100.0 * arms.get("prefix", 0) / total if total else None
