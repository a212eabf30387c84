"""``serial.prefix_pct`` in the matrix cell, whose end-to-end metric is
``matmul_s``: the share of the adders' decisions that took the
parallel-prefix arm."""
import harness as H

read = H.reader("serial.prefix_pct")
