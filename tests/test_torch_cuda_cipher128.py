"""The 16-bit CipherInt operations at PARAMS_128 (l = 3, n = 630) on the card,
eager and replayed from their captured graphs: each of the eight ops of the
benchmark's serial traffic (add, sub, mul, gt, eq, abs, min, div) on one
number decrypts to what ``h100_bench/reference.py`` says it means, and a
replay of its graph, on the capture's operands and on others, equals the
eager run word for word (a, b and cv), counting the same K5 stages by
cluster (``ops.cmux_packed.CLUSTERS``). Every test needs a CUDA device
and skips without one.

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_cipher128.py
"""
import os
import sys

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as tt
from tfhe_tpu_torch import CipherInt, arith, config
from tfhe_tpu_torch.ops import cmux_packed
from tfhe_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "h100_bench")
if BENCH not in sys.path:
    sys.path.append(BENCH)          # the benchmark's modules import each other by name
import reference as ref   # noqa: E402

pytestmark = pytest.mark.cuda

NB = 16
OPS = {
    "add": lambda x, y: (x + y).ct, "sub": lambda x, y: (x - y).ct,
    "mul": lambda x, y: (x * y).ct, "gt": lambda x, y: x > y, "eq": lambda x, y: x.eq(y),
    "abs": lambda x, y: x.abs().ct, "min": lambda x, y: x.minimum(y).ct,
    "div": lambda x, y: (x / y).ct,
}
# the capture's operands, then the replay's
OPERANDS = {op: [(1234, -567), (-32000, 29999)] for op in OPS}
OPERANDS["min"] = [(30001, 4567), (17, 32767)]
OPERANDS["eq"] = [(-7, -7), (21845, -21845)]
OPERANDS["div"] = [(-32767, 3), (1000, -7)]


@pytest.fixture(scope="module")
def sk128():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tt.keygen(tt.PARAMS_128, seed=1916, device="cuda")


def _answer(sk, op: str, out) -> int:
    if op in ("gt", "eq"):
        return int(tt.decrypt_bits(sk, out).reshape(-1)[0])
    return int(arith.decrypt_int(sk, out).reshape(-1)[0])


def _same(got, want) -> None:
    for f in ("a", "b", "cv"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("op", list(OPS))
def test_op_at_params_128_eager_and_replayed(sk128, op, monkeypatch):
    sk = sk128
    monkeypatch.setattr(arith, "GRAPHS", arith.CircuitGraphs(eager_calls=1))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(128)
    pairs = [tuple(CipherInt(arith.encrypt_int(sk, np.array(v), NB, gen, "cuda"), sk.cloud)
                   for v in pair) for pair in OPERANDS[op]]
    eager, stages = [], []
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="0"):
        for x, y in pairs:
            profiling.reset_counters()
            eager.append(OPS[op](x, y))
            torch.cuda.synchronize()
            stages.append(dict(cmux_packed.CLUSTERS))
    with config.overrides(TFHE_TPU_CIRCUIT_JIT="1"):
        OPS[op](*pairs[0])                                # the warm-up, eager
        captured = OPS[op](*pairs[0])
        profiling.reset_counters()
        replayed = OPS[op](*pairs[1])
        torch.cuda.synchronize()
    assert arith.GRAPHS.counts["capture"] == arith.GRAPHS.counts["replay"] == 1
    _same(captured, eager[0])
    _same(replayed, eager[1])
    assert dict(cmux_packed.CLUSTERS) == stages[1] == stages[0]
    assert sum(stages[0].values()) > 0, stages[0]
    for (a, b), out in zip(OPERANDS[op], (captured, replayed)):
        assert _answer(sk, op, out) == ref.cipher_op(op, a, b, NB), (a, b)
