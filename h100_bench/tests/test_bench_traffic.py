"""The traffic generators repeat for a seed and differ across seeds, and
every seed sends the same work."""
import numpy as np
import torch

import harness as H
from sender import Context

SEEDS = (7, 2 ** 31 + 11)
DRAWS = 2000


def _sender(kind: str, cell: str, seed: int):
    traffic = H.traffic(H.cell(H.benchmark(), cell)["traffic"])
    assert traffic["kind"] == kind
    return H.sender(kind).Sender(Context(torch.device("cpu"), seed, traffic, None, None))


def test_every_traffic_file_names_a_sender_of_its_own_file():
    import glob
    import os
    for path in glob.glob(os.path.join(H.HERE, "workloads", "*.json")):
        kind = H.load_json(path)["kind"]
        assert hasattr(H.sender(kind), "Sender"), path


def test_gate_kinds_repeat_for_a_seed_and_differ_across_seeds():
    def kinds(seed):
        s = _sender("gate_chain", "gates-b256", seed)
        return [s.next_kind() for _ in range(DRAWS)]
    a, b = kinds(SEEDS[0]), kinds(SEEDS[1])
    assert a == kinds(SEEDS[0])
    assert a != b
    assert sorted(set(a)) == sorted(["AND", "OR", "NAND", "NOR", "XOR", "XNOR", "ANDNY",
                                     "ANDYN", "ORNY", "ORYN"])


def test_cipher_ops_come_in_blocks_of_one_each():
    def ops(seed):
        s = _sender("cipher_ops", "cipher16-serial", seed)
        return s.ops, [s.next_op() for _ in range(DRAWS // len(s.ops) * len(s.ops))]
    names, d0 = ops(SEEDS[0])
    assert d0 == ops(SEEDS[0])[1]
    assert d0 != ops(SEEDS[1])[1]
    for order in (d0, ops(SEEDS[1])[1]):
        blocks = np.array(order).reshape(-1, len(names))
        assert (np.sort(blocks, axis=1) == np.sort(names)).all()


def test_operands_repeat_for_a_seed_and_keep_to_their_ranges():
    from tfhe_tpu_torch import PARAMS_TOY
    import keys as K
    import run
    vals = []
    for seed in (SEEDS[0], SEEDS[0], SEEDS[1]):
        d = _sender("cipher_ops", "cipher16-serial", seed)
        d.ctx.keys = K.keygen(run.bench_params(PARAMS_TOY), 1, "cpu")
        d.setup()
        vals.append(d.values)
    for op, (a, b) in vals[0].items():
        lo, hi = d.ctx.traffic["ranges"][op]
        assert lo <= a.min() and a.max() <= hi and lo <= b.min() and b.max() <= hi
        assert np.array_equal(a, vals[1][op][0]) and np.array_equal(b, vals[1][op][1])
        assert not np.array_equal(a, vals[2][op][0])
    assert (vals[0]["div"][1] != 0).all() and (vals[2]["div"][1] != 0).all()


def test_gate_inputs_repeat_for_a_seed_and_differ_across_seeds():
    from tfhe_tpu_torch import PARAMS_TOY
    import keys as K
    import run
    outs = []
    for seed in (SEEDS[0], SEEDS[0], SEEDS[1]):
        d = _sender("gate_chain", "gates-b256", seed)
        d.ctx.keys = K.keygen(run.bench_params(PARAMS_TOY), seed, "cpu")
        d.setup()
        outs.append((d.bits0, d.pool_bits, d.x0.a, d.pool.b))
    assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0]) and not torch.equal(outs[0][2], outs[2][2])


def test_matrices_repeat_for_a_seed():
    from tfhe_tpu_torch import PARAMS_TOY
    import keys as K
    import run
    got = []
    for seed in (SEEDS[0], SEEDS[0], SEEDS[1]):
        d = _sender("matmul", "cipher16-matmul8", seed)
        d.ctx.traffic = dict(d.ctx.traffic, pool=2)
        d.pool_n = 2
        d.ctx.keys = K.keygen(run.bench_params(PARAMS_TOY), 3, "cpu")
        d.setup()
        got.append([p[0] for p in d.pairs])
    assert all(np.array_equal(x, y) for x, y in zip(got[0], got[1]))
    assert not np.array_equal(got[0][0], got[2][0])
