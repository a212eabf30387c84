"""Property tests of the port's static carry-save planners (pure numpy).

Twins of tests/test_planner_properties.py on tfhe_tpu_torch.arith: the real
planners over hundreds of random bit profiles, each level checked to keep
the weighted bit sum mod 2^nbits (a 7:3 septet emits its three popcount
digits, a full adder sum and carry, a recode a copy), every slot used once.
Each plan must also equal tfhe_tpu.arith's on the same profile.
"""
import numpy as np
import pytest

from tfhe_tpu import arith as jarith
from tfhe_tpu_torch import arith


def _same_plan(got, want) -> None:
    """Plans are tuples of lists and arrays; equal element for element."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, (list, tuple)) and g and isinstance(g[0], (list, tuple, np.ndarray)):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


MAX_LEVELS = 200


def _value(v, cc, nbits):
    return int(np.sum(np.asarray(v, np.int64) << np.asarray(cc, np.int64))
               % (1 << nbits))


def _apply_septet_level(v, cc, amp, nbits):
    """Numpy twin of one _wallace_sum_bits_septet level using the real plan."""
    plan = arith._compress_level_plan(cc, amp, nbits)
    _same_plan(plan, jarith._compress_level_plan(cc, amp, nbits))
    sept, fa16, fa8, rec8, keep = plan
    assert sept or fa16 or fa8 or rec8, "level planned no work (stuck column)"
    used = []
    nv, ncc = [], []

    def out(bit, col):
        if col < nbits:
            nv.append(bit)
            ncc.append(col)

    for g in sept:
        live = [i for i in g if i >= 0]
        used += live
        s = int(sum(v[i] for i in live))
        c = cc[live[0]]
        out(s & 1, c); out((s >> 1) & 1, c + 1); out((s >> 2) & 1, c + 2)
    for g in fa16 + fa8:
        live = [i for i in g if i >= 0]
        used += live
        s = int(sum(v[i] for i in live))
        c = cc[live[0]]
        out(s & 1, c); out((s >> 1) & 1, c + 1)
    for i in rec8:
        used.append(i)
        out(v[i], cc[i])
    # every input bit consumed exactly once, by a gadget or by keep
    assert sorted(used + list(keep)) == list(range(len(cc))), \
        "planner dropped or double-used a bit slot"
    namp = [16] * len(nv)
    for i in keep:
        nv.append(v[i]); ncc.append(cc[i]); namp.append(amp[i])
    return (np.array(nv, np.int64), np.array(ncc, np.int64),
            np.array(namp, np.int64))


def _run_septet(v, cc, amp, nbits):
    want = _value(v, cc, nbits)
    for _ in range(MAX_LEVELS):
        if not len(cc) or np.bincount(cc, minlength=nbits).max() <= 2:
            break
        v, cc, amp = _apply_septet_level(v, cc, amp, nbits)
        assert _value(v, cc, nbits) == want, "level broke the weighted sum"
    else:
        pytest.fail("septet reduction did not terminate")
    assert (not len(cc)) or np.bincount(cc, minlength=nbits).max() <= 2
    return v, cc


def test_septet_planner_random_profiles():
    rng = np.random.RandomState(0)
    for trial in range(300):
        nbits = int(rng.randint(2, 34))
        M = int(rng.randint(1, 161))
        cc = rng.randint(0, nbits, size=M)
        v = rng.randint(0, 2, size=M)
        # mixed amplitude classes: fresh ±1/8 inputs and compressor-internal ±1/16
        amp = np.where(rng.rand(M) < 0.5, 8, 16)
        _run_septet(v.copy(), cc.copy(), amp.copy(), nbits)


def test_septet_planner_triangle_profiles():
    """The multiplier's truncation triangle: column c holds c+1 partial products."""
    rng = np.random.RandomState(1)
    for nbits in (4, 8, 16, 24, 32):
        cc = np.concatenate([np.full(c + 1, c) for c in range(nbits)])
        v = rng.randint(0, 2, size=len(cc))
        amp = np.full(len(cc), 8)
        _run_septet(v, cc, amp, nbits)


def test_dadda_fa_planner_random_profiles():
    rng = np.random.RandomState(2)
    for trial in range(300):
        nbits = int(rng.randint(2, 34))
        M = int(rng.randint(1, 161))
        cc = rng.randint(0, nbits, size=M)
        v = rng.randint(0, 2, size=M)
        want = _value(v, cc, nbits)
        targets = arith._dadda_targets(int(np.bincount(cc, minlength=nbits).max()))
        assert targets == jarith._dadda_targets(int(np.bincount(cc, minlength=nbits).max()))
        for target in reversed(targets[:-1] or [2]):
            if np.bincount(cc, minlength=nbits + 1).max() <= 2:
                break
            xi, yi, zi, keep = arith._dadda_plan(cc, nbits, target)
            _same_plan((xi, yi, zi, keep), jarith._dadda_plan(cc, nbits, target))
            if not xi.size:
                continue
            used = list(xi) + list(yi) + [z for z in zi if z >= 0] + list(keep)
            assert sorted(used) == list(range(len(cc))), \
                "Dadda level dropped or double-used a bit slot"
            nv, ncc = [], []
            for x, y, z in zip(xi, yi, zi):
                s = int(v[x]) + int(v[y]) + (int(v[z]) if z >= 0 else 0)
                c = int(cc[x])
                nv.append(s & 1); ncc.append(c)
                if c + 1 < nbits:
                    nv.append((s >> 1) & 1); ncc.append(c + 1)
            for i in keep:
                nv.append(int(v[i])); ncc.append(int(cc[i]))
            v, cc = np.array(nv, np.int64), np.array(ncc, np.int64)
            assert _value(v, cc, nbits) == want, "Dadda level broke the sum"
        assert np.bincount(cc, minlength=nbits).max() <= 2
        assert _value(v, cc, nbits) == want


def test_two_row_plan_covers_all_slots():
    rng = np.random.RandomState(3)
    for trial in range(200):
        nbits = int(rng.randint(2, 34))
        # height <= 2 per column, as the finale requires
        cols = []
        for c in range(nbits):
            cols += [c] * int(rng.randint(0, 3))
        rng.shuffle(cols)
        cc = np.array(cols, np.int64)
        M = len(cc)
        r0, r1 = arith._two_row_plan(cc, nbits)
        _same_plan((r0, r1), jarith._two_row_plan(cc, nbits))
        taken = [i for i in list(r0) + list(r1) if i < M]
        assert sorted(taken) == list(range(M)), "two-row plan lost a bit"
        for c in range(nbits):  # row gathers must stay in their column
            for r in (r0, r1):
                if r[c] < M:
                    assert cc[r[c]] == c
