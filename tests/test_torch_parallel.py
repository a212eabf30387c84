"""tfhe_tpu_torch.parallel against the single-process port and tfhe_tpu.parallel.

Four ranks spawned once for the module (gloo on the CPU, one torch thread
each, a file rendezvous in a fresh temporary directory, so that concurrent
test workers never share a port), PARAMS_TOY keys carried in as raw numpy.
Every rank returns the whole result; each must be byte-equal (a, b exact, cv to rtol 1e-6) to
the same computation in one process and to tfhe_tpu's sharded entry points
on the 8-device virtual mesh of tests/conftest.py.

The rank function lives in this module, which imports nothing of JAX at its
top: a spawned rank imports it by name and must stay free of JAX.
"""
import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, gates
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.parallel import dryrun
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
B = 16              # the gate batch: divides over 4 ranks and over tfhe_tpu's 8 devices
CANNON_A = np.array([[1, 2], [0, 3]], np.int64)
CANNON_B = np.array([[2, 1], [1, 1]], np.int64)


def _cloud(raw, device):
    return keys.cloud_from_raw(pt.PARAMS_TOY, raw["bk_raw"], raw["ks_a"], raw["ks_b"], device)


def _lwe(arrs, device="cpu") -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)).to(device) for v in arrs))


def _np(ct: LweCiphertext) -> tuple:
    return tuple(v.cpu().numpy() for v in (ct.a, ct.b, ct.cv))


def _ranks(rank, world, device, raw, inputs):
    """On each rank: every sharded entry point of the port on the same inputs."""
    from tfhe_tpu_torch.parallel.cannon import cannon_matmul_mesh, make_mesh2d
    from tfhe_tpu_torch.parallel.mesh import (make_mesh, make_mesh2d_dp_ks,
                                              sharded_bootstrap_step, sharded_circuit,
                                              sharded_gate2, sharded_gate2_tp_ks)
    cloud = _cloud(raw, device)
    ct = {k: _lwe(v, device) for k, v in inputs.items()}
    mesh, dpks, grid = (make_mesh(world, device=device), make_mesh2d_dp_ks(2, 2, device=device),
                        make_mesh2d(2, device=device))
    out = {
        "and": sharded_gate2("AND", ct["x"], ct["y"], cloud, mesh),
        "tp_xor": sharded_gate2_tp_ks("XOR", ct["x"], ct["y"], cloud, dpks),
        "tp_and": sharded_gate2_tp_ks("AND", ct["x"], ct["y"], cloud, dpks),
        "boot": sharded_bootstrap_step(ct["x"], cloud, mesh),
        "mul4": sharded_circuit(arith.mul, (ct["m4a"], ct["m4b"]), cloud, mesh),
        "mul8": sharded_circuit(arith.mul, (ct["m8a"], ct["m8b"]), cloud, mesh),
        "cannon": cannon_matmul_mesh(ct["ca"], ct["cb"], cloud, grid),
    }
    return {k: _np(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def run(toy_keys):
    """(JAX keys, the port's key set, the inputs as tfhe_tpu ciphertexts, the
    four ranks' results)."""
    import tfhe_tpu as jt
    from tfhe_tpu import arith as ja
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2, size=(2, B)).astype(np.int32)
    m4 = rng.randint(0, 16, size=(2, WORLD))
    m8 = rng.randint(0, 256, size=(2, 2 * WORLD))
    jin = {"x": jt.encrypt_bits(toy_keys, bits[0], seed=61),
           "y": jt.encrypt_bits(toy_keys, bits[1], seed=62),
           "m4a": ja.encrypt_int(toy_keys, m4[0], 4, seed=71),
           "m4b": ja.encrypt_int(toy_keys, m4[1], 4, seed=72),
           "m8a": ja.encrypt_int(toy_keys, m8[0], 8, seed=73),
           "m8b": ja.encrypt_int(toy_keys, m8[1], 8, seed=74),
           "ca": ja.encrypt_int(toy_keys, CANNON_A, 4, seed=63),
           "cb": ja.encrypt_int(toy_keys, CANNON_B, 4, seed=64)}
    raw = {k: np.asarray(getattr(toy_keys, k)) for k in ("bk_raw", "ks_a", "ks_b")}
    inputs = {k: tuple(np.asarray(v) for v in (c.a, c.b, c.cv)) for k, c in jin.items()}
    outs = dryrun.run(WORLD, _ranks, raw, inputs, device="cpu", threads=1)
    psk = keys.SecretKeySet(pt.PARAMS_TOY, toy_keys.lwe_key, toy_keys.tlwe_key,
                            toy_keys.bk_raw, toy_keys.ks_a, toy_keys.ks_b, _cloud(raw, "cpu"))
    return toy_keys, psk, jin, {"bits": bits, "m4": m4, "m8": m8}, outs


def _same(got: tuple, want) -> None:
    """a, b exact, cv to rtol 1e-6; `want` a ciphertext of either package."""
    w = [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
         for v in (want.a, want.b, want.cv)]
    np.testing.assert_array_equal(got[0], w[0])
    np.testing.assert_array_equal(got[1], w[1])
    np.testing.assert_allclose(got[2], w[2], rtol=1e-6)


def _port(jct) -> LweCiphertext:
    return _lwe((jct.a, jct.b, jct.cv))


@pytest.mark.parametrize("key", ["and", "tp_xor", "tp_and", "boot", "mul4", "mul8", "cannon"])
def test_every_rank_returns_the_same_result(run, key):
    outs = run[-1]
    for r in range(1, WORLD):
        for got, want in zip(outs[r][key], outs[0][key]):
            np.testing.assert_array_equal(got, want)


def test_dp_and_matches_one_process_and_tfhe_tpu(run):
    import jax
    from tfhe_tpu.parallel import make_mesh as j_make_mesh, sharded_gate2 as j_sharded_gate2
    jsk, psk, jin, vals, outs = run
    got = outs[0]["and"]
    _same(got, gates.gate2("AND", _port(jin["x"]), _port(jin["y"]), psk.cloud))
    assert len(jax.devices()) >= 8
    _same(got, j_sharded_gate2("AND", jin["x"], jin["y"], jsk.cloud, j_make_mesh(8)))
    np.testing.assert_array_equal(pt.decrypt_bits(psk, _lwe(got)), vals["bits"][0] & vals["bits"][1])


def test_sharded_bootstrap_step_matches_one_process(run):
    jsk, psk, jin, vals, outs = run
    _same(outs[0]["boot"], bs.bootstrap(_port(jin["x"]), gates.MU, psk.cloud))


@pytest.mark.parametrize("name,key", [("XOR", "tp_xor"), ("AND", "tp_and")])
def test_dp_ks_gate_matches_tfhe_tpu(run, name, key):
    """dp 2 x ks 2 against tfhe_tpu's dp 2 x ks 4: the same key switch split
    differently, the same bytes (the worst-case cv of ks_finalize(nnz=None))."""
    from tfhe_tpu.parallel.mesh import make_mesh2d_dp_ks as j_mesh, sharded_gate2_tp_ks as j_tp
    jsk, psk, jin, vals, outs = run
    got = outs[0][key]
    _same(got, j_tp(name, jin["x"], jin["y"], jsk.cloud, j_mesh(2, 4)))
    want = {"XOR": np.bitwise_xor, "AND": np.bitwise_and}[name](*vals["bits"])
    np.testing.assert_array_equal(pt.decrypt_bits(psk, _lwe(got)), want)


@pytest.mark.parametrize("nbits", [4, 8])
def test_sharded_circuit_matches_one_process(run, nbits):
    jsk, psk, jin, vals, outs = run
    a, b = f"m{nbits}a", f"m{nbits}b"
    got = outs[0][f"mul{nbits}"]
    _same(got, arith.mul(_port(jin[a]), _port(jin[b]), psk.cloud))
    want = (vals[f"m{nbits}"][0] * vals[f"m{nbits}"][1]) % (1 << nbits)
    np.testing.assert_array_equal(arith.decrypt_int(psk, _lwe(got), signed=False), want)


def _cannon_one_process(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """The schedule of cannon_matmul_mesh on the stacked [d, d] batch in one
    process: the skew, then d rounds of arith.mul and arith.add with the
    rows rolled left and the columns up by one between rounds."""
    d = a.batch_shape[0]
    ii, jj = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")

    def take(ct, rows, cols):
        r, c = torch.from_numpy(rows), torch.from_numpy(cols)
        return LweCiphertext(ct.a[r, c], ct.b[r, c], ct.cv[r, c])

    a_sk, b_sk = take(a, ii, (jj + ii) % d), take(b, (ii + jj) % d, jj)
    acc = None
    for r in range(d):
        prod = arith.mul(a_sk, b_sk, cloud)
        acc = prod if acc is None else arith.add(acc, prod, cloud)
        a_sk, b_sk = take(a_sk, ii, (jj + 1) % d), take(b_sk, (ii + 1) % d, jj)
    return acc


def test_cannon_matches_one_process_and_numpy(run):
    jsk, psk, jin, vals, outs = run
    got = outs[0]["cannon"]
    _same(got, _cannon_one_process(_port(jin["ca"]), _port(jin["cb"]), psk.cloud))
    np.testing.assert_array_equal(arith.decrypt_int(psk, _lwe(got)), CANNON_A @ CANNON_B)


@pytest.mark.slow
def test_cannon_matches_tfhe_tpu(run):
    from tfhe_tpu.parallel.cannon import cannon_matmul_mesh, make_mesh2d
    jsk, psk, jin, vals, outs = run
    _same(outs[0]["cannon"], cannon_matmul_mesh(jin["ca"], jin["cb"], jsk.cloud, make_mesh2d(2)))


def test_ks_finalize_worst_case_matches_tfhe_tpu():
    """Without digit counts ks_finalize charges n_extract * t key-switch
    variances, as tfhe_tpu's does (the call of the sharded key switch)."""
    import jax.numpy as jnp
    from tfhe_tpu.core import bootstrap as jbs
    params = pt.PARAMS_SMALL_NOISY
    rng = np.random.RandomState(4)
    Bn, C4 = 5, 4 * 128
    sums = rng.randint(-2 ** 20, 2 ** 20, size=(Bn, C4)).astype(np.int32)
    b_ext = rng.randint(-2 ** 31, 2 ** 31, size=Bn).astype(np.int32)
    cv = rng.rand(Bn).astype(np.float32) * 1e-6
    got = bs.ks_finalize(torch.from_numpy(sums), torch.from_numpy(b_ext),
                         torch.from_numpy(cv), params)
    want = jbs.ks_finalize(jnp.asarray(sums), jnp.asarray(b_ext), jnp.asarray(cv), params)
    _same(_np(got), want)
    assert (got.cv.numpy() > cv + 0.5 * params.n_extract * params.ks_t
            * params.ks_stdev ** 2).all()


def test_mesh_rejects_what_does_not_divide():
    """A batch that does not divide over the ranks, and a grid larger than
    the world, raise before any traffic (one rank, gloo, on the CPU)."""
    outs = dryrun.run(1, _one_rank_errors, device="cpu", threads=1)
    assert outs == [["batch", "grid"]]


def _one_rank_errors(rank, world, device):
    from tfhe_tpu_torch.parallel.mesh import make_mesh, make_mesh2d_dp_ks, _slice_ct
    seen = []
    mesh = make_mesh(1, device=device)
    x = LweCiphertext(torch.zeros((3, 4), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3))
    try:
        _slice_ct(x, 0, 2)
    except ValueError:
        seen.append("batch")
    try:
        make_mesh2d_dp_ks(2, 2, device=device)
    except ValueError:
        seen.append("grid")
    assert mesh.coords == (0,)
    return seen


@pytest.mark.slow
def test_dryrun_world8_every_shape():
    """The six shapes of the dry run at world 8 on the CPU, PARAMS_110 included."""
    lines = dryrun.run(8, dryrun.dryrun_multichip, device="cpu")[0]
    assert len(lines) == 6 and all(line.endswith("values OK") for line in lines), lines


def test_dryrun_world4_small_shapes():
    """The dry run's first three shapes over 4 ranks; the whole-circuit
    multiply and the shapes at PARAMS_110 are the slow test above."""
    lines = dryrun.run(WORLD, dryrun.dryrun_multichip, (1, 2, 3), device="cpu", threads=1)[0]
    assert [line[:11] for line in lines] == ["dryrun[1/6]", "dryrun[2/6]", "dryrun[3/6]"]
    assert all(line.endswith("values OK") for line in lines), lines
