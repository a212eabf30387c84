"""tfhe_tpu_torch.parallel against the single-process port and tfhe_tpu.parallel.

Four ranks spawned once for the module (gloo on the CPU, one torch thread
each, a file rendezvous in a fresh temporary directory, so that concurrent
test workers never share a port), PARAMS_TOY keys carried in as raw numpy.
Every rank returns the whole result; each must be byte-equal (a, b exact, cv to rtol 1e-6) to
the same computation in one process and to tfhe_tpu's sharded entry points
on the 8-device virtual mesh of tests/conftest.py. The ranks also run the
row-sharded matmul of chip_smoke.py's four-card phase (chip_smoke.matmul_rows
through sharded_circuit) and the collectives alone.

The rank function lives in this module, which imports nothing of JAX at its
top: a spawned rank imports it by name and must stay free of JAX.
"""
import os

import numpy as np
import pytest
import torch

import tfhe_tpu_torch as pt
from tfhe_tpu_torch import arith, gates, linalg
from tfhe_tpu_torch.core import bootstrap as bs
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.lwe import LweCiphertext
from tfhe_tpu_torch.parallel import dryrun
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
B = 16              # the gate batch: divides over 4 ranks and over tfhe_tpu's 8 devices
CANNON_A = np.array([[1, 2], [0, 3]], np.int64)
CANNON_B = np.array([[2, 1], [1, 1]], np.int64)
ROWS_A = np.array([[3, 1], [0, 2], [1, 1], [2, 3]], np.int64)    # 4 x 2: a row a rank
ROWS_B = np.array([[1, 2], [3, 0]], np.int64)                    # 2 x 2, replicated


def _cloud(raw, device):
    return keys.cloud_from_raw(pt.PARAMS_TOY, raw["bk_raw"], raw["ks_a"], raw["ks_b"], device)


def _lwe(arrs, device="cpu") -> LweCiphertext:
    return LweCiphertext(*(torch.from_numpy(np.array(v)).to(device) for v in arrs))


def _np(ct: LweCiphertext) -> tuple:
    return tuple(v.cpu().numpy() for v in (ct.a, ct.b, ct.cv))


def _ranks(rank, world, device, raw, inputs):
    """On each rank: every sharded entry point of the port on the same inputs,
    the row-sharded matmul, the collectives alone, and the rank's
    NCCL_SOCKET_IFNAME."""
    import chip_smoke
    from tfhe_tpu_torch.core.lwe import lwe_stack
    from tfhe_tpu_torch.parallel import mesh as pm
    from tfhe_tpu_torch.parallel.cannon import cannon_matmul_mesh, make_mesh2d
    cloud = _cloud(raw, device)
    ct = {k: _lwe(v, device) for k, v in inputs.items()}
    mesh, dpks, grid = (pm.make_mesh(world, device=device),
                        pm.make_mesh2d_dp_ks(2, 2, device=device), make_mesh2d(2, device=device))
    out = {
        "and": pm.sharded_gate2("AND", ct["x"], ct["y"], cloud, mesh),
        "tp_xor": pm.sharded_gate2_tp_ks("XOR", ct["x"], ct["y"], cloud, dpks),
        "tp_and": pm.sharded_gate2_tp_ks("AND", ct["x"], ct["y"], cloud, dpks),
        "boot": pm.sharded_bootstrap_step(ct["x"], cloud, mesh),
        "mul4": pm.sharded_circuit(arith.mul, (ct["m4a"], ct["m4b"]), cloud, mesh),
        "mul8": pm.sharded_circuit(arith.mul, (ct["m8a"], ct["m8b"]), cloud, mesh),
        "cannon": cannon_matmul_mesh(ct["ca"], ct["cb"], cloud, grid),
        "matmul_rows": pm.sharded_circuit(chip_smoke.matmul_rows,
                                          (ct["ra"], lwe_stack([ct["rb"]] * world)), cloud, mesh),
    }
    mine = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * rank
    coll = {"backend": mesh.backend,
            "gather": pm.all_gather_cat(mine, mesh.group, world, mesh).numpy(),
            "reduce": pm.all_reduce_sum(mine.clone(), mesh.group, mesh).numpy(),
            "cv": pm.all_gather_cat(torch.full((2,), 0.5 + rank), mesh.group, world,
                                    mesh).numpy()}
    return {**{k: _np(v) for k, v in out.items()}, "coll": coll,
            "ifname": os.environ.get("NCCL_SOCKET_IFNAME")}


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
           "cb": ja.encrypt_int(toy_keys, CANNON_B, 4, seed=64),
           "ra": ja.encrypt_int(toy_keys, ROWS_A, 4, seed=65),
           "rb": ja.encrypt_int(toy_keys, ROWS_B, 4, seed=66)}
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


@pytest.mark.parametrize("key", ["and", "tp_xor", "tp_and", "boot", "mul4", "mul8", "cannon",
                                 "matmul_rows"])
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


def test_row_sharded_matmul_matches_one_process_and_tfhe_tpu(run):
    """a's rows over the ranks, b replicated (a copy a rank stacked on a new
    leading axis), chip_smoke.matmul_rows through sharded_circuit: the
    one-process linalg.matmul of the port and of tfhe_tpu, byte for byte."""
    from tfhe_tpu import linalg as jl
    jsk, psk, jin, vals, outs = run
    got = outs[0]["matmul_rows"]
    _same(got, linalg.matmul(_port(jin["ra"]), _port(jin["rb"]), psk.cloud))
    _same(got, jl.matmul(jin["ra"], jin["rb"], jsk.cloud))
    np.testing.assert_array_equal(arith.decrypt_int(psk, _lwe(got), signed=False),
                                  (ROWS_A @ ROWS_B) % 16)


def test_collectives_gather_and_sum_the_ranks_tensors(run):
    """On the gloo ranks, all_gather_cat (one buffer, the form NCCL takes
    too) gives the ranks' tensors in rank order, int32 and float32, and
    all_reduce_sum their sum."""
    want = np.concatenate([np.arange(6, dtype=np.int32).reshape(2, 3) + 100 * r
                           for r in range(WORLD)])
    for r, out in enumerate(run[-1]):
        coll = out["coll"]
        assert coll["backend"] == "gloo"
        np.testing.assert_array_equal(coll["gather"], want)
        np.testing.assert_array_equal(coll["reduce"], want.reshape(WORLD, 2, 3).sum(0))
        np.testing.assert_array_equal(coll["cv"], np.repeat(0.5 + np.arange(WORLD), 2))


class _CardTensor:
    """A stand-in for a contiguous CUDA tensor: it records a copy to the host."""
    device = torch.device("cuda", 0)

    def __init__(self):
        self.to_host = 0

    def cpu(self):
        self.to_host += 1
        return self

    def contiguous(self):
        return self


def test_nccl_with_a_card_a_rank_and_no_host_copy(monkeypatch):
    """With four cards visible, four ranks on cuda devices take NCCL; more
    ranks than cards, or the CPU, take gloo. Under NCCL a collective takes
    the card's tensor itself; under gloo it goes through the host."""
    from tfhe_tpu_torch.parallel import mesh as pm
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pm.pick_backend(torch.device("cuda", 3), 4) == "nccl"
    assert pm.pick_backend(torch.device("cuda", 0), 8) == "gloo"
    assert pm.pick_backend(torch.device("cpu"), 4) == "gloo"
    on_card = pm.Mesh(shape=(4,), axis_names=("dp",), ranks=(0, 1, 2, 3), coords=(0,),
                      device=torch.device("cuda", 0), backend="nccl")
    t = _CardTensor()
    assert pm._host(t, on_card) is t and t.to_host == 0
    shared = pm.Mesh(shape=(4,), axis_names=("dp",), ranks=(0, 1, 2, 3), coords=(0,),
                     device=torch.device("cuda", 0), backend="gloo")
    pm._host(t, shared)
    assert t.to_host == 1


def test_ranks_name_the_loopback_only_where_unset(run):
    """A rank sets NCCL_SOCKET_IFNAME=lo where its environment has none, and
    keeps an interface the environment names."""
    env = {}
    dryrun.rank_environ(env)
    assert env == {"NCCL_SOCKET_IFNAME": "lo"}
    env = {"NCCL_SOCKET_IFNAME": "eth7"}
    dryrun.rank_environ(env)
    assert env == {"NCCL_SOCKET_IFNAME": "eth7"}
    want = os.environ.get("NCCL_SOCKET_IFNAME", "lo")
    assert [out["ifname"] for out in run[-1]] == [want] * WORLD


def test_chip_smoke_refuses_more_cards_than_visible(monkeypatch):
    """--cards 4 is refused where fewer cards are visible, before any phase;
    the default is one card; no count other than 1 and 4 is taken."""
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--cards", "4"])
    assert chip_smoke.parse_args([]).cards == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert chip_smoke.parse_args(["--cards", "4"]).cards == 4
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--cards", "2"])


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
