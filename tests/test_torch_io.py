"""tfhe_tpu_torch.io against tfhe_tpu.io and the reference's fixture files.

Every writer of the port gives the bytes tfhe_tpu.io's gives on the same numpy
keys and samples, and each package reads what the other wrote; the importers
build what ``cloud_from_raw`` builds, on the device they are given, and raise
without a card when given none. At PARAMS_110 the reference's keys hash to
tests/fixtures/SHA256SUMS and tests/fixtures/cloud.data decrypts to (2017, 42)."""
import hashlib
import io as pyio
import os

import numpy as np
import pytest
import torch

import tfhe_tpu as jt
from tfhe_tpu import io as jio
import tfhe_tpu_torch as pt
from tfhe_tpu_torch import io as tio
from tfhe_tpu_torch.core import keys
from tfhe_tpu_torch.core.crypt import decrypt_bits
from torch_parity import assert_same, port_keys, to_torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXED = os.path.join(os.path.dirname(__file__), "fixtures")
RNG = np.random.RandomState(5)


def _i32(*shape):
    return RNG.randint(-2 ** 31, 2 ** 31, size=shape).astype(np.int32)


# writer -> (arguments after the stream, reader, the reader's arguments after the stream)
PARTS = {
    "lwe_params": ((500, 2.44e-5, 0.012467), "read_lwe_params", ()),
    "tlwe_params": ((1024, 1, 7.18e-9, 0.012467), "read_tlwe_params", ()),
    "gate_bootstrapping_params": ((pt.PARAMS_110,), "read_gate_bootstrapping_params", ()),
    "lwe_sample": ((_i32(16), -77, 0.25), "read_lwe_sample", (16,)),
    "tlwe_sample": ((_i32(2, 128), 1e-9), "read_tlwe_sample", (1, 128)),
    "tgsw_sample": ((_i32(4, 2, 128), 2e-9), "read_tgsw_sample", (4, 1, 128)),
    "tlwe_key_content": ((_i32(1, 128),), "read_tlwe_key_content", (1, 128)),
    "lwe_key_content": ((_i32(16),), "read_lwe_key_content", (16,)),
    "tgsw_key_content": ((_i32(1, 128),), "read_tgsw_key_content", (1, 128)),
    "keyswitch_key_content": ((_i32(128, 8, 4, 16), _i32(128, 8, 4), 1e-10),
                              "read_keyswitch_key_content", (128, 8, 4, 16)),
    "bootstrapping_key_content": ((_i32(16, 4, 2, 128), 1e-12),
                                  "read_bootstrapping_key_content", (16, 4, 1, 128)),
}


def _args(package, args):
    """TfheParams arguments as the package's own class (same fields)."""
    cls = jt.TfheParams if package is jio else pt.TfheParams
    return [cls(**{f: getattr(a, f) for f in a.__dataclass_fields__})
            if hasattr(a, "__dataclass_fields__") else a for a in args]


def _written(package, name, args) -> bytes:
    buf = pyio.BytesIO()
    getattr(package, "write_" + name)(buf, *_args(package, args))
    return buf.getvalue()


def _flat(value):
    """What a reader returned, as a list of numpy arrays and numbers."""
    if hasattr(value, "__dataclass_fields__"):
        return [getattr(value, f) for f in value.__dataclass_fields__]
    return [np.asarray(v) for v in (value if isinstance(value, tuple) else (value,))]


@pytest.mark.parametrize("name", list(PARTS))
def test_part_bytes_and_cross_reads(name):
    """The port's writer and tfhe_tpu's give the same bytes, and each reader
    reads the other's bytes back to the same values."""
    args, reader, rargs = PARTS[name]
    mine, theirs = _written(tio, name, args), _written(jio, name, args)
    assert mine == theirs
    got = getattr(tio, reader)(pyio.BytesIO(theirs), *rargs)
    want = getattr(jio, reader)(pyio.BytesIO(mine), *rargs)
    for g, w in zip(_flat(got), _flat(want), strict=True):
        np.testing.assert_array_equal(g, w)


def test_wrong_uid_and_short_file_raise():
    data = _written(tio, "lwe_key_content", (_i32(16),))
    with pytest.raises(ValueError, match="type UID"):
        tio.read_tlwe_key_content(pyio.BytesIO(data), 1, 16)
    with pytest.raises(EOFError):
        tio.read_lwe_key_content(pyio.BytesIO(data[:-4]), 16)
    with pytest.raises(EOFError):
        tio.import_ciphertexts(pyio.BytesIO(b"\x00" * 10), 1, 16, "cpu")
    with pytest.raises(ValueError, match="UID"):
        tio.import_ciphertexts(pyio.BytesIO(b"\x00" * (4 + 64 + 4 + 8)), 1, 16, "cpu")


@pytest.fixture(scope="module")
def toy(toy_keys):
    return toy_keys, port_keys(toy_keys, pt.PARAMS_TOY)


@pytest.mark.parametrize("which", ["secret", "cloud"])
def test_keyset_files(toy, which):
    """export_*_keyset byte-equal to tfhe_tpu's; each importer reads the
    other's file; import_cloud_keyset gives the tensors cloud_from_raw gives."""
    jsk, psk = toy
    mine, theirs = pyio.BytesIO(), pyio.BytesIO()
    getattr(tio, f"export_{which}_keyset")(mine, psk)
    getattr(jio, f"export_{which}_keyset")(theirs, jsk)
    assert mine.getvalue() == theirs.getvalue()
    mine.seek(0), theirs.seek(0)
    if which == "secret":
        got, want = tio.import_secret_keyset(theirs, "cpu"), jio.import_secret_keyset(mine)
        for f in ("lwe_key", "tlwe_key", "bk_raw", "ks_a", "ks_b"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
            np.testing.assert_array_equal(getattr(got, f), getattr(psk, f))
        params, cloud, jcloud = got.params, got.cloud, want.cloud
    else:
        (params, cloud), (jparams, jcloud) = (tio.import_cloud_keyset(theirs, "cpu"),
                                             jio.import_cloud_keyset(mine))
        assert params.n == jparams.n and params.ks_stdev == jparams.ks_stdev
    assert params == pt.PARAMS_TOY
    ref = keys.cloud_from_raw(pt.PARAMS_TOY, psk.bk_raw, psk.ks_a, psk.ks_b, "cpu")
    for f in ("bk_ntt", "bk_ntt_shoup", "bk_rows", "bk_rows_shoup", "ks_table", "ks_table_perm"):
        assert torch.equal(getattr(cloud, f), getattr(ref, f)), f
    np.testing.assert_array_equal(cloud.bk_ntt.numpy(), np.asarray(jcloud.bk_ntt))
    np.testing.assert_array_equal(cloud.ks_table.numpy(), np.asarray(jcloud.ks_table))


def test_ciphertext_files(toy):
    """A batch with a leading shape and a nonzero cv: same bytes as tfhe_tpu
    writes sample by sample, and each importer reads the other's file."""
    jsk, psk = toy
    jct = jt.encrypt_bits(jsk, RNG.randint(0, 2, size=(3, 4)).astype(np.int32), seed=3)
    jct = type(jct)(jct.a, jct.b, jct.cv + np.float32(1.5e-9))
    mine, theirs = pyio.BytesIO(), pyio.BytesIO()
    tio.export_ciphertexts(mine, to_torch(jct))
    jio.export_ciphertexts(theirs, jct)
    assert mine.getvalue() == theirs.getvalue()
    assert len(mine.getvalue()) == 12 * (4 + 4 * 16 + 4 + 8)
    mine.seek(0), theirs.seek(0)
    got = tio.import_ciphertexts(theirs, 12, 16, "cpu")
    assert got.a.dtype == torch.int32 and got.cv.dtype == torch.float32
    assert_same(got, jio.import_ciphertexts(mine, 12, 16))
    assert_same(got, jct.reshape(12))
    single = pyio.BytesIO()                     # the per-sample writer gives the same record
    tio.write_lwe_sample(single, got.a[0].numpy(), int(got.b[0]), float(got.cv[0]))
    assert single.getvalue() == mine.getvalue()[:len(single.getvalue())]


def test_importers_default_to_the_card(toy):
    """Without a device and without a card the importers raise before they
    read: nothing is built on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    jsk, psk = toy
    buf = pyio.BytesIO()
    tio.export_secret_keyset(buf, psk)
    for call in (lambda: tio.import_secret_keyset(buf), lambda: tio.import_cloud_keyset(buf),
                 lambda: tio.import_ciphertexts(buf, 1, 16)):
        buf.seek(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        assert buf.tell() == 0


def _sums():
    with open(os.path.join(FIXED, "SHA256SUMS")) as f:
        return {name: digest for digest, name in (line.split() for line in f)}


def test_reference_fixture():
    """The reference's keys at PARAMS_110, written by the port, hash to the
    committed pins of secret.key and cloud.key; the committed cloud.data
    imports and decrypts to the reference app's operands (2017, 42)."""
    sk = pt.keygen_reference(pt.PARAMS_110, device="cpu")
    sums = _sums()
    for name, export in (("secret.key", tio.export_secret_keyset),
                         ("cloud.key", tio.export_cloud_keyset)):
        buf = pyio.BytesIO()
        export(buf, sk)
        assert hashlib.sha256(buf.getvalue()).hexdigest() == sums[name], name
    with open(os.path.join(FIXED, "cloud.data"), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == sums["cloud.data"]
    ct = tio.import_ciphertexts(pyio.BytesIO(data), 32, sk.params.n, "cpu")
    bits = decrypt_bits(sk, ct).astype(np.int64)
    assert [int((bits[i:i + 16] << np.arange(16)).sum()) for i in (0, 16)] == [2017, 42]
    # cv is a double on the wire and float32 in memory
    np.testing.assert_allclose(ct.cv.numpy(), sk.params.ks_stdev ** 2, rtol=1e-6)


def test_io_is_an_attribute_of_the_package():
    """``import tfhe_tpu_torch as tt; tt.io`` works in a fresh interpreter,
    as ``tfhe_tpu.io`` does, without importing the module by name first."""
    import subprocess
    import sys
    code = ("import tfhe_tpu_torch as tt\n"
            "assert tt.io.export_cloud_keyset and tt.io.import_ciphertexts\n"
            "print(tt.io.__name__)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["tfhe_tpu_torch.io"]
