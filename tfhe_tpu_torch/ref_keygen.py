"""Reference-PRNG key generation (ctypes over ``native/ref_fixtures.cpp``).

Reproduces, draw for draw, the reference's `std::default_random_engine`
keygen seeded with `{314,1592,657}` (`gpuParallel/main.cu:2724-2726`), so the
keys at the reference parameter set are byte-identical to the reference's
and to ``tfhe_tpu``'s. The library is built with g++ from the repository's
source into ``build/tfhe_tpu_torch/`` at first use.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

from .ops._build import BUILD_DIR
from .params import TfheParams

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "ref_fixtures.cpp")
_SO = os.path.join(BUILD_DIR, "libref_fixtures.so")

# the parameter set hard-wired into the reference (tfhe_gate_bootstrapping.cu:25-49)
_REF_SHAPE = dict(n=500, N=1024, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8)


def params_match_reference(params: TfheParams) -> bool:
    return all(getattr(params, f) == v for f, v in _REF_SHAPE.items())


def build() -> str:
    """Compile the shared library unless an up-to-date one exists. Writes to a
    temporary name and renames, so concurrent builders never see a partial file."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                        "-DREF_FIXTURES_SHARED", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.ref_keygen_fill.argtypes = [u32p, ctypes.c_int, i32p, i32p, i32p, i32p, i32p]
    lib.ref_keygen_fill.restype = None
    lib.ref_encrypt_bits.argtypes = [i32p, i32p, ctypes.c_int, i32p, i32p]
    lib.ref_encrypt_bits.restype = None
    return lib


def keygen_raw(seed=(314, 1592, 657)):
    """Run the reference keygen; returns numpy
    (lwe_key[500], tlwe_key[1,1024], ks_a[1024,8,4,500], ks_b[1024,8,4],
    bk_raw[500,4,2,1024])."""
    n, N, k = 500, 1024, 1
    t, base, kpl = 8, 4, 4
    lwe_key = np.empty(n, np.int32)
    tlwe_key = np.empty(k * N, np.int32)
    ks_a = np.empty((k * N, t, base, n), np.int32)
    ks_b = np.empty((k * N, t, base), np.int32)
    bk = np.empty((n, kpl, k + 1, N), np.int32)
    s = np.ascontiguousarray(seed, np.uint32)
    _lib().ref_keygen_fill(s, len(s), lwe_key, tlwe_key,
                           ks_a.reshape(-1), ks_b.reshape(-1), bk.reshape(-1))
    return lwe_key, tlwe_key.reshape(k, N), ks_a, ks_b, bk


def encrypt_bits(lwe_key: np.ndarray, bits):
    """bootsSymEncrypt of a bit vector, continuing the PRNG stream that the
    last keygen_raw left (the reference apps' encrypt order,
    cpuParallel/main.cpp:42-51). Returns (a[nbits,500], b[nbits])."""
    bits = np.ascontiguousarray(bits, np.int32)
    nbits = bits.shape[0]
    a = np.empty((nbits, 500), np.int32)
    b = np.empty(nbits, np.int32)
    _lib().ref_encrypt_bits(np.ascontiguousarray(lwe_key, np.int32), bits, nbits, a, b)
    return a, b
