"""ctypes bindings for the native C++ exact TFHE engine (``native/tfhe_ref.cpp``).

Port of ``tfhe_tpu.native_ref``. The shared library is built with g++
(-O3 -fopenmp) from the repository's source into ``build/tfhe_tpu_torch/`` at
first use, and runs the bootstrap, the 2-input gates and the ripple adder on
numpy arrays with the host keys of the port's ``SecretKeySet``. It is the
host-side twin of the reference's CPU framework (``cpuParallel/``): code that
is neither the port's nor ``tfhe_tpu``'s, which the port's plain path and
kernels must equal byte for byte.
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
                    "native", "tfhe_ref.cpp")
_SO = os.path.join(BUILD_DIR, "libtfhe_ref.so")


class _ParamsC(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int32), ("N", ctypes.c_int32), ("k", ctypes.c_int32),
                ("l", ctypes.c_int32), ("Bgbit", ctypes.c_int32),
                ("basebit", ctypes.c_int32), ("t", ctypes.c_int32)]


def build(force: bool = False) -> str:
    """Compile the library unless an up-to-date one exists; returns its path.
    Writes to a temporary name and renames, so concurrent builders never see
    a partial file."""
    if not force and os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
                        "-std=c++17", _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.tfhe_polymul.argtypes = [i32p, i32p, i32p, ctypes.c_int]
    lib.tfhe_polymul.restype = None
    lib.tfhe_bootstrap_batch.argtypes = [
        ctypes.POINTER(_ParamsC), i32p, i32p, ctypes.c_int32, i32p, i32p, i32p,
        ctypes.c_int, i32p, i32p]
    lib.tfhe_bootstrap_batch.restype = None
    lib.tfhe_gate2_batch.argtypes = [
        ctypes.POINTER(_ParamsC), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, ctypes.c_int32, i32p, i32p, i32p,
        ctypes.c_int, i32p, i32p]
    lib.tfhe_gate2_batch.restype = None
    lib.tfhe_ripple_add.argtypes = [
        ctypes.POINTER(_ParamsC), i32p, i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, i32p]
    lib.tfhe_ripple_add.restype = None
    lib.tfhe_native_num_threads.argtypes = []
    lib.tfhe_native_num_threads.restype = ctypes.c_int
    return lib


def _pc(params: TfheParams) -> _ParamsC:
    return _ParamsC(params.n, params.N, params.k, params.bk_l, params.bk_Bgbit,
                    params.ks_basebit, params.ks_t)


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int32)


def _keys(sk):
    """The host keys the library reads, checked against the parameter set."""
    p = sk.params
    bk, ks_a, ks_b = _i32(sk.bk_raw), _i32(sk.ks_a), _i32(sk.ks_b)
    want = {"bk_raw": (p.n, p.kpl, p.k + 1, p.N),
            "ks_a": (p.n_extract, p.ks_t, p.ks_base, p.n),
            "ks_b": (p.n_extract, p.ks_t, p.ks_base)}
    for name, arr in (("bk_raw", bk), ("ks_a", ks_a), ("ks_b", ks_b)):
        if arr.shape != want[name]:
            raise ValueError(f"{name}: want shape {want[name]}, got {arr.shape}")
    return bk, ks_a, ks_b


def _samples(params: TfheParams, a, b, lead: tuple):
    a, b = _i32(a), _i32(b)
    if a.shape != lead + (params.n,) or b.shape != lead:
        raise ValueError(f"samples: want a{list(lead + (params.n,))} and b{list(lead)}, "
                         f"got a{list(a.shape)} and b{list(b.shape)}")
    return a, b


def polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of small-integer a and Torus32 b (length N)."""
    a, b = _i32(a), _i32(b)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"polymul: want two int32[N], got {a.shape} and {b.shape}")
    out = np.empty(a.shape[0], np.int32)
    _lib().tfhe_polymul(a, b, out, a.shape[0])
    return out


def bootstrap_batch(sk, in_a: np.ndarray, in_b: np.ndarray, mu: int) -> tuple:
    """Exact batched gate bootstrap with the host keys of a SecretKeySet:
    (a int32[B, n], b int32[B])."""
    params = sk.params
    batch = np.shape(in_b)[0]
    in_a, in_b = _samples(params, in_a, in_b, (batch,))
    bk, ks_a, ks_b = _keys(sk)
    out_a = np.empty((batch, params.n), np.int32)
    out_b = np.empty(batch, np.int32)
    p = _pc(params)
    _lib().tfhe_bootstrap_batch(ctypes.byref(p), in_a, in_b, np.int32(mu), bk, ks_a, ks_b,
                                batch, out_a, out_b)
    return out_a, out_b


def gate2_batch(sk, name: str, xa, xb, ya, yb) -> tuple:
    """A batch of bootstrapped 2-input gates (the gate table of
    ``tfhe_tpu_torch.gates``)."""
    from .gates import GATE_TABLE, MU
    const, ca, cb = GATE_TABLE[name]
    params = sk.params
    batch = np.shape(xb)[0]
    xa, xb = _samples(params, xa, xb, (batch,))
    ya, yb = _samples(params, ya, yb, (batch,))
    bk, ks_a, ks_b = _keys(sk)
    out_a = np.empty((batch, params.n), np.int32)
    out_b = np.empty(batch, np.int32)
    p = _pc(params)
    _lib().tfhe_gate2_batch(ctypes.byref(p), np.int32(const), np.int32(ca), np.int32(cb),
                            xa, xb, ya, yb, np.int32(MU), bk, ks_a, ks_b, batch, out_a, out_b)
    return out_a, out_b


def ripple_add(sk, xa, xb, ya, yb) -> tuple:
    """n-bit ripple-carry addition of encrypted integer batches (the twin of
    cpuParallel's Cipher::operator+). xa: [batch, nbits, n]; xb: [batch, nbits]."""
    params = sk.params
    batch, nbits = np.shape(xb)
    xa, xb = _samples(params, xa, xb, (batch, nbits))
    ya, yb = _samples(params, ya, yb, (batch, nbits))
    bk, ks_a, ks_b = _keys(sk)
    out_a = np.empty((batch, nbits, params.n), np.int32)
    out_b = np.empty((batch, nbits), np.int32)
    p = _pc(params)
    _lib().tfhe_ripple_add(ctypes.byref(p), xa, xb, ya, yb, nbits, batch, bk, ks_a, ks_b,
                           out_a, out_b)
    return out_a, out_b


def num_threads() -> int:
    """OpenMP threads the library runs on."""
    return _lib().tfhe_native_num_threads()
