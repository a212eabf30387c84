"""The reference's own code as a live oracle (ctypes over libref_oracle.so).

Port of ``tfhe_tpu.ref_oracle``. The library is compiled from the
reference's own CPU translation units, read in place from ``config.ref_dir``
(native/Makefile with native/strip_cuda.py): keygen, encryption, the non-FFT
bootstrap over exact-integer Karatsuba multiplication, gates, MUX and the
wire-format writers, as the reference's authors wrote them. It keeps one
global keyset per process (as the reference apps' single PRNG stream);
``init`` is idempotent for a fixed seed. Without the reference checkout
``available()`` is False and nothing here can run.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

from .ops._build import BUILD_DIR

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_OBJ_DIR = os.path.join(BUILD_DIR, "ref")
_SO = os.path.join(BUILD_DIR, "libref_oracle.so")
# the reference's translation units of native/Makefile's REF_TUS
_REF_TUS = ("numeric-functions", "lwe-functions", "multiplication",
            "toruspolynomial-functions", "tlwe-functions", "tgsw-functions",
            "lwe-keyswitch-functions", "lwe", "lwe-bootstrapping-functions",
            "tlwe", "tgsw", "lwekey", "lweparams", "lwesamples",
            "lwebootstrappingkey", "lwekeyswitch", "tfhe_garbage_collector",
            "tfhe_gate_bootstrapping", "tfhe_gate_bootstrapping_structures",
            "autogenerated", "tfhe_io", "tfhe_generic_streams")

N_LWE, N_POLY, K, KPL, KS_T, KS_BASE = 500, 1024, 1, 4, 8, 4


def available() -> bool:
    """True if the reference checkout (``config.ref_dir``, the REF_DIR that
    native/Makefile reads) or an already built library exists."""
    from .config import ref_dir
    return os.path.isdir(ref_dir()) or os.path.exists(_SO)


def build(force: bool = False) -> str:
    """Compile the reference's translation units and the oracle's entry points
    with native/Makefile into ``build/tfhe_tpu_torch/ref/`` and link them into
    ``build/tfhe_tpu_torch/libref_oracle.so``; returns its path."""
    if force or not os.path.exists(_SO):
        from .config import ref_dir
        objs = [os.path.join(_OBJ_DIR, f"{tu}.o") for tu in _REF_TUS + ("ref_oracle",)]
        subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={_OBJ_DIR}", f"REF_DIR={ref_dir()}",
                        *objs], check=True, capture_output=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-shared", *objs, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _SO


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build())
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes
    lib.ro_init.argtypes = [c.c_uint32, c.c_uint32, c.c_uint32]
    lib.ro_get_lwe_key.argtypes = [i32p]
    lib.ro_get_tlwe_key.argtypes = [i32p]
    lib.ro_get_bk.argtypes = [i32p]
    lib.ro_get_ks.argtypes = [i32p, i32p]
    lib.ro_encrypt_bits.argtypes = [i32p, c.c_int, i32p, i32p]
    lib.ro_decrypt.argtypes = [i32p, c.c_int32]
    lib.ro_bootstrap.argtypes = [i32p, c.c_int32, c.c_int32, i32p, c.POINTER(c.c_int32)]
    lib.ro_bootstrap_woks.argtypes = [i32p, c.c_int32, c.c_int32, i32p, c.POINTER(c.c_int32)]
    lib.ro_keyswitch.argtypes = [i32p, c.c_int32, i32p, c.POINTER(c.c_int32)]
    lib.ro_gate.argtypes = [c.c_int, i32p, c.c_int32, i32p, c.c_int32, i32p,
                            c.POINTER(c.c_int32)]
    lib.ro_mux.argtypes = [i32p, c.c_int32, i32p, c.c_int32, i32p, c.c_int32,
                           i32p, c.POINTER(c.c_int32)]
    lib.ro_write_keyset_files.argtypes = [c.c_char_p, c.c_char_p]
    lib.ro_write_ciphertexts.argtypes = [c.c_char_p, i32p, i32p, c.c_int]
    return lib


def init(seed=(314, 1592, 657)) -> None:
    """Reference params(110) + seed + keygen (idempotent per process)."""
    _lib().ro_init(*(int(s) & 0xFFFFFFFF for s in seed))


def get_keys():
    """Raw key material straight from the reference's keygen code.

    Returns (lwe_key[500], tlwe_key[1,1024], ks_a[1024,8,4,500],
    ks_b[1024,8,4], bk_raw[500,4,2,1024]) — the same layout as
    ref_keygen.keygen_raw for direct comparison."""
    lib = _lib()
    lwe_key = np.empty(N_LWE, np.int32)
    tlwe_key = np.empty(K * N_POLY, np.int32)
    bk = np.empty((N_LWE, KPL, K + 1, N_POLY), np.int32)
    ks_a = np.empty((K * N_POLY, KS_T, KS_BASE, N_LWE), np.int32)
    ks_b = np.empty((K * N_POLY, KS_T, KS_BASE), np.int32)
    lib.ro_get_lwe_key(lwe_key)
    lib.ro_get_tlwe_key(tlwe_key)
    lib.ro_get_bk(bk.reshape(-1))
    lib.ro_get_ks(ks_a.reshape(-1), ks_b.reshape(-1))
    return lwe_key, tlwe_key.reshape(K, N_POLY), ks_a, ks_b, bk


def encrypt_bits(bits) -> tuple:
    """bootsSymEncrypt via reference code, continuing the global PRNG stream."""
    bits = np.ascontiguousarray(bits, np.int32)
    nb = bits.shape[0]
    a = np.empty((nb, N_LWE), np.int32)
    b = np.empty(nb, np.int32)
    _lib().ro_encrypt_bits(bits, nb, a, b)
    return a, b


def decrypt(a: np.ndarray, b: int) -> int:
    return int(_lib().ro_decrypt(np.ascontiguousarray(a, np.int32), int(b)))


def bootstrap(a: np.ndarray, b: int, mu: int) -> tuple:
    out_a = np.empty(N_LWE, np.int32)
    out_b = ctypes.c_int32()
    _lib().ro_bootstrap(np.ascontiguousarray(a, np.int32), int(b), int(mu),
                        out_a, ctypes.byref(out_b))
    return out_a, int(out_b.value)


def bootstrap_woks(a: np.ndarray, b: int, mu: int) -> tuple:
    out_a = np.empty(K * N_POLY, np.int32)
    out_b = ctypes.c_int32()
    _lib().ro_bootstrap_woks(np.ascontiguousarray(a, np.int32), int(b), int(mu),
                             out_a, ctypes.byref(out_b))
    return out_a, int(out_b.value)


def keyswitch(a_ext: np.ndarray, b_ext: int) -> tuple:
    out_a = np.empty(N_LWE, np.int32)
    out_b = ctypes.c_int32()
    _lib().ro_keyswitch(np.ascontiguousarray(a_ext, np.int32), int(b_ext),
                        out_a, ctypes.byref(out_b))
    return out_a, int(out_b.value)


GATE_OPS = {"AND": 0, "OR": 1, "XOR": 2, "NAND": 3, "NOR": 4, "XNOR": 5}


def gate(name: str, a1, b1, a2, b2) -> tuple:
    """Reference gate: affine (boot-gates.cu constants) + non-FFT bootstrap."""
    out_a = np.empty(N_LWE, np.int32)
    out_b = ctypes.c_int32()
    _lib().ro_gate(GATE_OPS[name],
                   np.ascontiguousarray(a1, np.int32), int(b1),
                   np.ascontiguousarray(a2, np.int32), int(b2),
                   out_a, ctypes.byref(out_b))
    return out_a, int(out_b.value)


def mux(aa, ab, ba, bb, ca, cb) -> tuple:
    out_a = np.empty(N_LWE, np.int32)
    out_b = ctypes.c_int32()
    _lib().ro_mux(np.ascontiguousarray(aa, np.int32), int(ab),
                  np.ascontiguousarray(ba, np.int32), int(bb),
                  np.ascontiguousarray(ca, np.int32), int(cb),
                  out_a, ctypes.byref(out_b))
    return out_a, int(out_b.value)


def write_keyset_files(secret_path: str, cloud_path: str) -> None:
    rc = _lib().ro_write_keyset_files(secret_path.encode(), cloud_path.encode())
    if rc != 0:
        raise OSError(f"reference serializer failed writing {secret_path!r}/{cloud_path!r}")


def write_ciphertexts(path: str, a: np.ndarray, b: np.ndarray) -> None:
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    rc = _lib().ro_write_ciphertexts(path.encode(), a.reshape(-1), b, b.shape[0])
    if rc != 0:
        raise OSError(f"reference serializer failed writing {path!r}")
