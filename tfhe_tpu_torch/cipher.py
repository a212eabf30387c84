"""High-level encrypted-integer API with operator overloads.

Port of ``tfhe_tpu.cipher``: the equivalent of the reference CPU framework's
`Cipher` class (`cpuParallel/Cipher.h:29-69`), an n-bit two's-complement
integer (or a batch of them) with +, -, *, /, comparisons, absolute, minimum
and shifts. Every operation is a batched circuit of ``arith``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import arith, gates
from .core.lwe import LweCiphertext


class CipherInt:
    """An encrypted two's-complement integer batch bound to a cloud key."""

    def __init__(self, ct: LweCiphertext, cloud):
        self.ct = ct
        self.cloud = cloud

    # ---- constructors -------------------------------------------------
    @classmethod
    def encrypt(cls, sk, value, nbits: int, generator: torch.Generator, device) -> "CipherInt":
        return cls(arith.encrypt_int(sk, value, nbits, generator, device), sk.cloud)

    @classmethod
    def trivial(cls, value, nbits: int, cloud) -> "CipherInt":
        """Noiseless encryption of public integers, on the cloud key's device."""
        value = np.asarray(value, np.int64)
        bits = ((value[..., None] >> np.arange(nbits)) & 1).astype(np.int32)
        return cls(gates.CONSTANT(bits, cloud.params.n, bits.shape,
                                  device=cloud.bk_ntt.device), cloud)

    def decrypt(self, sk, signed: bool = True):
        return arith.decrypt_int(sk, self.ct, signed=signed)

    # ---- metadata ------------------------------------------------------
    @property
    def nbits(self) -> int:
        return self.ct.batch_shape[-1]

    @property
    def batch_shape(self):
        return self.ct.batch_shape[:-1]

    def _wrap(self, ct) -> "CipherInt":
        return CipherInt(ct, self.cloud)

    # ---- arithmetic (ref Cipher.cpp operators) -------------------------
    def __add__(self, o: "CipherInt") -> "CipherInt":
        return self._wrap(arith.add(self.ct, o.ct, self.cloud))

    def __sub__(self, o: "CipherInt") -> "CipherInt":
        return self._wrap(arith.sub(self.ct, o.ct, self.cloud))

    def __mul__(self, o: "CipherInt") -> "CipherInt":
        return self._wrap(arith.mul(self.ct, o.ct, self.cloud))

    def __truediv__(self, o: "CipherInt") -> "CipherInt":
        return self._wrap(arith.div(self.ct, o.ct, self.cloud))

    __floordiv__ = __truediv__

    def __neg__(self) -> "CipherInt":
        return self._wrap(arith.twos_complement(self.ct, self.cloud))

    def __lshift__(self, k: int) -> "CipherInt":
        return self._wrap(arith.left_shift(self.ct, k))

    def __rshift__(self, k: int) -> "CipherInt":
        return self._wrap(arith.right_shift_arith(self.ct, k, self.cloud))

    # ---- comparisons (1-bit results, ref Cipher.cpp:597-644) ----------
    def __gt__(self, o: "CipherInt") -> LweCiphertext:
        return arith.gt(self.ct, o.ct, self.cloud)

    def __le__(self, o: "CipherInt") -> LweCiphertext:
        return arith.le(self.ct, o.ct, self.cloud)

    def eq(self, o: "CipherInt") -> LweCiphertext:
        return arith.eq(self.ct, o.ct, self.cloud)

    # ---- misc ----------------------------------------------------------
    def abs(self) -> "CipherInt":
        return self._wrap(arith.absolute(self.ct, self.cloud))

    def minimum(self, o: "CipherInt") -> "CipherInt":
        return self._wrap(arith.minimum(self.ct, o.ct, self.cloud))

    def increment(self) -> "CipherInt":
        """self + 1 (ref Cipher::operator++, Cipher.h:49 / Cipher.cpp:228-242)."""
        value = np.ones(self.batch_shape, np.int64) if self.batch_shape else 1
        return self + CipherInt.trivial(value, self.nbits, self.cloud)

    def __iadd__(self, o: "CipherInt") -> "CipherInt":
        return self + o

    def __isub__(self, o: "CipherInt") -> "CipherInt":
        return self - o
