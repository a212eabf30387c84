"""Encryption / decryption of LWE samples and boolean messages.

Port of ``tfhe_tpu.core.crypt`` (`lweSymEncrypt`/`lwePhase`,
lwe-functions.cu:36-97; `bootsSymEncrypt`/`bootsSymDecrypt`,
tfhe_gate_bootstrapping.cu:113-125). Randomness comes from an explicit
``torch.Generator``; it cannot match jax's draws, so ciphertexts are checked
by decryption, and parity tests feed both packages the same numpy inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..numeric import dtot32, mod_switch_to_torus32, uniform_torus32, wrap_i32
from .lwe import LweCiphertext


def _key(sk, device) -> torch.Tensor:
    """The secret LWE key (host numpy) as an int32 tensor on `device`."""
    return torch.tensor(sk.lwe_key, dtype=torch.int32, device=device)


def _dot_i32(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_i a[..., i] * key[i] mod 2^32, as int32."""
    return wrap_i32((a.to(torch.int64) * key.to(torch.int64)).sum(-1))


def lwe_encrypt(message: torch.Tensor, lwe_key: torch.Tensor, alpha: float,
                generator: torch.Generator) -> LweCiphertext:
    """Encrypt Torus32 messages int32[...] under a binary LWE key int32[n]
    (ref lweSymEncrypt, lwe-functions.cu:36-47)."""
    shape = tuple(message.shape)
    a = uniform_torus32(shape + (lwe_key.shape[-1],), generator, message.device)
    b = message
    if alpha > 0.0:
        err = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=message.device) * alpha
        b = b + dtot32(err)
    b = b + _dot_i32(a, lwe_key)
    cv = torch.full(shape, alpha * alpha, dtype=torch.float32, device=message.device)
    return LweCiphertext(a, b, cv)


def lwe_phase(ct: LweCiphertext, lwe_key: torch.Tensor) -> torch.Tensor:
    """phi = b - a.s (ref lwePhase, lwe-functions.cu:72-81)."""
    return ct.b - _dot_i32(ct.a, lwe_key)


def encrypt_bits(sk, bits, generator: torch.Generator, device) -> LweCiphertext:
    """Encrypt boolean messages as +-1/8 (ref bootsSymEncrypt) on `device`;
    `generator` must live on the same device."""
    bits = torch.tensor(np.asarray(bits), dtype=torch.int32, device=device)
    mu = mod_switch_to_torus32(1, 8, device=device)
    msg = torch.where(bits != 0, mu, -mu)
    return lwe_encrypt(msg, _key(sk, device), sk.params.ks_stdev, generator)


def decrypt_phase(sk, ct: LweCiphertext) -> np.ndarray:
    return lwe_phase(ct, _key(sk, ct.device)).cpu().numpy()


def decrypt_bits(sk, ct: LweCiphertext) -> np.ndarray:
    """Decrypt boolean messages: 1 iff phase > 0 (ref bootsSymDecrypt)."""
    return (decrypt_phase(sk, ct) > 0).astype(np.int32)
