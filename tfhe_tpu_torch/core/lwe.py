"""LWE ciphertext container and sample algebra on torch tensors (batched, SoA).

Port of ``tfhe_tpu.core.lwe``: the reference's coalesced
`LweSample_16 {int* a; int* b; double* cv}` (`gpuParallel/lwesamples.h:9-13`)
as a dataclass of tensors with an arbitrary leading batch shape. The algebra
ports `gpuParallel/lwe-functions.cu:100-296` with int32 wrap semantics.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LweCiphertext:
    """Batch of LWE samples. a: int32[..., n], b: int32[...], cv: float32[...]."""
    a: torch.Tensor
    b: torch.Tensor
    cv: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.b.shape)

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.b.device

    def to(self, device) -> "LweCiphertext":
        return LweCiphertext(self.a.to(device), self.b.to(device), self.cv.to(device))

    def __getitem__(self, idx) -> "LweCiphertext":
        """Index the batch shape; the trailing LWE dimension of `a` is kept."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        a_idx = idx + (slice(None),) if any(i is Ellipsis for i in idx) else idx
        return LweCiphertext(self.a[a_idx], self.b[idx], self.cv[idx])

    def reshape(self, *batch_shape) -> "LweCiphertext":
        if len(batch_shape) == 1 and isinstance(batch_shape[0], (tuple, list)):
            batch_shape = tuple(batch_shape[0])
        return LweCiphertext(
            self.a.reshape(batch_shape + (self.a.shape[-1],)),
            self.b.reshape(batch_shape),
            self.cv.reshape(batch_shape),
        )


def lwe_concat(cts, axis: int = 0) -> LweCiphertext:
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        torch.cat([c.a for c in cts], dim=a_axis),
        torch.cat([c.b for c in cts], dim=axis),
        torch.cat([c.cv for c in cts], dim=axis),
    )


def noiseless_trivial(mu, n: int, batch_shape=(), device=None) -> LweCiphertext:
    """(0, mu) (ref lwe-functions.cu lweNoiselessTrivial)."""
    batch_shape = tuple(batch_shape)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device).expand(batch_shape)
    return LweCiphertext(
        torch.zeros(batch_shape + (n,), dtype=torch.int32, device=mu.device),
        mu.clone(),
        torch.zeros(batch_shape, dtype=torch.float32, device=mu.device),
    )


def lwe_add(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a + y.a, x.b + y.b, x.cv + y.cv)


def lwe_sub(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a - y.a, x.b - y.b, x.cv + y.cv)


def lwe_negate(x: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(-x.a, -x.b, x.cv)
