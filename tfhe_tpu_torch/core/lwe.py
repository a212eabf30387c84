"""LWE ciphertext container and sample algebra on torch tensors (batched, SoA).

Port of ``tfhe_tpu.core.lwe``: the reference's coalesced
`LweSample_16 {int* a; int* b; double* cv}` (`gpuParallel/lwesamples.h:9-13`)
as a dataclass of tensors with an arbitrary leading batch shape. The algebra
ports `gpuParallel/lwe-functions.cu:100-296` with int32 wrap semantics.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
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


def lwe_stack(cts, axis: int = 0) -> LweCiphertext:
    """Stack a list of ciphertext batches along a new batch axis; negative
    axes count from the end of the batch shape."""
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        torch.stack([c.a for c in cts], dim=a_axis),
        torch.stack([c.b for c in cts], dim=axis),
        torch.stack([c.cv for c in cts], dim=axis),
    )


@functools.lru_cache(maxsize=4096)
def _plan_tensor(key: bytes, dtype: str, shape: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(key, dtype).reshape(shape).copy()).to(device)


def plan_tensor(v: np.ndarray, device) -> torch.Tensor:
    """A static numpy plan (gather indices, per-image amplitudes) as a tensor
    on `device`. A circuit's plans repeat from stage to stage, so each is
    copied to the device once and cached by content: a fresh host-to-device
    copy per call would make the host wait for all work queued before it.
    The tensor is shared; callers must not write to it."""
    v = np.ascontiguousarray(v)
    return _plan_tensor(v.tobytes(), v.dtype.str, v.shape, str(device))


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    out = torch.index_select(x, dim, idx.reshape(-1))
    return out.reshape(x.shape[:dim] + idx.shape + x.shape[dim + 1:])


def lwe_take(ct: LweCiphertext, idx, axis: int = -1) -> LweCiphertext:
    """Gather batch entries along one batch axis with a static numpy index
    array of any shape (negative entries count from the end, as in
    ``jnp.take``): one device op per field, indices from plan_tensor."""
    axis = axis % len(ct.batch_shape)
    size = ct.batch_shape[axis]
    idx = np.asarray(idx, np.int64)
    t = plan_tensor(np.where(idx < 0, idx + size, idx), ct.device)
    return LweCiphertext(_take(ct.a, t, axis), _take(ct.b, t, axis), _take(ct.cv, t, axis))


def lwe_concat(cts, axis: int = 0) -> LweCiphertext:
    a_axis = axis if axis >= 0 else axis - 1
    return LweCiphertext(
        torch.cat([c.a for c in cts], dim=a_axis),
        torch.cat([c.b for c in cts], dim=axis),
        torch.cat([c.cv for c in cts], dim=axis),
    )


def noiseless_trivial(mu, n: int, batch_shape=(), device=None) -> LweCiphertext:
    """(0, mu) (ref lwe-functions.cu lweNoiselessTrivial). A Python or numpy
    scalar mu is filled on `device`, with no host-to-device copy; a tensor
    mu keeps its own device."""
    batch_shape = tuple(batch_shape)
    if isinstance(mu, torch.Tensor):
        b = mu.to(torch.int32).expand(batch_shape).clone()
    elif np.ndim(mu) == 0:
        b = torch.full(batch_shape, int(mu), dtype=torch.int32, device=device)
    else:
        b = torch.as_tensor(np.asarray(mu, np.int32), device=device).expand(batch_shape).clone()
    return LweCiphertext(
        torch.zeros(batch_shape + (n,), dtype=torch.int32, device=b.device),
        b,
        torch.zeros(batch_shape, dtype=torch.float32, device=b.device),
    )


def lwe_add(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a + y.a, x.b + y.b, x.cv + y.cv)


def lwe_sub(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(x.a - y.a, x.b - y.b, x.cv + y.cv)


def lwe_negate(x: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(-x.a, -x.b, x.cv)
