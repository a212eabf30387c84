"""Routing configuration: the one module of the port that reads ``os.environ``.

Only one policy exists so far: whether a bootstrap takes the fused route
(blind rotate, extract and key switch in the ``blind_rotate_ks`` kernel) or
the split route (the ``blind_rotate`` kernel, then the one-hot matmul key
switch). Both give the same bits. ``TFHE_TPU_FUSEKS=0/1`` forces a route;
:func:`overrides` wins over the environment. The default is fused on CUDA
and split on the CPU, so the CPU route mirrors ``tfhe_tpu`` on the CPU.
"""
from __future__ import annotations

import contextlib
import os

import torch

_OVERRIDES: dict = {}


def flag(name: str, default: str = "auto") -> str:
    """Resolve a flag: programmatic override > environment > default."""
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    return os.environ.get(name, default)


@contextlib.contextmanager
def overrides(**kv):
    """Programmatic flag overrides for the duration of the context:
    ``overrides(TFHE_TPU_FUSEKS="0")`` wins over the environment."""
    saved = dict(_OVERRIDES)
    _OVERRIDES.update({k: str(v) for k, v in kv.items()})
    try:
        yield
    finally:
        _OVERRIDES.clear()
        _OVERRIDES.update(saved)


def fuseks_enabled(device: torch.device) -> bool:
    """Fused key switch for a bootstrap whose tensors live on `device`."""
    v = flag("TFHE_TPU_FUSEKS")
    if v in ("0", "1"):
        return v == "1"
    return torch.device(device).type == "cuda"
