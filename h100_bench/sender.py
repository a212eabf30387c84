"""What every traffic kind shares. A kind is ``senders/<kind>.py``, found by
the ``kind`` of a traffic file (``harness.sender``), and defines ``Sender``:
one closed-loop client that drives the program as its traffic file says and
checks every answer it got.

A sender makes its inputs in ``setup``, calls every shape the window will
use in ``warm`` (which returns the tensors of one answer and the seconds one
request took), enqueues one request in ``step`` and judges the answers in
``check``, after the window, against the plain reference. The window
(``run.py``) waits for each request to complete: the traffic's `depth`
(default 1) is how many requests the client keeps in flight. The window
closes after a whole ``block`` of requests, so that every run does the same
mix of work whatever the seed. What a request sends is drawn from the seed
as it is sent.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rng(seed, stream: str) -> np.random.Generator:
    """A generator of its own for each stream of a run's draws."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:8], "little"))


def tensors(ct) -> list:
    return [ct.a, ct.b, ct.cv]


def ciphertext(a, b, cv):
    from tfhe_tpu_torch.core.lwe import LweCiphertext
    return LweCiphertext(a, b, cv)


class Context:
    """What a sender works with: the run's device, seed and traffic, the
    benchmark's raw keys, the program's cloud key, and the mesh of a cell of
    several chips (None on one)."""

    def __init__(self, device, seed, traffic, keys, cloud, mesh=None):
        self.device, self.seed, self.traffic = device, seed, traffic
        self.keys, self.cloud, self.mesh = keys, cloud, mesh
