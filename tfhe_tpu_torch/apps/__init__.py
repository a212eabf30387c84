"""Application entry points (alice / cloud / verify / cli / linreg): the
reference's client/cloud trust split (cpuParallel/main.cpp, cloud.cpp) and
experiment suite (gpuParallel/main.cu:2714-2798).

Every app computes on the card. ``--device cpu`` is the only way to the CPU:
without the option and without a card an app raises
(``numeric.resolve_device``) and computes nothing."""
from __future__ import annotations

import argparse

import torch

from ..numeric import resolve_device


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    """The apps' ``--device`` option; read it with :func:`device_of`."""
    ap.add_argument("--device", default=None,
                    help="torch device to compute on (default: the CUDA card; "
                         "'cpu' for the plain-torch path)")


def device_of(args: argparse.Namespace) -> torch.device:
    """The device an app runs on: ``--device`` if given, else the card."""
    return resolve_device(args.device)
