"""The benchmark's tests: its modules import by their own names (as run.py
imports them), the program from the checkout's root."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
