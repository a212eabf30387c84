"""tfhe_tpu_torch: the PyTorch/CUDA port of ``tfhe_tpu``.

Keys, encryption, the batched gate bootstrap, the integer circuits,
``CipherInt``, encrypted vectors and matrices, the reference wire format and
the alice/cloud/verify/cli apps with linear regression, on torch tensors.
On CUDA tensors the blind rotate and the fused key switch run in CUDA kernels
written by hand for Hopper (``csrc/``); on CPU tensors every kernel takes its
plain-torch version. The package never
imports jax; ``tfhe_tpu`` is the reference it is tested against, byte for
byte.

Layer map (the module names follow ``tfhe_tpu``):
  numerics        -> tfhe_tpu_torch.numeric, tfhe_tpu_torch.ntt
  kernels         -> tfhe_tpu_torch.ops (cmux and cmux_packed wrappers, nvcc
                     build), csrc/*.cu
  core            -> tfhe_tpu_torch.core (lwe, keys, crypt, bootstrap)
  gates           -> tfhe_tpu_torch.gates
  arithmetic      -> tfhe_tpu_torch.arith, tfhe_tpu_torch.cipher
  vectors/matrices -> tfhe_tpu_torch.linalg (matmul, Cannon on one device)
  wire format     -> tfhe_tpu_torch.io (the reference's secret.key / cloud.key /
                     cloud.data files, byte for byte)
  apps            -> tfhe_tpu_torch.apps (alice, cloud, verify, cli, linreg; on
                     the card unless given --device cpu)
  noise model     -> tfhe_tpu_torch.utils.phasesim
  timing, spans   -> tfhe_tpu_torch.utils.profiling (PhaseTimer: CUDA events;
                     device_trace: torch.profiler; span and spans: the
                     program's spans, kept while a profiler records)
"""

from .params import (TfheParams, PARAMS_110, PARAMS_128, PARAMS_TOY, PARAMS_TOY_L3, PARAMS_SMALL,
                     PARAMS_SMALL_NOISY)
from .core.keys import keygen, keygen_reference, SecretKeySet, CloudKey
from .core.lwe import LweCiphertext
from .core.crypt import encrypt_bits, decrypt_bits, decrypt_phase, lwe_encrypt, lwe_phase
from . import gates
from . import ntt
from . import numeric
from . import arith
from . import linalg
from . import io
from .cipher import CipherInt

__version__ = "0.1.0"
