"""tfhe_tpu_torch: the PyTorch/CUDA port of ``tfhe_tpu``.

Keys, encryption and the batched gate bootstrap on torch tensors. On CUDA
tensors the blind rotate and the fused key switch run in CUDA kernels written
by hand for Hopper (``csrc/``); on CPU tensors every kernel takes its
plain-torch version. The package never imports jax; ``tfhe_tpu`` is the
reference it is tested against, byte for byte.

Layer map (the module names follow ``tfhe_tpu``):
  numerics        -> tfhe_tpu_torch.numeric, tfhe_tpu_torch.ntt
  kernels         -> tfhe_tpu_torch.ops (cmux wrappers, nvcc build), csrc/*.cu
  core            -> tfhe_tpu_torch.core (lwe, keys, crypt, bootstrap)
  gates           -> tfhe_tpu_torch.gates
"""

from .params import TfheParams, PARAMS_110, PARAMS_TOY, PARAMS_SMALL, PARAMS_SMALL_NOISY
from .core.keys import keygen, keygen_reference, SecretKeySet, CloudKey
from .core.lwe import LweCiphertext
from .core.crypt import encrypt_bits, decrypt_bits, decrypt_phase, lwe_encrypt, lwe_phase
from . import gates
from . import ntt
from . import numeric

__version__ = "0.1.0"
