"""TFHE parameter sets (the same frozen dataclass as ``tfhe_tpu.params``).

Everything derives from one frozen, hashable dataclass so the whole pipeline,
kernels and table caches included, is parameterized by it. The sets:

- ``PARAMS_110``: the reference's set (110-bit security,
  `gpuParallel/tfhe_gate_bootstrapping.cu:25-49`, TFHE v1.0's default);
- ``PARAMS_128``: the TFHE library's default gate-bootstrapping set since
  v1.1 (128-bit security, github.com/tfhe/tfhe
  `src/libtfhe/tfhe_gate_bootstrapping.cpp`,
  `new_default_gate_bootstrapping_parameters`);
- small noise-free sets for the tests on the CPU, at gadget length 2
  (``PARAMS_TOY``, ``PARAMS_SMALL``) and 3 (``PARAMS_TOY_L3``).

The CUDA kernels of the port run PARAMS_110 and PARAMS_128 on the card: they
take k = 1, a gadget length l of 2 or 3 and 64 <= N <= 2048 (N <= 1024 for
the small-batch blind rotate); the CPU path takes any set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


def _mul_by_sqrt_two_over_pi(x: float) -> float:
    # reference: tfhe_gate_bootstrapping.cu:22 (converts "literature" gaussian param to stdev)
    return x * math.sqrt(2.0 / math.pi)


@dataclass(frozen=True)
class TfheParams:
    """All TFHE gate-bootstrapping parameters (ref: TFheGateBootstrappingParameterSet)."""

    n: int = 500          # LWE dimension (in/out params)
    N: int = 1024         # torus polynomial degree, ring Z[X]/(X^N+1)
    k: int = 1            # number of TLWE mask polynomials
    bk_l: int = 2         # TGSW gadget decomposition length
    bk_Bgbit: int = 10    # log2 of gadget base Bg
    ks_basebit: int = 2   # key-switch digit bits
    ks_t: int = 8         # key-switch digit count
    ks_stdev: float = _mul_by_sqrt_two_over_pi(2.0 ** -15)
    bk_stdev: float = _mul_by_sqrt_two_over_pi(9e-9)
    max_stdev: float = _mul_by_sqrt_two_over_pi((2.0 ** -4) / 4.0)

    @property
    def Bg(self) -> int:
        return 1 << self.bk_Bgbit

    @property
    def halfBg(self) -> int:
        return self.Bg // 2

    @property
    def maskMod(self) -> int:
        return self.Bg - 1

    @property
    def kpl(self) -> int:
        return (self.k + 1) * self.bk_l

    @property
    def decomp_offset(self) -> int:
        """offset = Bg/2 * sum_i 2^(32 - (i+1)*Bgbit), as uint32 (ref tgsw.cu:21-27)."""
        temp1 = 0
        for i in range(self.bk_l):
            temp1 += 1 << (32 - (i + 1) * self.bk_Bgbit)
        return (temp1 * self.halfBg) & 0xFFFFFFFF

    @property
    def h(self) -> tuple:
        """Gadget powers h[i] = 2^(32-(i+1)*Bgbit) as signed Torus32 (ref tgsw.cu:15-19)."""
        out = []
        for i in range(self.bk_l):
            v = 1 << (32 - (i + 1) * self.bk_Bgbit)
            if v >= 1 << 31:
                v -= 1 << 32
            out.append(v)
        return tuple(out)

    @property
    def n_extract(self) -> int:
        """Dimension of the extracted LWE sample (k*N)."""
        return self.k * self.N

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit

    @property
    def ks_prec_offset(self) -> int:
        """Rounding offset for the key-switch digit decomposition
        (ref lwe-keyswitch-functions.cu:106)."""
        return 1 << (32 - (1 + self.ks_basebit * self.ks_t))


# The reference's parameter set: 110-bit security.
PARAMS_110 = TfheParams()

# The TFHE library's default set at 128-bit security (TFHE v1.1). Its two
# standard deviations are given there as standard deviations and are taken
# as they are, not converted by sqrt(2/pi) as the reference's are.
PARAMS_128 = TfheParams(
    n=630, N=1024, k=1, bk_l=3, bk_Bgbit=7, ks_basebit=2, ks_t=8,
    ks_stdev=2.0 ** -15, bk_stdev=2.0 ** -25, max_stdev=0.012467,
)

# Small deterministic set for fast tests: noise-free, small ring.
PARAMS_TOY = TfheParams(
    n=16, N=128, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
    ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0,
)

# PARAMS_TOY with PARAMS_128's gadget: three levels of 7 bits.
PARAMS_TOY_L3 = TfheParams(
    n=16, N=128, k=1, bk_l=3, bk_Bgbit=7, ks_basebit=2, ks_t=8,
    ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0,
)

# Mid-size set (still fast on CPU, exercises the N=256 NTT).
PARAMS_SMALL = TfheParams(
    n=64, N=256, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
    ks_stdev=0.0, bk_stdev=0.0, max_stdev=1.0,
)

# PARAMS_SMALL with the reference's noise levels.
PARAMS_SMALL_NOISY = TfheParams(
    n=64, N=256, k=1, bk_l=2, bk_Bgbit=10, ks_basebit=2, ks_t=8,
)
