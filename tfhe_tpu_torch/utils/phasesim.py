"""Noise accounting that the compressor planner reads.

Port of the variance models of ``tfhe_tpu.utils.phasesim`` (:62-148): plain
float math over the parameter set, which ``arith`` uses to cap the live
+-1/16 inputs of a compressor image (:func:`max_live16`). The exact-phase
circuit simulator of that module is not ported yet (ROADMAP Queue 1 #10).
"""
from __future__ import annotations

from ..params import TfheParams
from ..core import bootstrap as bs


def var_modswitch(params: TfheParams) -> float:
    """Phase-rounding variance the blind rotate adds to its input image:
    b and each a_i round to multiples of 1/2N, an error uniform on +-1/(4N)
    per coefficient; the key bits gate half the a terms on average."""
    h = 1.0 / (4.0 * params.N)
    return (1.0 + params.n / 2.0) * (h * h) / 3.0


def var_ks_rounding(params: TfheParams) -> float:
    """Key-switch digit-truncation variance: each of the n_extract
    coefficients truncates below t*basebit bits, uniform on
    +-2^-(t*basebit+1) (ref lwe-keyswitch-functions.cu:106 prec_offset)."""
    h = 2.0 ** -(params.ks_t * params.ks_basebit + 1)
    return params.n_extract * (h * h) / 3.0


def sample_var_tracked(params: TfheParams) -> float:
    """The conservative post-gate sample variance the cv bookkeeping carries:
    the worst-case-digit blind-rotate bound plus one KS-sample variance per
    possible digit."""
    return (bs._bootstrap_variance(params)
            + params.n_extract * params.ks_t * params.ks_stdev ** 2)


def sample_var_average(params: TfheParams) -> float:
    """Average-case post-gate sample variance: gadget digits of a uniform
    ciphertext are uniform on [-Bg/2, Bg/2), E[d^2] = (Bg^2 - 1)/12 + 1/4,
    and (1 - 1/base) of the KS digits are nonzero in expectation."""
    p = params
    ed2 = (p.Bg ** 2 - 1) / 12.0 + 0.25
    eps2 = (2.0 ** (-2 * p.bk_l * p.bk_Bgbit)) / 4.0
    var_br = p.n * ((p.k + 1) * p.bk_l * p.N * ed2 * p.bk_stdev ** 2
                    + (1 + p.k * p.N) * eps2)
    nnz = (1.0 - 1.0 / p.ks_base) * p.n_extract * p.ks_t
    return var_br + nnz * p.ks_stdev ** 2 + var_ks_rounding(p)


def active_sample_var(params: TfheParams) -> float:
    """Per-sample post-gate variance under the active noise model
    (config.noise_model). The "measured" constant exists only for
    PARAMS_110; other parameter sets take the average model."""
    from ..config import noise_model
    m = noise_model()
    if m == "tracked":
        return sample_var_tracked(params)
    if m == "measured" and (params.n, params.N, params.ks_stdev) == (
            500, 1024, TfheParams().ks_stdev):
        return SAMPLE_VAR_MEASURED_110
    return sample_var_average(params)


def max_live16(params: TfheParams, z_min: float = 5.0) -> int:
    """Cap on the live +-1/16 inputs one compressor image may sum so that
    its failure z-score under the active noise model stays >= z_min:

        z = (1/16) / sqrt(m * var_sample + var_modswitch)  >=  z_min

    Capped at 7, the widest group of the septet engine."""
    var = active_sample_var(params)
    if var <= 0.0:
        return 7
    u = 1.0 / 16.0
    m = int(((u / z_min) ** 2 - var_modswitch(params)) / var)
    return max(0, min(7, m))


# The per-sample phase-error variance at PARAMS_110 that tfhe_tpu pins for
# its "measured" model: sigma = 0.171 of the 1/16 margin over a 7-way
# affine of post-bootstrap +-1/16 samples, var = (0.171 / 16)^2 / 7. The
# value is tfhe_tpu's (tfhe_tpu/utils/phasesim.py:148), kept so both
# packages plan the same circuits; it was not measured on the port.
SAMPLE_VAR_MEASURED_110 = (0.171 / 16.0) ** 2 / 7.0
