"""Exact phase simulation and the analytic noise budget of gate circuits.

Port of ``tfhe_tpu.utils.phasesim``, on torch tensors on the CPU:

- the variance models (plain float math over the parameter set), which
  ``arith`` reads to cap the live +-1/16 inputs of a compressor image
  (:func:`max_live16`);
- :class:`PhaseSim`, which runs the production circuits with the bootstrap
  layer (``core.bootstrap.bootstrap``, ``bootstrap_woks``, ``key_switch``,
  reached by the gates through the module) replaced by an exact phase
  evaluator. Inputs are noiseless trivial samples, so the torus phase of
  every image is ``b`` itself; each fake bootstrap records its images'
  phases and tracked variances (``cv``, through the unmodified affine
  code) and returns the trivial +-mu sample the blind rotate would give;
- :func:`analyze`, the failure certificate: per image the margin is its
  phase-lattice unit (the lowest set bit of its phase, constant across
  trials), z = margin / sqrt(cv + var_modswitch), and the union bound sums
  erfc(z / sqrt 2) over the circuit.

Decrypting the simulated result also checks the whole circuit's wiring at
PARAMS_110 widths in milliseconds.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..params import TfheParams
from ..core import bootstrap as bs
from ..core.lwe import LweCiphertext


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
# packages plan the same circuits. On an H100 (700 W) the port's AND-gate
# outputs at PARAMS_110 measured 1.713e-5, 1.05 times this value (4,096
# gates, the reference's keys; chip_smoke.py's [noise] phase, PERF.md).
SAMPLE_VAR_MEASURED_110 = (0.171 / 16.0) ** 2 / 7.0


# ------------------------------------------------------------ the simulator

@dataclass
class ImageRecord:
    """One bootstrap call: exact input phases, tracked variances and output
    amplitudes (numpy arrays over the flat batch)."""
    phases: np.ndarray   # int64 ideal torus32 phase of each image
    cv: np.ndarray       # float64 accumulated variance of each image
    mu: np.ndarray       # int32 output amplitude (its sign carries folded NOTs)
    kind: str            # 'bootstrap' | 'woks' | 'decrypt'


class _FakeCloud:
    """Stand-in for CloudKey: circuits only touch .params and .ks_table
    through code the simulator intercepts."""

    def __init__(self, params: TfheParams):
        self.params = params
        self.ks_table = None
        self.bk_ntt = None
        self.bk_ntt_shoup = None
        self.bk_rows = None
        self.bk_rows_shoup = None
        self.ks_table_perm = None


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class PhaseSim:
    """Context manager that redirects the bootstrap layer to exact phase
    evaluation and records every image. With the production circuits:

        with PhaseSim(PARAMS_110) as sim:
            a = sim.encrypt_int(12345, 16)
            b = sim.encrypt_int(321, 16)
            out = arith.mul(a, b, sim.cloud)
            assert sim.decrypt_int(out, signed=False) == (12345 * 321) % (1 << 16)
        report = analyze([sim], PARAMS_110)
    """

    def __init__(self, params: TfheParams, sample_var: float | None = None,
                 input_var: float | None = None):
        self.params = params
        # the fresh post-gate sample variance each fake bootstrap seeds
        self.sample_var = (sample_var_tracked(params) if sample_var is None
                           else float(sample_var))
        # user inputs carry the encryption noise ks_stdev (crypt.encrypt_bits)
        self.input_var = (params.ks_stdev ** 2 if input_var is None
                          else float(input_var))
        self.cloud = _FakeCloud(params)
        self.records: list[ImageRecord] = []
        self._stack = None

    # --- fake bootstrap layer ------------------------------------------

    def _record(self, x: LweCiphertext, mu, kind: str) -> np.ndarray:
        phases = _np(x.b).astype(np.int64)
        if _np(x.a).any():
            raise AssertionError("phase-sim inputs must stay trivial (a == 0)")
        mu_arr = np.broadcast_to(_np(mu).astype(np.int32), phases.shape)
        self.records.append(ImageRecord(
            phases=phases.copy(), cv=_np(x.cv).astype(np.float64).copy(),
            mu=mu_arr.copy(), kind=kind))
        # the exact sign decision: phase in [0, 1/2) -> +mu (phase 0 rotates
        # the test vector by 0, onto +mu)
        return np.where(phases >= 0, mu_arr, -mu_arr).astype(np.int32)

    def _fake_bootstrap(self, x: LweCiphertext, mu, cloud) -> LweCiphertext:
        out_b = self._record(x, mu, "bootstrap")
        B = out_b.shape
        return LweCiphertext(
            torch.zeros(B + (self.params.n,), dtype=torch.int32),
            torch.from_numpy(out_b),
            torch.full(B, self.sample_var, dtype=torch.float32))

    def _fake_bootstrap_woks(self, x: LweCiphertext, mu, cloud):
        out_b = self._record(x, mu, "woks")
        B = out_b.shape
        # the extracted sample over the n_extract key, still trivially zero;
        # cv: the blind rotate's variance only (key_switch adds its own)
        a_ext = torch.zeros(B + (self.params.n_extract,), dtype=torch.int32)
        cv = torch.full(B, self.sample_var
                        - self.params.n_extract * self.params.ks_t
                        * self.params.ks_stdev ** 2, dtype=torch.float32)
        return a_ext, torch.from_numpy(out_b), cv

    def _fake_key_switch(self, a_ext, b_ext, ks_table, cv, params):
        ks_var = torch.tensor(params.n_extract * params.ks_t * params.ks_stdev ** 2,
                              dtype=torch.float32)
        return LweCiphertext(
            torch.zeros(tuple(b_ext.shape) + (params.n,), dtype=torch.int32),
            b_ext, cv + ks_var)

    # --- plumbing --------------------------------------------------------

    def __enter__(self):
        from ..config import overrides
        self._stack = contextlib.ExitStack()
        # the fused route has no key_switch of its own to patch: force the split one
        self._stack.enter_context(overrides(TFHE_TPU_FUSEKS="0"))
        for name, fake in (("bootstrap", self._fake_bootstrap),
                           ("bootstrap_woks", self._fake_bootstrap_woks),
                           ("key_switch", self._fake_key_switch)):
            orig = getattr(bs, name)
            setattr(bs, name, fake)
            self._stack.callback(setattr, bs, name, orig)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False

    # --- trivial-ciphertext io -------------------------------------------

    def encrypt_int(self, value, nbits: int) -> LweCiphertext:
        value = np.asarray(value, np.int64)
        bits = (value[..., None] >> np.arange(nbits)) & 1
        return self.encrypt_bits(bits.astype(np.int32))

    def encrypt_bits(self, bits) -> LweCiphertext:
        bits = np.asarray(bits, np.int32)
        mu = 1 << 29
        b = np.where(bits != 0, mu, -mu).astype(np.int32)
        return LweCiphertext(
            torch.zeros(bits.shape + (self.params.n,), dtype=torch.int32),
            torch.from_numpy(b),
            torch.full(bits.shape, self.input_var, dtype=torch.float32))

    def decrypt_bits(self, ct: LweCiphertext) -> np.ndarray:
        return np.asarray(_np(ct.b) > 0, np.int32)

    def decrypt_int(self, ct: LweCiphertext, signed: bool = True) -> np.ndarray:
        bits = self.decrypt_bits(ct).astype(np.int64)
        nbits = bits.shape[-1]
        val = np.sum(bits * (1 << np.arange(nbits)), axis=-1)
        if signed:
            val = val - (bits[..., -1].astype(np.int64) << nbits)
        return val

    def final_record(self, ct: LweCiphertext):
        """Record the circuit's result bits as decrypt-time decision images
        (margin: the distance of +-1/8 to the sign boundary; variance: cv,
        with no mod-switch term at decryption)."""
        self.records.append(ImageRecord(
            phases=_np(ct.b).astype(np.int64).reshape(-1),
            cv=_np(ct.cv).astype(np.float64).reshape(-1),
            mu=np.zeros(int(np.prod(ct.batch_shape)), np.int32),
            kind="decrypt"))


# ------------------------------------------------------------ the analysis

def _unit_t32(phases: np.ndarray) -> np.ndarray:
    """Per-image phase-lattice unit in torus units: every decision image of
    these circuits has its ideal levels at odd multiples of a power-of-two
    unit u, so u is the lowest set bit of the observed phase: the same for
    every input, and the worst-case margin of the site."""
    ab = np.abs(phases.astype(np.int64))
    if not (ab > 0).all():
        raise AssertionError("live image with ideal phase exactly 0")
    u = ab & (-ab)                      # lowest set bit = 2^trailing_zeros
    return u / float(1 << 32)


def analyze(sims, params: TfheParams, label: str = "") -> dict:
    """Union-bound failure certificate over every recorded image.

    sims: one PhaseSim per trial of the same circuit (different inputs). Per
    image site the worst-case margin is its phase-lattice unit (_unit_t32),
    checked constant across trials; z = unit / sqrt(cv + var_ms) per image,
    and the two-sided Gaussian tail erfc(z / sqrt 2) is summed over the
    whole circuit."""
    vms = var_modswitch(params)
    trials = []
    for sim in sims:
        cv = np.concatenate([r.cv for r in sim.records])
        live = cv > 0                   # trivial and pad images cannot fail
        ph = np.concatenate([r.phases for r in sim.records])
        m = np.zeros(ph.shape)
        m[live] = _unit_t32(ph[live])
        var = cv + np.where(
            np.concatenate([np.full(r.phases.shape, r.kind != "decrypt")
                            for r in sim.records]), vms, 0.0)
        trials.append((m, cv, var, live))
    m0, live = trials[0][0], trials[0][3]
    for m, cv, _, lv in trials[1:]:
        if m.shape != m0.shape or not np.array_equal(lv, live):
            raise AssertionError("trials ran different circuits")
        if not np.array_equal(m[live], m0[live]):
            bad = int(np.sum(m[live] != m0[live]))
            raise AssertionError(
                f"{bad} image lattice units vary across trials: the odd-multiple "
                "margin lemma does not cover this circuit (NOISE.md)")

    margins, var = m0[live], trials[0][2][live]
    if not (margins >= 1.0 / 16 - 1e-12).all():
        raise AssertionError("an image class sits below the 1/16 design floor")
    z = margins / np.sqrt(var)
    # two-sided tail: both boundaries are at >= margin
    pfail = np.array([math.erfc(zi / math.sqrt(2.0)) for zi in z])
    i = int(np.argmin(z))
    classes = {}
    for mval in np.unique(margins):
        sel = margins == mval
        inv = 1.0 / mval
        key = f"1/{int(round(inv))}" if abs(inv - round(inv)) < 1e-9 else f"{mval:g}"
        classes[key] = {
            "images": int(sel.sum()),
            "min_z": float(z[sel].min()),
            "sum_pfail": float(pfail[sel].sum()),
        }
    return {
        "label": label,
        "images_live": int(live.sum()),
        "images_total": int(m0.size),
        "bootstrap_calls": len(sims[0].records),
        "min_z": float(z[i]),
        "worst_margin": float(margins[i]),
        "worst_sigma": float(np.sqrt(var[i])),
        "sum_pfail": float(pfail.sum()),
        "per_class": classes,
        "var_modswitch": vms,
    }
