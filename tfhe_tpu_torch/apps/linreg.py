"""Encrypted simple linear regression, the paper's application demo (Table X).

Port of ``tfhe_tpu.apps.linreg``. The reference paper (section VI-G) fits
y = b0 + b1*x over an encrypted dataset; its code was never released, so the
app rebuilds it from the framework's own primitives as the paper describes:
homomorphic sums and products for the normal-equation terms, then encrypted
division.

    b1 = (n*Sxy - Sx*Sy) / (n*Sxx - Sx*Sx),   b0 = (Sy - b1*Sx) / n

All sums use the carry-save vector reduction; all products are batched.
Inputs are fixed-point integers (the caller chooses the scale).
"""
from __future__ import annotations

import numpy as np

from .. import arith, gates, linalg
from ..core.lwe import LweCiphertext, lwe_stack


def _fit(sx, sy, sxy, sxx, n_rows: int, cloud):
    """(b1, b0) from the four encrypted sums; n_rows is public."""
    nbits = sx.batch_shape[-1]
    n_triv = arith.trivial_bits(
        ((np.int64(n_rows) >> np.arange(nbits)) & 1).astype(np.int32), sx.n,
        batch_shape=sx.batch_shape, device=sx.device)
    n_sxy = arith.mul_plain(sxy, n_rows, cloud)   # n is public: no AND bootstraps
    n_sxx = arith.mul_plain(sxx, n_rows, cloud)
    sx_sy = arith.mul(sx, sy, cloud)
    sx_sx = arith.mul(sx, sx, cloud)

    num = arith.sub(n_sxy, sx_sy, cloud)
    den = arith.sub(n_sxx, sx_sx, cloud)
    b1 = arith.div(num, den, cloud)

    b1_sx = arith.mul(b1, sx, cloud)
    b0_num = arith.sub(sy, b1_sx, cloud)
    b0 = arith.div(b0_num, n_triv, cloud)
    return b1, b0


def linear_regression(cx: LweCiphertext, cy: LweCiphertext, cloud):
    """cx, cy: [n_rows, nbits] encrypted fixed-point columns. Returns the
    encrypted slope and intercept (b1, b0), by integer division.

    Widths: intermediate sums and products stay in the input width; callers
    size nbits to fit n*Sxy (as the paper's fixed-point setup does).

    Leading batch axes are kept: cx/cy of shape [attrs, n_rows, nbits] fit
    all attribute columns as one batched regression. At 200 rows x 10
    attributes and 16 bits each inner product opens with one AND batch of
    10 * 200 * 136 = 272,000 samples."""
    n_rows = cx.batch_shape[-2]
    sx = linalg.vector_sum(cx, cloud)                        # [..., nbits]
    sy = linalg.vector_sum(cy, cloud)
    # Sxy and Sxx are inner products over the row axis: the fused carry-save
    # contraction (arith.dot) skips the n_rows carry chains, one per product,
    # that mul-then-sum would pay
    sxy = arith.dot(cx, cy, cloud)
    sxx = arith.dot(cx, cx, cloud)
    return _fit(sx, sy, sxy, sxx, n_rows, cloud)


def linear_regression_binary(cx_bits: LweCiphertext, cy: LweCiphertext, cloud):
    """The paper's faster 'Binary' variant (Table X): the attribute column is
    one encrypted bit per row, so every x-product collapses to an AND
    (Sxx == Sx, and x*y = MUX(x, y, 0)).

    cx_bits: [..., n_rows] encrypted bits; cy: [..., n_rows, nbits].
    Returns (b1, b0); leading batch axes fit many attribute columns at once."""
    n_rows = cy.batch_shape[-2]
    nbits = cy.batch_shape[-1]
    xmask = lwe_stack([cx_bits] * nbits, axis=-1)            # [..., n_rows, nbits]
    zeros = arith.zero_like_bits(cy, cy.batch_shape)
    xy = gates.MUX(xmask, cy, zeros, cloud)                  # x_i * y_i, one MUX batch

    # an encrypted bit is bit 0 of the integer encoding (the same +-1/8
    # message), so Sx is a popcount: the n_rows bits go straight into the
    # carry-save compressor at column 0, with no zero-padded integers (the
    # padding would spend bootstraps on trivial zeros in columns 1..nbits-1)
    sx = arith._wallace_sum_bits(
        cx_bits, np.zeros(n_rows, np.int64), nbits, cloud)
    sy = linalg.vector_sum(cy, cloud)
    sxy = linalg.vector_sum(xy, cloud)
    return _fit(sx, sy, sxy, sx, n_rows, cloud)              # x in {0,1}: x^2 == x
