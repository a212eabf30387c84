"""Encrypted vector and matrix operations.

Port of ``tfhe_tpu.linalg`` (the reference's vector and matrix layer,
`gpuParallel/main.cu:1033-1355, 2223-2644`, `matrixUtility.cu`). Every arith
circuit accepts leading batch axes, so a vector op is the same circuit with
batch = vector length, and a matrix op is a reshape and one large batch.

Shapes: an encrypted vector of L n-bit numbers is an LweCiphertext with batch
shape [L, nbits]; a matrix is [R, C, nbits]. A 16-bit 8x8 ``matmul`` opens
with one AND batch of 8*8*8*136 = 69,632 samples, which ``core.bootstrap``
gives whole to the blind-rotate kernel of ``ops.cmux``; the carry-save stages
behind it shrink through every batch size down to the final ripple add.
"""
from __future__ import annotations

import numpy as np
import torch

from . import arith, gates
from .core.lwe import LweCiphertext, lwe_concat, lwe_stack, lwe_take


def vector_add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise vector addition (ref BOOTS_vectorAddition, main.cu:1304-1355)."""
    return arith.add(a, b, cloud)


def vector_mul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise vector multiplication (ref BOOTS_vectorMultiplication,
    main.cu:1746-1865): all L*nbits^2 partial-product ANDs in one bootstrap."""
    return arith.mul(a, b, cloud)


@arith.circuit
def vector_sum(v: LweCiphertext, cloud) -> LweCiphertext:
    """Sum of a vector of numbers (ref BOOTS_Add_vector, main.cu:1033-1136),
    through the carry-save 3:2 reduction (arith._csa_reduce_rows).
    v: [..., L, nbits] -> [..., nbits]."""
    return arith._csa_reduce_rows(v, cloud)


def matrix_add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Elementwise matrix addition (ref BOOTS_matrixAddition, main.cu:2223-2275)."""
    return arith.add(a, b, cloud)


@arith.circuit
def matmul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Matrix multiply: the partial-product ANDs of all R*C*K element products
    as one bootstrap batch, then one fused carry-save contraction per output
    element (``arith.dot``). The reference multiplies every element pair and
    accumulates the results in a log tree (BOOTS_matrixMultiplication,
    main.cu:2342-2462, with the matMul_prepareLeftMat/RightMat duplication,
    matrixUtility.cu:65-96); the fusion skips its K carry chains per product.

    a: [R, K, nbits]; b: [K, C, nbits] -> [R, C, nbits].
    """
    R = a.batch_shape[0]
    C = b.batch_shape[1]
    # left[i, j, k] = a[i, k]; right[i, j, k] = b[k, j]
    a_exp = lwe_stack([a] * C, axis=1)                      # [R, C, K, nbits]
    b_t = lwe_stack([b[:, j] for j in range(C)], axis=0)    # [C, K, nbits]
    b_exp = lwe_stack([b_t] * R, axis=0)                    # [R, C, K, nbits]
    return arith.dot(a_exp, b_exp, cloud)                   # fused contraction over K


def _roll_lines(x: LweCiphertext, shift_of, axis: int) -> LweCiphertext:
    """Roll line i of x along the other grid axis by -shift_of(i): the rows
    (axis 0) leftwards, or the columns (axis 1) upwards."""
    lines = []
    for i in range(x.batch_shape[axis]):
        line = x[i] if axis == 0 else x[:, i]
        lines.append(LweCiphertext(*(torch.roll(v, -shift_of(i), dims=0)
                                     for v in (line.a, line.b, line.cv))))
    return lwe_stack(lines, axis=axis)


@arith.circuit
def cannon_matmul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Cannon's algorithm over the element grid on one device (ref
    BOOTS_CannonsAlgo, main.cu:2590-2644, with leftRotate/upRotate
    :2531-2557): the initial skew, then D rounds of elementwise multiply,
    accumulate and neighbour rotations, which here are rolls of the arrays.
    a, b: [D, D, nbits].

    The multiply-accumulate stays in carry-save form: each round adds its
    triangle of partial-product ANDs (one bootstrap batch) to a bit pool per
    element, and one carry-save compression with one ripple add runs after
    the last round; the reference accumulates with a full adder every round
    (main.cu:2618-2631), D carry chains per element.
    """
    D = a.batch_shape[0]
    nbits = a.batch_shape[-1]
    # initial skew: row i of A left-rotated by i, column j of B up-rotated by j
    a_sk = _roll_lines(a, lambda i: i, axis=0)
    b_sk = _roll_lines(b, lambda j: j, axis=1)
    ja, ib, cols = arith._mul_triangle(nbits)
    sep = arith._septet_enabled(nbits, cloud.params)
    mu_pp = gates.MU16 if sep else gates.MU
    pools = []
    for _ in range(D):
        lhs = lwe_take(a_sk, ja, axis=-1)          # [D, D, P]
        rhs = lwe_take(b_sk, ib, axis=-1)
        pools.append(gates.gate2("AND", lhs, rhs, cloud, mu=mu_pp))
        a_sk = _roll_lines(a_sk, lambda i: 1, axis=0)
        b_sk = _roll_lines(b_sk, lambda j: 1, axis=1)
    pool = lwe_concat(pools, axis=-1)              # [D, D, D*P]
    return arith._wallace_sum_bits(
        pool, np.tile(cols, D), nbits, cloud,
        amp=np.full(D * len(cols), 16 if sep else 8))
