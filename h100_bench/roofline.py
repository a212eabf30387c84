"""The yardstick of the kernels' roofline shares, frozen here.

A kernel's bound is the larger of two times: its operations at the card's
int32 rate, and its bytes, each read or written once, at the card's memory
rate. Both are counted from the shapes of the algorithm, not from what one
implementation executes, so a later kernel that does the same work in fewer
instructions moves its share up, and one that does less work than the
algorithm cannot read above 100 %.

Operations of a CMux step on one sample, the exact two-prime external
product: for each of the 2 primes, (k+1)*l forward transforms of the
decomposed digits and k+1 inverse transforms, each (N/2) * log2(N)
butterflies, and N * (k+1)*l * (k+1) pointwise multiply-accumulates. Each
is priced at a fixed number of int32 operations on residues below 2^31:
a modular multiply by a precomputed constant (Shoup) 3 (high product, low
product, multiply-subtract), a modular add or subtract 2 (the operation and
its conditional correction); a butterfly is one multiply, one add and one
subtract (7), a multiply-accumulate one multiply and one add (5).

Bytes of a launch: the NTT-domain bootstrapping key and its Shoup twin, read
once a launch; each sample's accumulator in, its n rotation amounts in, and
its result out; for the fused key switch (K4) the whole key-switch table once
a launch and the switched sample out.

The peaks: NVIDIA's H100 SXM5 data sheet and the Hopper whitepaper: 132 SMs,
64 INT32 lanes an SM, a boost clock of 1,980 MHz (16.73 Tops/s of int32), and
3.35 TB/s of HBM3. They assume the card's full 700 W; the run reports the
card's power limit beside the share.
"""
from __future__ import annotations

SMS = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.980e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ
HBM_BYTES_PER_S = 3.35e12
PRIMES = 2
OPS_PER_BUTTERFLY = 7
OPS_PER_MAC = 5
WORD = 4


def cmux_step_ops(P) -> int:
    """int32 operations of one CMux step on one sample."""
    logn = P.N.bit_length() - 1
    kpl, k1 = (P.k + 1) * P.bk_l, P.k + 1
    butterflies = PRIMES * (kpl + k1) * (P.N // 2) * logn
    macs = PRIMES * P.N * kpl * k1
    return butterflies * OPS_PER_BUTTERFLY + macs * OPS_PER_MAC


def key_bytes(P) -> int:
    """The NTT-domain bootstrapping key and its Shoup twin."""
    kpl, k1 = (P.k + 1) * P.bk_l, P.k + 1
    return 2 * P.n * PRIMES * kpl * k1 * P.N * WORD


def ks_table_bytes(P) -> int:
    """The fused key switch's int8 table: t*(base-1) planes of n_ext rows of
    4 limb planes of n+1 columns padded to a multiple of 128."""
    cols = -(-(P.n + 1) // 128) * 128
    return P.ks_t * ((1 << P.ks_basebit) - 1) * P.k * P.N * 4 * cols


def blind_rotate_bound_s(P, launches: int, samples: int, fused_ks: bool) -> float:
    """The bound of `launches` launches holding `samples` samples in all:
    the larger of all their operations at the int32 rate and all their bytes
    at the memory rate."""
    ops = samples * P.n * cmux_step_ops(P)
    acc = (P.k + 1) * P.N * WORD
    per_sample = acc + P.n * WORD + ((P.n + 1) * WORD + 2 * WORD if fused_ks else acc)
    moved = launches * (key_bytes(P) + (ks_table_bytes(P) if fused_ks else 0))
    moved += samples * per_sample
    return max(ops / INT32_OPS_PER_S, moved / HBM_BYTES_PER_S)
