"""Bootstrapped boolean gate API (batched), on torch tensors.

Port of ``tfhe_tpu.gates``: the classic gates of the reference
(`gpuParallel/boot-gates.cu:98-448`), the compound two-gate batch
(`bootsANDXOR_16`, paper section V-A3), MUX (`boot-gates.cu:2631-2843`), and
``tfhe_tpu``'s extensions that the integer circuits stand on: the 3-input
gates MAJ and XOR3, the 2-bootstrap full adder, the +-1/16 compressor bits
(MU16, ``bootstrap_images``, ``full_adder16``) and the fused parallel-prefix
combine. A gate is an affine combination of its input batches followed by
one batched bootstrap; arbitrary leading batch shapes are supported, and a
batch of B gates costs one bootstrap of batch B. Unlike ``tfhe_tpu`` no
batch is padded or chunked: the padding only ever added trivial zeros, so
every output bit is the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.lwe import LweCiphertext, lwe_concat, lwe_negate, noiseless_trivial, plan_tensor
from .core import bootstrap as bs
from .utils.profiling import span

# Torus constants (modSwitchToTorus32(x, Msize))
_1_8 = 1 << 29   # modSwitchToTorus32(1, 8)
_1_4 = 1 << 30   # modSwitchToTorus32(1, 4)
MU = _1_8        # output amplitude of every bootstrapped gate
MU16 = 1 << 28   # +-1/16: the compressor-internal bit amplitude (see septets)

# gate -> (constant, coef_a, coef_b); phase > 0 => output 1/8
# (constants from boot-gates.cu:106,132,158,198,224,283,309,335,361,387,420,436)
GATE_TABLE = {
    "NAND":  (+_1_8, -1, -1),
    "OR":    (+_1_8, +1, +1),
    "AND":   (-_1_8, +1, +1),
    "XOR":   (+_1_4, +2, +2),
    "XNOR":  (-_1_4, -2, -2),
    "NOR":   (-_1_8, -1, -1),
    "ANDNY": (-_1_8, -1, +1),   # not(a) and b
    "ANDYN": (-_1_8, +1, -1),   # a and not(b)
    "ORNY":  (+_1_8, -1, +1),   # not(a) or b
    "ORYN":  (+_1_8, +1, -1),   # a or not(b)
}


def _affine2(x: LweCiphertext, y: LweCiphertext, const: int, ca: int, cb: int) -> LweCiphertext:
    """(0, const) + ca*x + cb*y with int32 wrap (the gate affine stage)."""
    a = ca * x.a + cb * y.a
    b = const + ca * x.b + cb * y.b
    cv = float(ca * ca) * x.cv + float(cb * cb) * y.cv
    return LweCiphertext(a, b, cv)


def _flat_batch(ct: LweCiphertext) -> int:
    B = 1
    for s in ct.batch_shape:
        B *= s
    return B


def gate2(name: str, x: LweCiphertext, y: LweCiphertext, cloud,
          mu: int = MU) -> LweCiphertext:
    """Generic bootstrapped 2-input gate; batch shapes must match."""
    shape = x.batch_shape
    B = _flat_batch(x)
    with span("tfhe.gate2", kind=name, batch=B):
        const, ca, cb = GATE_TABLE[name]
        t = _affine2(x.reshape(B), y.reshape(B), const, ca, cb)
        return bs.bootstrap(t, mu, cloud).reshape(shape)


def gate2_pair(name1: str, name2: str, x1, y1, x2, y2, cloud):
    """Compound gate: two gates, ONE batched bootstrap (paper section V-A3).

    Returns (out1, out2). The reference's bootsANDXOR_16 is
    gate2_pair('AND', 'XOR', a, b, a, b)."""
    shape = x1.batch_shape
    B = _flat_batch(x1)
    t1 = _affine2(x1.reshape(B), y1.reshape(B), *GATE_TABLE[name1])
    t2 = _affine2(x2.reshape(B), y2.reshape(B), *GATE_TABLE[name2])
    out = bs.bootstrap(lwe_concat([t1, t2]), MU, cloud)
    return out[:B].reshape(shape), out[B:].reshape(shape)


# ---- the classic named gates --------------------------------------------

def AND(x, y, cloud):   return gate2("AND", x, y, cloud)
def OR(x, y, cloud):    return gate2("OR", x, y, cloud)
def NAND(x, y, cloud):  return gate2("NAND", x, y, cloud)
def NOR(x, y, cloud):   return gate2("NOR", x, y, cloud)
def XOR(x, y, cloud):   return gate2("XOR", x, y, cloud)
def XNOR(x, y, cloud):  return gate2("XNOR", x, y, cloud)
def ANDNY(x, y, cloud): return gate2("ANDNY", x, y, cloud)
def ANDYN(x, y, cloud): return gate2("ANDYN", x, y, cloud)
def ORNY(x, y, cloud):  return gate2("ORNY", x, y, cloud)
def ORYN(x, y, cloud):  return gate2("ORYN", x, y, cloud)


def NOT(x: LweCiphertext, cloud=None) -> LweCiphertext:
    """Negation, no bootstrap (ref boot-gates.cu:244-249)."""
    return lwe_negate(x)


def COPY(x: LweCiphertext, cloud=None) -> LweCiphertext:
    return LweCiphertext(x.a, x.b, x.cv)


def CONSTANT(value, n: int, batch_shape=(), *, device) -> LweCiphertext:
    """Trivial ciphertext of boolean constants on `device` (ref
    boot-gates.cu:265-270). A scalar is filled there; an array of bits goes
    there through the content cache (``core/lwe.plan_tensor``), so a circuit
    that is captured as a CUDA graph copies nothing from the host."""
    if np.ndim(value) == 0:
        mu = _1_8 if value else -_1_8
    else:
        mu = np.where(np.asarray(value) != 0, _1_8, -_1_8).astype(np.int32)
    return noiseless_trivial(mu, n, batch_shape, device=device)


def MUX(a: LweCiphertext, b: LweCiphertext, c: LweCiphertext, cloud) -> LweCiphertext:
    """a ? b : c with two bootstraps batched as ONE blind rotate and one key
    switch (ref bootsMUX, boot-gates.cu:403-448; fused GPU variant :2631-2843)."""
    shape = a.batch_shape
    B = _flat_batch(a)
    af, bf, cf = a.reshape(B), b.reshape(B), c.reshape(B)
    # AND(a, b) image and AND(not a, c) image
    t1 = _affine2(af, bf, -_1_8, 1, 1)
    t2 = _affine2(af, cf, -_1_8, -1, 1)
    # one key switch of temp = (0, 1/8) + u1 + u2 over the extracted params
    return bs.bootstrap_paired(lwe_concat([t1, t2]), MU, cloud, B, _1_8).reshape(shape)


# ---- 3-input bootstrapped gates ------------------------------------------
#
# For three bit samples at +-1/8 the affine a+b+c has phase (2k-3)/8 for k
# ones, so its sign is the majority (the full-adder carry), and 2*(a+b+c)
# has phase (2k-3)/4, whose sign is the negated 3-way parity (the full-adder
# sum, up to a free negation): a full adder costs 2 bootstraps.

def _affine3(x: LweCiphertext, y: LweCiphertext, z: LweCiphertext,
             const: int, ca: int, cb: int, cc: int) -> LweCiphertext:
    """(0, const) + ca*x + cb*y + cc*z with int32 wrap."""
    a = ca * x.a + cb * y.a + cc * z.a
    b = const + ca * x.b + cb * y.b + cc * z.b
    cv = float(ca * ca) * x.cv + float(cb * cb) * y.cv + float(cc * cc) * z.cv
    return LweCiphertext(a, b, cv)


def MAJ(x: LweCiphertext, y: LweCiphertext, z: LweCiphertext, cloud) -> LweCiphertext:
    """Majority of three bits in one bootstrap: sign(a+b+c)."""
    shape = x.batch_shape
    B = _flat_batch(x)
    t = _affine3(x.reshape(B), y.reshape(B), z.reshape(B), 0, 1, 1, 1)
    return bs.bootstrap(t, MU, cloud).reshape(shape)


def XOR3(x: LweCiphertext, y: LweCiphertext, z: LweCiphertext, cloud) -> LweCiphertext:
    """3-way parity in one bootstrap: not(sign(2*(a+b+c)))."""
    shape = x.batch_shape
    B = _flat_batch(x)
    t = _affine3(x.reshape(B), y.reshape(B), z.reshape(B), 0, 2, 2, 2)
    return lwe_negate(bs.bootstrap(t, MU, cloud)).reshape(shape)


def full_adder(a: LweCiphertext, b: LweCiphertext, cin: LweCiphertext, cloud):
    """(sum, carry) of a+b+cin: the carry image a+b+c and the sum image
    2*(a+b+c) ride one bootstrap batch of 2B and one key switch; the sum
    half is negated afterwards (free)."""
    shape = a.batch_shape
    B = _flat_batch(a)
    af, bf, cf = a.reshape(B), b.reshape(B), cin.reshape(B)
    u_c = _affine3(af, bf, cf, 0, 1, 1, 1)
    u_s = _affine3(af, bf, cf, 0, 2, 2, 2)
    out = bs.bootstrap(lwe_concat([u_c, u_s]), MU, cloud)
    return lwe_negate(out[B:]).reshape(shape), out[:B].reshape(shape)


# ---- 7:3 column compressors at +-1/16 -------------------------------------
#
# At amplitude +-1/16 (MU16) the affine sum of seven bit samples has phase
# (2k-7)/16 for k ones, and the three binary digits of the popcount k come
# out of the same sum under the coefficient ladder 1, 2, 4:
#     sign(1*u) = bit2 (k >= 4),  sign(2*u) = NOT bit1,  sign(4*u) = NOT bit0
# so a 7:3 compressor costs three bootstraps; the NOTs are free (a negative
# output amplitude in the shared batch).

def trivial16_zero(n: int, batch_shape=(), *, device) -> LweCiphertext:
    """Trivial '0' at amplitude 1/16 (phase -1/16): the compressor's padding
    slot."""
    return noiseless_trivial(-MU16, n, batch_shape, device=device)


def bootstrap_images(t: LweCiphertext, mu, cloud) -> LweCiphertext:
    """Bootstrap a flat batch of prepared gate images in one batch.

    t: flat [M] affine images; mu: int32 [M] per-image output amplitude
    (numpy, put on the device by plan_tensor, or a tensor on t's device; a
    negative amplitude folds a NOT into the test vector)."""
    if not isinstance(mu, torch.Tensor):
        mu = plan_tensor(np.asarray(mu, np.int32), t.device)
    return bs.bootstrap(t, mu, cloud)


def full_adder16(a: LweCiphertext, b: LweCiphertext, cin: LweCiphertext,
                 cloud, mu_sum: int = MU16, mu_carry: int = MU16):
    """(sum, carry) of three +-1/16 bits in one bootstrap batch:
    carry = sign(u), sum = NOT sign(4u), the NOT folded into amplitude
    -mu_sum. mu_sum = MU re-encodes the sum to the standard +-1/8."""
    shape = a.batch_shape
    B = _flat_batch(a)
    af, bf, cf = a.reshape(B), b.reshape(B), cin.reshape(B)
    u_c = _affine3(af, bf, cf, 0, 1, 1, 1)
    u_s = _affine3(af, bf, cf, 0, 4, 4, 4)
    mu = torch.cat([torch.full((B,), mu_carry, dtype=torch.int32, device=a.device),
                    torch.full((B,), -mu_sum, dtype=torch.int32, device=a.device)])
    out = bs.bootstrap(lwe_concat([u_c, u_s]), mu, cloud)
    return out[B:].reshape(shape), out[:B].reshape(shape)


# ---- fused parallel-prefix combine level ---------------------------------

def prefix_combine(g_hi, g_lo, p_hi, p_lo, cloud):
    """(g, p) o (g', p'), the carry-operator combine of parallel-prefix
    adders and comparators: g' = MUX(p_hi, g_lo, g_hi), p' = p_hi AND p_lo.
    The two MUX halves and the p AND ride one bootstrap batch of 3B; the
    MUX halves are summed, and everything key-switches together."""
    shape = g_hi.batch_shape
    B = _flat_batch(g_hi)
    gif, gsf, pif, psf = (v.reshape(B) for v in (g_hi, g_lo, p_hi, p_lo))
    t1 = _affine2(pif, gsf, -_1_8, 1, 1)      # AND(p_hi, g_lo)
    t2 = _affine2(pif, gif, -_1_8, -1, 1)     # AND(not p_hi, g_hi)
    t3 = _affine2(pif, psf, -_1_8, 1, 1)      # AND(p_hi, p_lo)
    out = bs.bootstrap_paired(lwe_concat([t1, t2, t3]), MU, cloud, B, _1_8)
    return out[:B].reshape(shape), out[B:].reshape(shape)
