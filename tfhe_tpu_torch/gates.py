"""Bootstrapped boolean gate API (batched), on torch tensors.

Port of ``tfhe_tpu.gates`` for the classic gates of the reference
(`gpuParallel/boot-gates.cu:98-448`), the compound two-gate batch
(`bootsANDXOR_16`, paper section V-A3) and MUX (`boot-gates.cu:2631-2843`).
A gate is an affine combination of its input batches followed by one batched
bootstrap; arbitrary leading batch shapes are supported, and a batch of B
gates costs one bootstrap of batch B.
"""
from __future__ import annotations

import torch

from .core.lwe import LweCiphertext, lwe_concat, lwe_negate, noiseless_trivial
from .core import bootstrap as bs

# Torus constants (modSwitchToTorus32(x, Msize))
_1_8 = 1 << 29   # modSwitchToTorus32(1, 8)
_1_4 = 1 << 30   # modSwitchToTorus32(1, 4)
MU = _1_8        # output amplitude of every bootstrapped gate

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
    const, ca, cb = GATE_TABLE[name]
    shape = x.batch_shape
    B = _flat_batch(x)
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


def CONSTANT(value, n: int, batch_shape=(), device="cpu") -> LweCiphertext:
    """Trivial ciphertext of a boolean constant (ref boot-gates.cu:265-270)."""
    value = torch.as_tensor(value, dtype=torch.int32, device=device)
    mu = torch.where(value != 0, _1_8, -_1_8).to(torch.int32)
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
    a_ext, b_ext, cv = bs.bootstrap_woks(lwe_concat([t1, t2]), MU, cloud)
    # temp = (0, 1/8) + u1 + u2 over the extracted params, then one key switch
    out = bs.key_switch(a_ext[:B] + a_ext[B:], _1_8 + b_ext[:B] + b_ext[B:],
                        cloud.ks_table, cv[:B] + cv[B:], cloud.params)
    return out.reshape(shape)
