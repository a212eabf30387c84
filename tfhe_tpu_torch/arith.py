"""Encrypted integer arithmetic circuits (batched, LSB-first, two's complement).

Port of ``tfhe_tpu.arith``, circuit for circuit and bootstrap for bootstrap,
so every output is byte-equal to ``tfhe_tpu``'s for the same keys and inputs:
- bitwise ripple adder        <- taskLevelParallelAdd_bitwise (main.cu:821-890)
- number-wise carry-save add  <- taskLevelParallelAdd (main.cu:619-652)
- two's complement            <- twosComplement (cpuParallel/Cipher.cpp:300-311)
- subtraction                 <- operator- (Cipher.cpp:342-345)
- shift-and-add multiplier    <- multiplyLweSamples (main.cu:1483-1579), with
                                 the triangle AND matrix in one bootstrap batch
                                 and a carry-save reduction
- comparison (>, <=, ==)      <- Cipher.cpp:597-644
- minimum / compare_bit       <- Cipher.cpp:313-340
- absolute                    <- Cipher.cpp:483-505
- division (restoring)        <- divInternal / operator/ (Cipher.cpp:508-558)
- addSign (cond. negate)      <- Cipher.cpp:560-577
- shifts                      <- leftShift/innerRightShift etc.

An n-bit integer is an LweCiphertext batch with trailing axis nbits (bit i =
2^i). All circuits accept arbitrary leading batch shapes. At one number per
batch every stage is a small bootstrap, which ``core.bootstrap`` sends
through the small-batch blind rotate (K5). The index plans are static numpy
arrays; ``lwe_take`` puts each on the device once. On the card each
decorated circuit is captured whole as a CUDA graph and replayed
(``circuit``).
"""
from __future__ import annotations

import collections
import functools
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from . import gates
from .config import circuit_jit_enabled, policy_fingerprint
from .core.keys import CloudKey
from .core.lwe import LweCiphertext, keeping, lwe_concat, lwe_stack, lwe_take
from .ops import cmux
from .numeric import wrap_i32
from .params import TfheParams
from .utils.profiling import NO_SPAN, span

_1_8 = gates._1_8


# --------------------------------------------------------------- encode / io

def encrypt_int(sk, value, nbits: int, generator: torch.Generator, device) -> LweCiphertext:
    """Encrypt integers as nbits LSB-first encrypted bits on `device`
    (ref convertNumberToBits, main.cu:524-548). value: int or int array."""
    from .core.crypt import encrypt_bits
    value = np.asarray(value, np.int64)
    bits = (value[..., None] >> np.arange(nbits)) & 1
    return encrypt_bits(sk, bits.astype(np.int32), generator, device)


def decrypt_int(sk, ct: LweCiphertext, signed: bool = True) -> np.ndarray:
    """Decrypt an integer ciphertext (ref decryptCheck, main.cu:2203-2222)."""
    from .core.crypt import decrypt_bits
    bits = decrypt_bits(sk, ct).astype(np.int64)
    nbits = bits.shape[-1]
    val = np.sum(bits * (1 << np.arange(nbits)), axis=-1)
    if signed:
        val = val - (bits[..., -1] << nbits)
    return val


def trivial_bits(bits, n: int, batch_shape=None, *, device) -> LweCiphertext:
    """Noiseless trivial encryption of constant bits (default: keep shape)."""
    bits = np.asarray(bits, np.int32)
    if batch_shape is None:
        batch_shape = bits.shape
    return gates.CONSTANT(np.broadcast_to(bits, batch_shape), n, batch_shape, device=device)


def zero_like_bits(x: LweCiphertext, batch_shape) -> LweCiphertext:
    return gates.CONSTANT(0, x.n, batch_shape, device=x.device)


# ------------------------------------------------------- whole-circuit graphs

# The capture rule: a call whose ciphertext arguments hold more samples than
# this, all together, runs eagerly. Measured on an H100 (700 W) at PARAMS_110
# by chip_smoke.py's [graph] phase (PERF.md): a replay of a 16-bit add saves
# 2.2-3.0 ms (0.14-0.19 ms a stage) at every batch, the time eager launches
# leave the card idle (1 number 33.6 -> 31.1 ms; 32 numbers, 1,024 input
# samples, 43.8 -> 41.5; 128 numbers 107.2 -> 104.3), while the pool a
# graph keeps grows with the batch: 199 MB for a multiply of 32
# numbers (1,024 input samples; 333.5 -> 330.6 ms), about the peak of its
# opening AND batch. Above 1,024 the memory outgrows the saving: an 8x8
# matmul (2,048 input samples) runs 4.7 s with the card 0.1 % idle.
CAPTURE_MAX_BATCH = 1024
# Eager calls of a key before its capture, the first of them the warm-up. A
# capture costs C more than an eager call (the host's pass through the
# circuit, the graph's instantiation, then one replay) and each replay saves
# s; capturing once the eager calls have forgone about C (after C / s of them)
# never costs more than twice what the best choice in hindsight would, however
# often the key comes back. Measured on an H100 (700 W) at PARAMS_110 by
# chip_smoke.py's [graph] phase (PERF.md), C / s is 10-42 for the 16-bit
# CipherInt ops and the vector ops at 32 (add 22 / 2.1 ms, div 798 / 19 ms),
# 16-24 for most of them.
CAPTURE_AFTER = 16
# Keys remembered at once, graphs and keys not yet captured together; the
# least recently used goes first, and its graph with it. Under the capture
# rule a pool holds at most ~200 MB, so the graphs hold at most ~6.4 GB.
GRAPH_MAX = 32

_INSIDE = threading.local()      # depth of decorated calls on this thread


class CudaGraph:
    """One circuit captured as a ``torch.cuda.CUDAGraph`` on a card, with a
    memory pool of its own."""
    device_type = "cuda"

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.pool_bytes = 0

    def capture(self, run):
        """Records the launches of run() (none of them runs) and returns its
        outputs, which every replay writes. ``torch.cuda.graph`` synchronises,
        empties the allocator's cache and captures on a side stream, which
        is the current stream every kernel wrapper launches on meanwhile; what
        the capture allocates stays in the graph's pool (``pool_bytes``)."""
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph):
                before = torch.cuda.memory_reserved()
                out = run()
            self.pool_bytes = torch.cuda.memory_reserved() - before
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


def _weak(obj):
    """A weak reference to obj where it takes one, else a strong one."""
    try:
        return weakref.ref(obj)
    except TypeError:
        return lambda: obj


def _check_outputs(out) -> None:
    """A captured circuit returns a ciphertext or a tuple of them."""
    if not (isinstance(out, LweCiphertext) or (
            isinstance(out, tuple) and all(isinstance(o, LweCiphertext) for o in out))):
        raise TypeError(f"a captured circuit returns ciphertexts, not {type(out).__name__}")


def _clone(out):
    """Fresh copies of a circuit's outputs."""
    if isinstance(out, LweCiphertext):
        return LweCiphertext(out.a.clone(), out.b.clone(), out.cv.clone())
    return tuple(_clone(o) for o in out)


@dataclass
class _Entry:
    """A key's state: called `calls` times eagerly (graph None; its identity
    arguments held weakly), or captured (the graph, its static inputs and
    outputs, and the launches each replay makes). `held` maps the cache keys
    of the plans its eager calls and its capture read to the tensors
    (``core/lwe.keeping``)."""
    refs: tuple
    held: dict
    calls: int = 0
    graph: object = None
    inputs: list = None
    out: object = None
    launches: dict = None
    samples: dict = None


class CircuitGraphs:
    """The captured circuits of ``circuit``, by key, at most `max_graphs`
    keys (graphs and keys not yet captured together), least recently used out
    first.

    `graph` makes the graph of one capture on a device (``CudaGraph``; the
    tests pass a stand-in). A key's first `eager_calls` calls run eagerly. The
    first is the warm-up that loads the kernels' library, raises their
    shared-memory limits, reads the card's occupancy and puts the plans on the
    device, so the capture meets nothing but launches; the eager calls and the
    capture share one list of plans (``core/lwe.keeping``), which the graph
    keeps. The next call copies its ciphertexts into the graph's own input
    tensors, captures, and replays; every later call copies its ciphertexts
    in, replays and returns copies of the outputs, so two calls never share a
    result tensor. A capture that fails raises, and the key starts again from
    a first call. Calls are serialised by a lock; the replays of one graph are
    ordered on the stream of their calls. `counts` tallies the calls by what
    they did: first, eager (before the capture), capture, replay, and
    over_rule (eager, over CAPTURE_MAX_BATCH; counted by ``circuit``).
    `seconds` sums the host seconds of the first, eager and capture calls
    (a capture's with its first replay); replays are not timed."""

    def __init__(self, graph=CudaGraph, max_graphs: int = GRAPH_MAX,
                 eager_calls: int = CAPTURE_AFTER):
        self.graph = graph
        self.device_type = graph.device_type
        self.max_graphs = max_graphs
        self.eager_calls = eager_calls
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.counts = collections.Counter()
        self.seconds = collections.Counter()
        self.lock = threading.Lock()

    def graphs(self) -> int:
        """How many graphs are held."""
        return sum(e.graph is not None for e in self.entries.values())

    def pool_bytes(self) -> int:
        """The device memory the held graphs' pools reserve."""
        return sum(e.graph.pool_bytes for e in self.entries.values() if e.graph is not None)

    def call(self, f, args: tuple, key: tuple, by_id: list, device: torch.device,
             sp=NO_SPAN):
        """f(*args) through the graph of `key`; `by_id` are the arguments the
        key names by identity (the cloud key), which a graph holds. The mode
        of the call is set on `sp`, the caller's span."""
        with self.lock:
            t0 = time.perf_counter()
            entry = self.entries.get(key)
            if entry is not None and entry.graph is None and not all(
                    r() is a for r, a in zip(entry.refs, by_id)):
                entry = None              # an object of an eager call died; its id was reused
            if entry is None:
                entry = _Entry(tuple(_weak(a) for a in by_id), {})
                self._remember(key, entry)
                self.counts["first"] += 1
            else:
                self.entries.move_to_end(key)
            if entry.graph is None and entry.calls < self.eager_calls:
                entry.calls += 1
                self.counts["eager"] += entry.calls > 1
                mode = "first" if entry.calls == 1 else "eager"
                sp.set(mode=mode)
                try:
                    with keeping(entry.held):
                        return f(*args)
                finally:
                    self.seconds[mode] += time.perf_counter() - t0
            if entry.graph is not None:
                self.counts["replay"] += 1
                sp.set(mode="replay")
                return self._replay(entry, args)
            sp.set(mode="capture")
            entry = self._capture(f, args, key, entry, tuple(by_id), device)
            self.counts["capture"] += 1
            out = self._replay(entry, args)
            self.seconds["capture"] += time.perf_counter() - t0
            return out

    def _remember(self, key: tuple, entry: _Entry) -> None:
        self.entries[key] = entry
        while len(self.entries) > self.max_graphs:
            self.entries.popitem(last=False)

    def _capture(self, f, args, key, warm: _Entry, refs, device) -> _Entry:
        inputs = [LweCiphertext(*(t.clone(memory_format=torch.contiguous_format)
                                  for t in (a.a, a.b, a.cv)))
                  if isinstance(a, LweCiphertext) else None for a in args]
        static = [s if s is not None else a for s, a in zip(inputs, args)]
        graph = self.graph(device)
        launches, samples = dict(cmux.LAUNCHES), dict(cmux.SAMPLES)
        try:
            with span("tfhe.circuit.capture"), keeping(warm.held):
                out = graph.capture(lambda: f(*static))
        except BaseException:
            del self.entries[key]             # the next call is a first call: eager, a warm-up
            raise
        finally:
            # the capture ran nothing: what the wrappers counted, each replay launches
            d_launches = {k: cmux.LAUNCHES[k] - v for k, v in launches.items()}
            d_samples = {k: cmux.SAMPLES[k] - v for k, v in samples.items()}
            cmux.LAUNCHES.update(launches)
            cmux.SAMPLES.update(samples)
        _check_outputs(out)
        entry = _Entry(refs, warm.held, warm.calls, graph, inputs, out, d_launches, d_samples)
        self._remember(key, entry)
        return entry

    def _replay(self, entry: _Entry, args):
        for s, a in zip(entry.inputs, args):
            if s is not None:
                s.a.copy_(a.a)
                s.b.copy_(a.b)
                s.cv.copy_(a.cv)
        with span("tfhe.circuit.launch"):
            entry.graph.replay()
        for k, v in entry.launches.items():
            cmux.LAUNCHES[k] += v
            cmux.SAMPLES[k] += entry.samples[k]
        return _clone(entry.out)


# The graphs of every decorated circuit in this process.
GRAPHS = CircuitGraphs()


def circuit_key(f, args: tuple, static_argnums, device: torch.device):
    """The key of a call of circuit f, and the arguments it names by identity:
    f; the policy fingerprint (``config.policy_fingerprint``, with the batch
    cap of the cloud key on `device`); the device, shape and dtype of every
    tensor of each ciphertext argument; the value of each argument at
    `static_argnums`; every other argument (the cloud key) by identity."""
    parts, by_id, cloud = [], [], None
    for i, a in enumerate(args):
        if isinstance(a, LweCiphertext):
            parts.append(tuple((str(t.device), tuple(t.shape), t.dtype) for t in (a.a, a.b, a.cv)))
        elif i in static_argnums:
            parts.append(("static", a))
        elif isinstance(a, (bool, int, float, np.number)):
            raise TypeError(f"{f.__qualname__}: argument {i} is the number {a!r}; a captured "
                            f"circuit takes numbers only at its static_argnums")
        else:
            parts.append(("id", id(a)))
            by_id.append(a)
            if isinstance(a, CloudKey):
                cloud = a
    return (f, policy_fingerprint(device, cloud), tuple(parts)), by_id


def _graph_device(args: tuple):
    """(device, None): the device a call is captured on; or (None, why) when
    it runs eagerly, why "off" (no ciphertext argument, tensors the graphs
    cannot hold: CPU tensors, for a CUDA graph has no CPU meaning; the flag
    off, ``config.circuit_jit_enabled``) or "over_rule" (more than
    CAPTURE_MAX_BATCH samples in its ciphertexts; counted in
    ``GRAPHS.counts["over_rule"]``)."""
    cts = [a for a in args if isinstance(a, LweCiphertext)]
    if not cts:
        return None, "off"
    device = cts[0].device
    if device.type != GRAPHS.device_type or not circuit_jit_enabled(device):
        return None, "off"
    if sum(c.b.numel() for c in cts) > CAPTURE_MAX_BATCH:
        GRAPHS.counts["over_rule"] += 1
        return None, "over_rule"
    return device, None


def circuit(fn=None, *, static_argnums=()):
    """A whole integer circuit as one CUDA graph, as ``tfhe_tpu.arith.circuit``
    traces one into one XLA program: every gate batch, kernel launch and
    affine step between them is captured once per key (``circuit_key``) and
    replayed on every later call (``CircuitGraphs``), so a serial circuit's
    stages no longer wait for the host to enqueue some 70 small launches each.

    Eager instead, as ``tfhe_tpu`` runs eagerly: calls with keyword
    arguments; calls made inside another decorated call (its eager runs or
    its capture), which the outer call's graph takes in, as a nested
    ``jax.jit`` is inlined; CPU tensors; TFHE_TPU_CIRCUIT_JIT=0; a key's first
    CAPTURE_AFTER calls, which repay the capture's cost before it is paid;
    calls over the capture rule (CAPTURE_MAX_BATCH). None of these changes a
    bit of the result. `static_argnums` name the positional arguments that are
    Python numbers, keyed by value (``mul_plain``'s constant, ``mul_full``'s
    width). An outer call is the span ``tfhe.circuit``, with the circuit's
    name and its mode: first, eager, capture, replay (``CircuitGraphs``),
    over_rule or off (eager, as ``_graph_device`` says)."""
    static = frozenset(static_argnums)

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if getattr(_INSIDE, "depth", 0):
                return f(*args, **kwargs)
            _INSIDE.depth = 1
            try:
                with span("tfhe.circuit", circuit=f.__qualname__) as sp:
                    device, why = (None, "off") if kwargs else _graph_device(args)
                    if device is None:
                        sp.set(mode=why)
                        return f(*args, **kwargs)
                    key, by_id = circuit_key(f, args, static, device)
                    return GRAPHS.call(f, args, key, by_id, device, sp)
            finally:
                _INSIDE.depth = 0
        return wrapper

    return deco(fn) if fn is not None else deco


# --------------------------------------------------------------- adders

def _latency_policy(numbers: int, nbits: int) -> bool:
    """Prefix-vs-ripple adder dispatch (config.lookahead_enabled).
    `numbers` = independent integers in the batch."""
    from .config import lookahead_enabled
    return lookahead_enabled(numbers, nbits)


def _latency_bound(a: LweCiphertext) -> bool:
    nbits = a.batch_shape[-1]
    return _latency_policy(gates._flat_batch(a) // max(nbits, 1), nbits)


@circuit
def add(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Bitwise ripple-carry adder (taskLevelParallelAdd_bitwise,
    main.cu:821-890) on the 2-bootstrap full adder: per bit one batched
    bootstrap (sum and carry images) and one key switch. The result has the
    same nbits (overflow dropped, as in the reference). With the prefix arm
    on, the Kogge-Stone adder (add_fast)."""
    if _latency_bound(a):
        return add_fast(a, b, cloud)
    nbits = a.batch_shape[-1]
    # bit 0: sum = XOR, carry = AND, one compound bootstrap
    c0, s0 = gates.gate2_pair("AND", "XOR", a[..., 0], b[..., 0], a[..., 0], b[..., 0], cloud)
    sums = [s0]
    carry = c0
    for i in range(1, nbits):
        si, carry = gates.full_adder(a[..., i], b[..., i], carry, cloud)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


@circuit
def add_fast(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Kogge-Stone parallel-prefix adder: log2(nbits)+2 batched stages
    instead of nbits dependent full-adder stages. Stage 0 computes
    (g, p) = (AND, XOR) in one compound bootstrap, each prefix level is one
    gates.prefix_combine, and the final sums are one XOR batch."""
    g, p = gates.gate2_pair("AND", "XOR", a, b, a, b, cloud)
    c = _prefix_carry_chain(g, p, cloud)
    # c_i is the carry OUT of bit i: sum_0 = p_0, sum_i = p_i ^ c_{i-1}
    s_rest = gates.XOR(p[..., 1:], c[..., :-1], cloud)
    return lwe_concat([p[..., :1], s_rest], axis=-1)


def _prefix_carry_chain(g: LweCiphertext, p: LweCiphertext, cloud) -> LweCiphertext:
    """Kogge-Stone all-prefix carries: c_i = carry out of bit i given the
    per-bit (generate, propagate). log2(nbits) fused levels."""
    nbits = g.batch_shape[-1]
    d = 1
    while d < nbits:
        g_new, p_new = gates.prefix_combine(
            g[..., d:], g[..., :-d], p[..., d:], p[..., :-d], cloud)
        g = lwe_concat([g[..., :d], g_new], axis=-1)
        p = lwe_concat([p[..., :d], p_new], axis=-1)
        d *= 2
    return g


def _cmp_carry_tree(g: LweCiphertext, p: LweCiphertext, cloud) -> LweCiphertext:
    """Final carry only (for comparisons): pairwise (g, p) combine tree,
    log2(nbits) levels of nbits/2^k fused combines."""
    while g.batch_shape[-1] > 1:
        R = g.batch_shape[-1]
        half = R // 2
        g2, p2 = gates.prefix_combine(
            g[..., 1:2 * half:2], g[..., 0:2 * half:2],
            p[..., 1:2 * half:2], p[..., 0:2 * half:2], cloud)
        if R % 2:
            g = lwe_concat([g2, g[..., 2 * half:]], axis=-1)
            p = lwe_concat([p2, p[..., 2 * half:]], axis=-1)
        else:
            g, p = g2, p2
    return g[..., 0]


def _or_scan_excl(x: LweCiphertext, cloud) -> LweCiphertext:
    """Exclusive running OR along the bit axis (Kogge-Stone inclusive scan
    shifted by one): r_i = x_0 | ... | x_{i-1}. log2(nbits) OR batches."""
    r = x
    nbits = x.batch_shape[-1]
    d = 1
    while d < nbits:
        r_new = gates.OR(r[..., d:], r[..., :-d], cloud)
        r = lwe_concat([r[..., :d], r_new], axis=-1)
        d *= 2
    zero = zero_like_bits(x, x.batch_shape[:-1] + (1,))
    return lwe_concat([zero, r[..., :-1]], axis=-1)


def _gpun_stage(result, tempb, cloud):
    """One carry-save iteration: compound ANDXOR, then the carry shift."""
    and_out, xor_out = gates.gate2_pair("AND", "XOR", result, tempb, result, tempb, cloud)
    # tempb = and_out << 1 with encrypted FALSE at bit 0 (main.cu:656-700)
    zero = zero_like_bits(result, result.batch_shape[:-1] + (1,))
    return xor_out, lwe_concat([zero, and_out[..., :-1]], axis=-1)


@circuit
def add_numberwise(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Number-wise carry-save adder (GPU_n, taskLevelParallelAdd
    main.cu:619-652): nbits iterations of one compound ANDXOR bootstrap over
    all bits."""
    result, tempb = a, b
    for _ in range(a.batch_shape[-1]):
        result, tempb = _gpun_stage(result, tempb, cloud)
    return result


@circuit
def twos_complement(a: LweCiphertext, cloud) -> LweCiphertext:
    """-a (ref twosComplement, Cipher.cpp:300-311): scan with a reach-one
    signal, one compound (XOR, OR) bootstrap per bit; the prefix arm uses
    the log-depth prefix-OR scan instead."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        return gates.XOR(a, _or_scan_excl(a, cloud), cloud)
    reach = zero_like_bits(a, a.batch_shape[:-1])
    outs = []
    for i in range(nbits):
        out_i, reach = gates.gate2_pair("XOR", "OR", a[..., i], reach, reach, a[..., i], cloud)
        outs.append(out_i)
    return lwe_stack(outs, axis=-1)


@circuit
def sub(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a - b = a + not(b) + 1: the complement folds into the ripple chain's
    carry-in (the NOT is a free negation). The prefix arm uses
    (g, p) = (a & ~b, a xnor b) with the carry-in folded into g_0 (a | ~b)."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        g0 = gates.ORYN(a[..., :1], b[..., :1], cloud)     # carry-in = 1
        c = _prefix_carry_chain(lwe_concat([g0, g[..., 1:]], axis=-1), p, cloud)
        s0 = gates.NOT(p[..., :1])                         # p_0 ^ 1, free
        s_rest = gates.XOR(p[..., 1:], c[..., :-1], cloud)
        return lwe_concat([s0, s_rest], axis=-1)
    nb = gates.NOT(b)
    carry = gates.CONSTANT(1, a.n, a.batch_shape[:-1], device=a.device)
    sums = []
    for i in range(nbits):
        si, carry = gates.full_adder(a[..., i], nb[..., i], carry, cloud)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


def left_shift(a: LweCiphertext, k: int) -> LweCiphertext:
    """a << k with trivial FALSE fill (ref leftShift..., main.cu:1359-1481)."""
    if k == 0:
        return a
    zero = zero_like_bits(a, a.batch_shape[:-1] + (k,))
    return lwe_concat([zero, a[..., :-k]], axis=-1)


def right_shift_arith(a: LweCiphertext, k: int, cloud=None) -> LweCiphertext:
    """Arithmetic right shift, sign-extended (ref innerRightShift,
    Cipher.cpp:455-481). With `cloud`, also the reference's negative-rounding
    correction (Cipher.cpp:470-480): add `sign ? 1 : 0`. Without `cloud` the
    shift is the bootstrap-free sign extension only (floor semantics)."""
    if k == 0:
        return a
    nbits = a.batch_shape[-1]
    sign = a[..., nbits - 1:nbits]
    exts = lwe_concat([sign] * k, axis=-1)
    shifted = lwe_concat([a[..., k:], exts], axis=-1)
    if cloud is None:
        return shifted
    one = gates.CONSTANT(1, a.n, sign.batch_shape, device=a.device)
    zero = gates.CONSTANT(0, a.n, sign.batch_shape, device=a.device)
    lsb = gates.MUX(sign, one, zero, cloud)               # sign ? 1 : 0
    to_add = lwe_concat(
        [lsb, zero_like_bits(a, a.batch_shape[:-1] + (nbits - 1,))], axis=-1)
    return add(shifted, to_add, cloud)


# --------------------------------------------------------------- multiplier

@circuit
def mul(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Shift-and-add multiplication, nbits-bit truncated result
    (ref multiplyLweSamples, main.cu:1483-1579): the triangle partial-product
    ANDs in one bootstrap batch, a carry-save reduction of the weighted
    product bits (_wallace_sum_bits), one final ripple add."""
    nbits = a.batch_shape[-1]
    ja, ib, cols = _mul_triangle(nbits)
    lhs = lwe_take(a, ja, axis=-1)                                  # [..., P]
    rhs = lwe_take(b, ib, axis=-1)
    sep = _septet_enabled(nbits, cloud.params)
    pp = gates.gate2("AND", lhs, rhs, cloud, mu=gates.MU16 if sep else gates.MU)
    return _wallace_sum_bits(pp, cols, nbits, cloud,
                             amp=np.full(len(cols), 16 if sep else 8))


def _mul_triangle(nbits: int):
    """Static (bit-of-a, bit-of-b, column) plan of a truncated nbits x nbits
    product: only pairs with i + j < nbits fall below the 2^nbits cut."""
    pairs = [(i, j) for i in range(nbits) for j in range(nbits - i)]
    return (np.array([j for (_, j) in pairs]),
            np.array([i for (i, _) in pairs]),
            np.array([i + j for (i, j) in pairs]))


@circuit
def dot(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Fused inner product along axis -2: sum_k a[..., k, :] * b[..., k, :]
    mod 2^nbits. All K products' partial-product ANDs run as one bootstrap
    batch, and the union of weighted product bits feeds one carry-save
    reduction with one final adder (ref BOOTS_matrixMultiplication,
    main.cu:2342-2462, multiplies, then sums)."""
    K, nbits = a.batch_shape[-2], a.batch_shape[-1]
    ja, ib, cols = _mul_triangle(nbits)
    lhs = lwe_take(a, ja, axis=-1)                     # [..., K, P]
    rhs = lwe_take(b, ib, axis=-1)
    sep = _septet_enabled(nbits, cloud.params)
    pp = gates.gate2("AND", lhs, rhs, cloud, mu=gates.MU16 if sep else gates.MU)
    lead = a.batch_shape[:-2]
    flat = pp.reshape(lead + (K * len(cols),))
    return _wallace_sum_bits(flat, np.tile(cols, K), nbits, cloud,
                             amp=np.full(K * len(cols), 16 if sep else 8))


def _dadda_targets(max_count: int):
    """Dadda's height sequence 2, 3, 4, 6, 9, 13, ...: each level compresses
    only down to the next target."""
    t = [2]
    while t[-1] < max_count:
        t.append((t[-1] * 3) // 2)
    return t


def _dadda_plan(cc: np.ndarray, nbits: int, target: int):
    """Static schedule of one Dadda level: per column (LSB first, counting
    the carries the level itself sends upward), just enough full adders and
    at most one half adder to bring the column to <= target. A half adder is
    a full adder whose third input is the trivial-zero slot (index -1)."""
    xi, yi, zi, keep = [], [], [], []
    carry_in = 0
    for c in range(nbits):
        idx = np.flatnonzero(cc == c)
        m = len(idx)
        r = max(0, m + carry_in - target)            # height excess to remove
        k_fa = min(r // 2, m // 3)
        k_ha = min(r - 2 * k_fa, (m - 3 * k_fa) // 2)
        p = 0
        for _ in range(k_fa):
            xi.append(idx[p]); yi.append(idx[p + 1]); zi.append(idx[p + 2])
            p += 3
        for _ in range(k_ha):
            xi.append(idx[p]); yi.append(idx[p + 1]); zi.append(-1)
            p += 2
        keep.extend(idx[p:])
        carry_in = k_fa + k_ha                       # new bits entering c+1
    return (np.array(xi, np.int64), np.array(yi, np.int64),
            np.array(zi, np.int64), np.array(keep, np.int64))


def _septet_enabled(nbits: int, params: TfheParams | None = None) -> bool:
    """7:3 compressor levels (config.septet_enabled), demoted to the
    full-adder domain when the active noise model certifies fewer than 5
    live +-1/16 inputs per image (utils.phasesim.max_live16)."""
    if params is not None:
        from .utils.phasesim import max_live16
        if max_live16(params) < 5:
            return False
    from .config import septet_enabled
    return septet_enabled(nbits)


def _wallace_sum_bits(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                      cloud, amp: np.ndarray | None = None) -> LweCiphertext:
    """Carry-save reduction of weighted bits to one number (+-1/8 outputs).

    cur: [..., M] encrypted bits; cc: static int[M] column of each bit;
    amp: static int[M] in {8, 16}, the amplitude class of each bit (None =
    all 8). Bits already at +-1/16 force the septet engine (the full-adder
    tree only takes +-1/8); otherwise the flag and noise model choose."""
    has16 = amp is not None and (np.asarray(amp) == 16).any()
    if has16 or _septet_enabled(nbits, cloud.params):
        return _wallace_sum_bits_septet(cur, cc, nbits, cloud, amp)
    return _wallace_sum_bits_fa(cur, cc, nbits, cloud)


def _lwe_scale(ct: LweCiphertext, k: int) -> LweCiphertext:
    """Public integer scaling (torus wrap); variance scales by k^2."""
    return LweCiphertext(k * ct.a, k * ct.b, float(k * k) * ct.cv)


def _lwe_slot_sum(ct: LweCiphertext) -> LweCiphertext:
    """Sum ciphertexts over the last batch axis (the compressor slot axis),
    mod 2^32."""
    return LweCiphertext(wrap_i32(ct.a.sum(dim=-2, dtype=torch.int64)),
                         wrap_i32(ct.b.sum(dim=-1, dtype=torch.int64)),
                         ct.cv.sum(dim=-1))


def _compress_level_plan(cc: np.ndarray, amp: np.ndarray, nbits: int,
                         max_live: int = 7):
    """Greedy static schedule of one septet-compressor level.

    Per column: bits at +-1/16 go 7 at a time into septets (>= 5 justifies a
    trivial-padded group), triples of the remainder into a +-1/16 full
    adder; bits at +-1/8 go through +-1/8 full adders whose outputs are
    emitted at +-1/16. A column stuck above 2 with a mix the rules cannot
    group converts its +-1/8 bits (half adder for a pair, recode bootstrap
    for a single). Returns (sept [G,7], fa16 [G,3], fa8 [G,3], rec8 [R],
    keep [K]) index lists; -1 marks a trivial-zero pad slot. max_live caps
    the live inputs of every +-1/16 group (utils.phasesim.max_live16)."""
    if max_live < 3:
        raise ValueError(f"no safe +-1/16 grouping exists at max_live={max_live}; "
                         "the active noise model cannot certify the compressor domain")
    sept, fa16, fa8, rec8, keep = [], [], [], [], []
    gsz = min(7, max_live)
    for c in range(nbits):
        i16 = list(np.flatnonzero((cc == c) & (amp == 16)))
        i8 = list(np.flatnonzero((cc == c) & (amp == 8)))
        grouped = False
        while max_live >= 5 and len(i16) >= 5:
            g, i16 = i16[:gsz], i16[gsz:]
            sept.append(g + [-1] * (7 - len(g)))
            grouped = True
        if len(i16) >= 3:
            fa16.append(i16[:3])
            i16 = i16[3:]
            grouped = True
        while len(i8) >= 3:
            fa8.append(i8[:3])
            i8 = i8[3:]
            grouped = True
        if not grouped and len(i16) + len(i8) > 2:
            if len(i8) >= 2:
                fa8.append(i8[:2] + [-1])
                i8 = i8[2:]
            elif len(i8) == 1:
                rec8.append(i8.pop())
        keep.extend(i16 + i8)
    return sept, fa16, fa8, rec8, keep


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _wallace_sum_bits_septet(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                             cloud, amp: np.ndarray | None) -> LweCiphertext:
    """7:3 compressor reduction: every level gathers its septet digit images
    (coefficients 1/2/4 over one 7-way affine), full-adder pairs and recodes
    into one flat bootstrap batch with per-image output amplitudes. Carries
    above column nbits-1 never become images (mod-2^nbits truncation)."""
    from .utils.phasesim import max_live16
    cap = max_live16(cloud.params)
    cc = np.asarray(cc)
    amp = (np.full(len(cc), 8) if amp is None else np.asarray(amp)).copy()
    while len(cc) and np.bincount(cc, minlength=nbits).max() > 2:
        sept, fa16, fa8, rec8, keep = _compress_level_plan(cc, amp, nbits, cap)
        M = len(cc)
        lead = cur.batch_shape[:-1]
        curz16 = lwe_concat(
            [cur, gates.trivial16_zero(cur.n, lead + (1,), device=cur.device)], axis=-1)
        curz8 = lwe_concat([cur, zero_like_bits(cur, lead + (1,))], axis=-1)
        parts, mus, ocols = [], [], []

        def emit(u, coeff, mu, cols, live):
            """Append scaled images for the live subset of a group batch."""
            lv = np.flatnonzero(live)
            if not lv.size:
                return
            sub_ = u if lv.size == u.batch_shape[-1] else lwe_take(u, lv, -1)
            parts.append(_lwe_scale(sub_, coeff) if coeff != 1 else sub_)
            mus.append(np.full(lv.size, mu, np.int32))
            ocols.append(np.asarray(cols)[lv])

        if sept:
            idx = np.asarray(sept)                     # [G, 7], -1 pads
            scols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz16, np.where(idx < 0, M, idx), -1))
            emit(u, 4, -gates.MU16, scols, scols < nbits)          # digit 0
            emit(u, 2, -gates.MU16, scols + 1, scols + 1 < nbits)  # digit 1
            emit(u, 1, +gates.MU16, scols + 2, scols + 2 < nbits)  # digit 2
        if fa16:
            idx = np.asarray(fa16)                     # [G, 3]
            fcols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz16, idx, -1))
            emit(u, 4, -gates.MU16, fcols, fcols < nbits)          # sum
            emit(u, 1, +gates.MU16, fcols + 1, fcols + 1 < nbits)  # carry
        if fa8:
            idx = np.asarray(fa8)                      # [G, 3], -1 pads
            fcols = cc[idx[:, 0]]
            u = _lwe_slot_sum(lwe_take(curz8, np.where(idx < 0, M, idx), -1))
            emit(u, 2, -gates.MU16, fcols, fcols < nbits)          # sum
            emit(u, 1, +gates.MU16, fcols + 1, fcols + 1 < nbits)  # carry
        if rec8:
            emit(lwe_take(cur, np.asarray(rec8), -1), 1, +gates.MU16,
                 cc[np.asarray(rec8)], np.ones(len(rec8), bool))
        if not parts:
            raise AssertionError("compressor level planned no work")

        big = lwe_concat(parts, axis=-1)
        Mimg = big.batch_shape[-1]
        Bl = _numel(lead)
        mu_img = np.concatenate(mus)
        out = gates.bootstrap_images(
            big.reshape((Bl * Mimg,)), np.tile(mu_img, Bl), cloud).reshape(lead + (Mimg,))
        keep = np.asarray(keep, np.int64)
        if keep.size:
            cur = lwe_concat([out, lwe_take(cur, keep, -1)], axis=-1)
            cc = np.concatenate([np.concatenate(ocols), cc[keep]])
            amp = np.concatenate([np.full(Mimg, 16), amp[keep]])
        else:
            cur, cc, amp = out, np.concatenate(ocols), np.full(Mimg, 16)

    if (amp == 8).all():
        # nothing entered the +-1/16 domain: the standard +-1/8 termination
        return _assemble_two_rows_add(cur, cc, nbits, cloud)

    if (amp == 8).any():
        # stray +-1/8 leftovers in otherwise converted columns: recode
        i8 = np.flatnonzero(amp == 8)
        lead = cur.batch_shape[:-1]
        Bl = _numel(lead)
        rec = gates.bootstrap_images(
            lwe_take(cur, i8, -1).reshape((Bl * i8.size,)),
            np.full(Bl * i8.size, gates.MU16, np.int32), cloud).reshape(lead + (i8.size,))
        keep = np.flatnonzero(amp == 16)
        cur = lwe_concat([rec, lwe_take(cur, keep, -1)], axis=-1)
        cc = np.concatenate([cc[i8], cc[keep]])

    # <= 2 bits per column, all +-1/16: one final ripple; the sum images are
    # emitted at +-1/8 so the result is standard-encoded for free
    r0, r1 = _two_row_plan(cc, nbits)
    lead = cur.batch_shape[:-1]
    curz = lwe_concat(
        [cur, gates.trivial16_zero(cur.n, lead + (1,), device=cur.device)], axis=-1)
    row0 = lwe_take(curz, r0, axis=-1)
    row1 = lwe_take(curz, r1, axis=-1)
    Bl = _numel(lead)
    if _latency_policy(Bl, nbits):
        # prefix arm: recode both rows to +-1/8 in one bootstrap batch, then
        # the log-depth prefix adder
        both = lwe_concat([row0, row1], axis=-1)
        rec = gates.bootstrap_images(
            both.reshape((Bl * 2 * nbits,)),
            np.full(Bl * 2 * nbits, gates.MU, np.int32), cloud).reshape(lead + (2 * nbits,))
        return add_fast(rec[..., :nbits], rec[..., nbits:], cloud)
    sums = []
    carry = gates.trivial16_zero(cur.n, lead, device=cur.device)
    for i in range(nbits):
        si, carry = gates.full_adder16(row0[..., i], row1[..., i], carry,
                                       cloud, mu_sum=gates.MU, mu_carry=gates.MU16)
        sums.append(si)
    return lwe_stack(sums, axis=-1)


def _two_row_plan(cc: np.ndarray, nbits: int):
    """Scatter M weighted bits (<= 2 per column) into two per-column row
    index vectors; index M is the pad slot (callers append their pad
    ciphertext at position M before gathering)."""
    M = len(cc)
    r0 = np.full(nbits, M, np.int64)
    r1 = np.full(nbits, M, np.int64)
    for p in range(M):
        c = cc[p]
        if r0[c] == M:
            r0[c] = p
        elif r1[c] == M:
            r1[c] = p
    return r0, r1


def _assemble_two_rows_add(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                           cloud) -> LweCiphertext:
    """Termination of both reductions when all bits are +-1/8: two
    trivial-zero-filled rows and one standard ripple add."""
    M = len(cc)
    r0, r1 = _two_row_plan(cc, nbits)
    curz = lwe_concat([cur, zero_like_bits(cur, cur.batch_shape[:-1] + (1,))], axis=-1)
    row0 = lwe_take(curz, r0, axis=-1)
    if (r1 == M).all():
        return row0
    return add(row0, lwe_take(curz, r1, axis=-1), cloud)


def _wallace_sum_bits_fa(cur: LweCiphertext, cc: np.ndarray, nbits: int,
                         cloud) -> LweCiphertext:
    """Dadda-tree carry-save reduction of weighted bits, then one final
    ripple add (ref log-tree accumulation, main.cu:1547-1569). Every level
    compresses all column triples with one batched gates.full_adder call
    (sum stays in its column, carry moves up one; carries out of column
    nbits-1 are dropped before they cost a bootstrap)."""
    targets = _dadda_targets(int(np.bincount(cc, minlength=nbits).max()))
    for target in reversed(targets[:-1] or [2]):
        if np.bincount(cc, minlength=nbits + 1).max() <= 2:
            break
        xi, yi, zi, keep = _dadda_plan(cc, nbits, target)
        if not xi.size:
            continue
        # z index -1 = trivial-zero slot (half adder as FA with zero carry-in)
        curz = lwe_concat([cur, zero_like_bits(cur, cur.batch_shape[:-1] + (1,))], axis=-1)
        s, c = gates.full_adder(lwe_take(cur, xi, -1), lwe_take(cur, yi, -1),
                                lwe_take(curz, zi, -1), cloud)
        scols = cc[xi]
        live = np.flatnonzero(scols + 1 < nbits)   # carries above nbits drop
        parts, ncc = [s], [scols]
        if live.size:
            parts.append(lwe_take(c, live, -1))
            ncc.append(scols[live] + 1)
        if keep.size:
            parts.append(lwe_take(cur, keep, -1))
            ncc.append(cc[keep])
        cur = lwe_concat(parts, axis=-1)
        cc = np.concatenate(ncc)
    if np.bincount(cc, minlength=nbits + 1).max() > 2:
        raise AssertionError("Dadda schedule under-delivered")
    return _assemble_two_rows_add(cur, cc, nbits, cloud)


def _csa_reduce_rows(rows: LweCiphertext, cloud) -> LweCiphertext:
    """Carry-save reduction of equal-width rows over axis -2: the rows
    flattened into (bit, column) pairs through _wallace_sum_bits."""
    R, nbits = rows.batch_shape[-2], rows.batch_shape[-1]
    if R == 1:
        return rows[..., 0, :]
    lead = rows.batch_shape[:-2]
    flat = rows.reshape(lead + (R * nbits,))
    cols = np.tile(np.arange(nbits), R)
    return _wallace_sum_bits(flat, cols, nbits, cloud)


def _tree_sum_rows(rows: LweCiphertext, add_fn, cloud) -> LweCiphertext:
    """Log-tree reduction over axis -2 (main.cu:1547-1569), keeping the rows
    as one tensor (halved by slicing each level)."""
    R = rows.batch_shape[-2]
    while R > 1:
        half = R // 2
        summed = add_fn(rows[..., :half, :], rows[..., half:2 * half, :], cloud)
        if R % 2:
            rows = lwe_concat([summed, rows[..., 2 * half:, :]], axis=-2)
        else:
            rows = summed
        R = (R + 1) // 2
    return rows[..., 0, :]


@circuit(static_argnums=(1,))
def mul_plain(a: LweCiphertext, value: int, cloud) -> LweCiphertext:
    """a * public integer constant, mod 2^nbits: the constant's set bits
    contribute copies of a's bits straight into the carry-save reduction, with
    no AND bootstraps."""
    nbits = a.batch_shape[-1]
    value = int(value) & ((1 << nbits) - 1)
    shifts = [s for s in range(nbits) if (value >> s) & 1]
    if not shifts:
        return zero_like_bits(a, a.batch_shape)
    if len(shifts) == 1:
        return left_shift(a, shifts[0])
    pairs = [(j, s + j) for s in shifts for j in range(nbits - s)]
    bits = lwe_take(a, np.array([j for (j, _) in pairs]), axis=-1)
    cols = np.array([c for (_, c) in pairs])
    return _wallace_sum_bits(bits, cols, nbits, cloud)


@circuit
def mul_mux(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """MUX-based shift-and-add multiplier (ref Cipher::mul,
    cpuParallel/Cipher.cpp:126-176): partial product i is MUX(b_i, a << i, 0)
    (one batched MUX for the whole triangle), then the same reduction."""
    nbits = a.batch_shape[-1]
    pairs = [(i, j) for i in range(nbits) for j in range(nbits - i)]
    sel = lwe_take(b, np.array([i for (i, _) in pairs]), axis=-1)   # [..., P]
    val = lwe_take(a, np.array([j for (_, j) in pairs]), axis=-1)
    zeros = zero_like_bits(a, val.batch_shape)
    ppm = gates.MUX(sel, val, zeros, cloud)                         # [..., P]
    cols = np.array([i + j for (i, j) in pairs])
    return _wallace_sum_bits(ppm, cols, nbits, cloud)


@circuit(static_argnums=(3,))
def mul_full(a: LweCiphertext, b: LweCiphertext, cloud, out_bits: int) -> LweCiphertext:
    """Shift-and-add multiply with an explicit output width (zero-extends
    the inputs)."""
    nbits = a.batch_shape[-1]
    pad = out_bits - nbits
    if pad > 0:
        za = zero_like_bits(a, a.batch_shape[:-1] + (pad,))
        a = lwe_concat([a, za], axis=-1)
        b = lwe_concat([b, za], axis=-1)
    return mul(a, b, cloud)


@circuit
def mul_karatsuba(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Karatsuba multiplication (ref karatMasterSuba, main.cu:1867-2089):
    the three half-multiplies (a0*b0, a1*b1, (a0+a1)*(b0+b1)) as one batched
    multiply, then result = d1*2^2h + (d2-d1-d0)*2^h + d0, truncated."""
    nbits = a.batch_shape[-1]
    if nbits % 2:
        raise ValueError("karatsuba needs an even bit width")
    h = nbits // 2
    w = nbits + 2                      # width that fits (a0+a1)*(b0+b1)
    a0, a1 = a[..., :h], a[..., h:]
    b0, b1 = b[..., :h], b[..., h:]

    def zext(x, width):
        pad = width - x.batch_shape[-1]
        return lwe_concat([x, zero_like_bits(x, x.batch_shape[:-1] + (pad,))], axis=-1)

    sa = add(zext(a0, h + 1), zext(a1, h + 1), cloud)      # a0 + a1, h+1 bits
    sb = add(zext(b0, h + 1), zext(b1, h + 1), cloud)
    lhs = lwe_stack([zext(a0, w), zext(a1, w), zext(sa, w)], axis=-2)
    rhs = lwe_stack([zext(b0, w), zext(b1, w), zext(sb, w)], axis=-2)
    prods = mul(lhs, rhs, cloud)                           # [..., 3, w]
    d0, d1, d2 = prods[..., 0, :], prods[..., 1, :], prods[..., 2, :]
    mid = sub(sub(d2, d1, cloud), d0, cloud)               # d2 - d1 - d0
    # result (mod 2^nbits) = d0 + mid<<h + d1<<2h; 2h >= nbits so d1 drops out
    return add(d0[..., :nbits],
               left_shift(mid[..., :nbits], h)[..., :nbits] if h else mid[..., :nbits],
               cloud)


# --------------------------------------------------------------- comparisons

def compare_bit(result, ai, bi, cloud):
    """One comparator stage (ref Cipher::compare_bit, Cipher.cpp:335-340):
    MUX(XNOR(a, b), result, a) == MAJ(a, not b, result), one bootstrap."""
    return gates.MAJ(ai, gates.NOT(bi), result, cloud)


@circuit
def minimum(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Minimum of two positive numbers (ref minimum, Cipher.cpp:313-333)."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        cmp = _cmp_carry_tree(g, p, cloud)                 # unsigned a > b
    else:
        cmp = zero_like_bits(a, a.batch_shape[:-1])
        for i in range(nbits):
            cmp = compare_bit(cmp, a[..., i], b[..., i], cloud)
    cmps = lwe_stack([cmp] * nbits, axis=-1)
    return gates.MUX(cmps, b, a, cloud)


@circuit
def gt(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Signed a > b -> 1-bit ciphertext (ref Cipher::operator>,
    Cipher.cpp:597-608): each stage cin' = MAJ(a, not b, cin), one bootstrap,
    and the signed fixup (a_msb ^ b_msb) ^ cin is one XOR3. The prefix arm
    reduces the carry with the pairwise (g, p) combine tree."""
    nbits = a.batch_shape[-1]
    if _latency_bound(a):
        g, p = gates.gate2_pair("ANDYN", "XNOR", a, b, a, b, cloud)
        cin = _cmp_carry_tree(g, p, cloud)
    else:
        cin = zero_like_bits(a, a.batch_shape[:-1])
        for i in range(nbits):
            cin = gates.MAJ(a[..., i], gates.NOT(b[..., i]), cin, cloud)
    return gates.XOR3(a[..., nbits - 1], b[..., nbits - 1], cin, cloud)


@circuit
def le(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a <= b (ref Cipher::operator<=, Cipher.cpp:610-614)."""
    return gates.NOT(gt(a, b, cloud))


@circuit
def eq(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """a == b (ref Cipher::operator==, Cipher.cpp:633-644), with a log-depth
    OR tree instead of the reference's sequential OR chain."""
    x = gates.XOR(a, b, cloud)                             # [..., nbits]
    R = x.batch_shape[-1]
    while R > 1:
        half = R // 2
        ored = gates.OR(x[..., :half], x[..., half:2 * half], cloud)
        x = lwe_concat([ored, x[..., 2 * half:]], axis=-1) if R % 2 else ored
        R = (R + 1) // 2
    return gates.NOT(x[..., 0])


# --------------------------------------------------------------- signed ops

@circuit
def absolute(a: LweCiphertext, cloud) -> LweCiphertext:
    """|a| (ref absolute, Cipher.cpp:483-505): (a + sign_mask) ^ sign_mask."""
    nbits = a.batch_shape[-1]
    sign = a[..., nbits - 1]
    mask = lwe_stack([sign] * nbits, axis=-1)
    res = add(mask, a, cloud)
    return gates.XOR(res, mask, cloud)


@circuit
def add_sign(x: LweCiphertext, sign, cloud) -> LweCiphertext:
    """Conditionally negate x when sign == 1 (ref addSign, Cipher.cpp:560-577)."""
    nbits = x.batch_shape[-1]
    if _latency_bound(x):
        res = gates.XOR(x, _or_scan_excl(x, cloud), cloud)
    else:
        reach = zero_like_bits(x, x.batch_shape[:-1])
        result = []
        for i in range(nbits - 1):
            r_i = gates.XOR(x[..., i], reach, cloud)
            reach = gates.OR(reach, x[..., i], cloud)
            result.append(r_i)
        result.append(gates.XOR(x[..., nbits - 1], reach, cloud))
        res = lwe_stack(result, axis=-1)
    signs = lwe_stack([sign] * nbits, axis=-1)
    return gates.MUX(signs, res, x, cloud)


@circuit
def div(a: LweCiphertext, b: LweCiphertext, cloud) -> LweCiphertext:
    """Signed division by restoring division on absolutes (ref operator/ and
    divInternal, Cipher.cpp:508-558), with -|b| hoisted out of the loop."""
    nbits = a.batch_shape[-1]
    abs_a = absolute(a, cloud)
    abs_b = absolute(b, cloud)
    neg_b = twos_complement(abs_b, cloud)
    # PA register: [remainder(nbits) | quotient-in-progress], LSB half = abs_a
    pa_lo = abs_a                                  # bits [0, nbits)
    pa_hi = zero_like_bits(a, a.batch_shape)       # bits [nbits, 2nbits)
    for _ in range(nbits):
        # PA <<= 1 across the 2*nbits register
        pa_hi = lwe_concat([pa_lo[..., nbits - 1:nbits], pa_hi[..., :-1]], axis=-1)
        zero1 = zero_like_bits(a, a.batch_shape[:-1] + (1,))
        pa_lo = lwe_concat([zero1, pa_lo[..., :-1]], axis=-1)
        temp_p = add(pa_hi, neg_b, cloud)
        neg = temp_p[..., nbits - 1]               # 1 if tempP < 0
        bit = gates.NOT(neg)
        pa_lo = lwe_concat([bit.reshape(bit.batch_shape + (1,)), pa_lo[..., 1:]], axis=-1)
        negs = lwe_stack([neg] * nbits, axis=-1)
        pa_hi = gates.MUX(negs, pa_hi, temp_p, cloud)
    quotient = pa_lo
    sign = gates.XOR(a[..., nbits - 1], b[..., nbits - 1], cloud)
    return add_sign(quotient, sign, cloud)
