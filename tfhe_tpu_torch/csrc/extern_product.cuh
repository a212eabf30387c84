// Device-side external product of the CMux for a block that holds S whole
// samples: the shared body of cmux_delta_kernel and blind_rotate_kernel
// (cmux.cu). The transforms are those of ntt_passes.cuh, which
// blind_rotate_small.cu uses too.
//
// Replaces tfhe_tpu/ops/cmux_pallas.py:_ntt_extern_product (:246) and the
// helpers it calls: _fwd_rows (:79), _inv_rows (:110), _crt (:235) and
// _shoup/_umulhi (:42-56). For each of the block's S samples, with the signed
// gadget digits of the (k+1)*l rows as residues (l = 2 or 3, a template
// parameter; row r = c*l + d is level d of polynomial c), it computes per CRT prime
//   dhat_r = NTT(digits_r)
//   prod_c = sum_r dhat_r * bk[r, c]          (Shoup products, c = 0, 1)
//   res_c  = NTT^-1(prod_c)
// and lifts (res_c mod P1, res_c mod P2) to Torus32 with Garner's CRT.
// Exact integer math in uint32 with wraparound: the same bits as the TPU
// kernel and the plain-torch version.
//
// Translation: the TPU kernel puts the batch on the 128 lanes of a vector
// register and walks the butterflies of a row one after the other; here a
// thread owns 8 (forward) or 4 (multiply-accumulate, inverse) coefficients of
// one row of one sample, and the S samples of a block run the same phase
// side by side. The 16-bit-split _umulhi is __umulhi.
//
// What bounds it on an H100: the instruction rate. A step of one thread is about
// 2,400 SASS instructions for both primes (cuobjdump: half of them integer
// multiply-adds, a third adds, minima and selects, 15 % shared-memory loads
// and stores), where the butterflies and products alone are 1,056; bytes do
// not bound it as long as the key comes cheap. The design:
// - the two primes run one after the other through the same rows of shared
//   memory; prime 1's residues wait in registers for prime 2's, so the CRT
//   needs no exchange;
// - 8 barriers a prime and step (3 forward passes, the product, 4 inverse
//   passes at N = 1024), where one butterfly stage a barrier took about 22.
//   Only three of them are block barriers (before and after the product, and
//   before the next prime): a pass hands its row only to the threads of the
//   same row, which meet at a named barrier of their own (group_sync), so the
//   rows of a block drift apart and one's loads overlap another's arithmetic
//   (6.9 -> 6.6 ms at B = 256 when this went in);
// - twiddles of both primes (value and Shoup twin interleaved) and the 16
//   constants sit in shared memory from before the first step;
// - NBUF > 0: the key slice of one (step, prime), 2 x 32 KB at N = 1024 and
//   l = 2 (2 x 48 KB at l = 3), value and Shoup twin, arrives by two bulk
//   asynchronous copies that one thread starts (cp.async.bulk, completing
//   on an mbarrier with a byte count) into one of NBUF buffers, as soon as
//   the product that read the buffer last is over: the S samples share that
//   one read. The slice keeps the [N][2*(k+1)*l] layout of bk_rows. A thread
//   of the product reads the chunk of the l digit rows of one input
//   polynomial and both output polynomials at each of its 4 coefficients
//   (16 bytes at l = 2, 24 at l = 3) and uses all of it, then trades half of
//   its sums with the neighbouring lane that took the other polynomial's rows
//   (6.6 -> 6.1 ms against one output polynomial a thread, which read every
//   chunk twice and chose its half). Its lane is (coefficient group, input polynomial, sample) with the sample
//   fastest, so the samples' lanes read one address (a broadcast);
// - NBUF == 0: the product reads the key with 16-byte __ldg at the moment of
//   use; the blocks in flight keep the slice in L2. Less shared memory: two
//   blocks of one sample share an SM at N = 1024.
// At l = 3 a block still has N/2 threads a sample: the six digit rows of the
// forward passes are four row groups of N/8 threads, the first two of which
// also take rows 4 and 5 (the rows of a group meet at its named barrier).
// Tried and dropped, each slower on the card at PARAMS_110: four samples a
// block with one key buffer, two without buffers, an XOR swizzle of the rows
// that frees every pass of bank conflicts (one more instruction an access and
// registers spilled: 8.1 against 7.1 ms), 512 threads with two rows each.
#pragma once

#include <cstdint>

#include "ntt_passes.cuh"

namespace tfhe {

constexpr size_t kSmemMax = 232448;     // bytes of shared memory a block may use (sm_90)

// A transform row in shared memory: coefficient e at word e + 4*(e/32). Of
// the additive paddings within N/8 extra words this one leaves the fewest bank
// conflicts to the access patterns below at N = 1024 (the forward pass of
// stride 2 and the inverse pass of stride 16 stay two-way, the others are
// free; blind_rotate_small.cu's e + e/16 is two-way in every pass); as there,
// row_pad(base + j*u) = row_pad(base) + row_pad(j*u) for the coefficient sets
// of a pass, a constant offset once the pass is unrolled. A row has two words
// more than it needs and a sample one, which shift the banks of the next
// row and the next sample for the product's reads and writes.
__device__ __forceinline__ int row_pad(int e) { return e + ((e >> 5) << 2); }
__host__ __device__ constexpr int row_stride(int N) { return N + (N >> 3) + 2; }

// Threads and shared-memory layout (in 32-bit words) of a block that holds S
// samples of N = 2^LOGN coefficients at gadget length GL, with NBUF key
// buffers. A thread's work in a phase is 8 coefficients of one of a sample's
// 2*GL digit rows (forward; at GL = 3 two rows for the threads of rows 0 and
// 1), or 4 coefficients of one of its 2 output polynomials (product, inverse,
// CRT): N/2 threads a sample either way.
template <int LOGN, int GL, int S, int NBUF>
struct CmuxBlock {
  static constexpr int N = 1 << LOGN;
  static constexpr int KPL = kOut * GL;          // (k+1)*l digit rows
  static constexpr int RPT = (KPL + 3) / 4;      // forward rows a thread: four row groups a sample
  static constexpr int kNbuf = NBUF;
  static constexpr int RS = row_stride(N);
  static constexpr int SS = KPL * RS + 1;        // a sample's rows; + 1 shifts the next one's banks
  static constexpr int NT = S * (N >> 1);        // threads
  static constexpr int COLS = KPL * kOut;        // key words a coefficient: column r*2 + c
  static constexpr int SLICE = COLS * N;         // one (step, prime) of the key, value or Shoup twin
  static constexpr int KEY = 0;                  // [NBUF][value, twin][N][COLS]
  static constexpr int TW = KEY + NBUF * 2 * SLICE;   // uint2 [prime][forward, inverse][N]
  static constexpr int BARS = TW + 8 * N;        // one 64-bit barrier a key buffer (room for 2)
  static constexpr int CST = BARS + 4;           // the 16 constants
  static constexpr int ACC = CST + 16;           // [S][kOut][N] accumulators
  static constexpr int ROWS = ACC + S * kOut * N;     // [S] x SS: forward rows; rows 0-1 reused by the inverse
  static constexpr int WORDS = ROWS + S * SS;
  static constexpr size_t BYTES = sizeof(uint32_t) * (size_t)WORDS;
  static constexpr int EIGHTH = N >> 3, QUARTER = N >> 2, HALF = N >> 1;
  static constexpr int TAIL = LOGN % 3;          // forward stages left to the product's threads
  static constexpr uint32_t SLICE_BYTES = 4u * SLICE;
};

// A barrier of the THREADS consecutive threads (whole warps) that hold group
// `group` of a phase, where only they exchange data: the groups of a block
// then drift apart and one's loads overlap another's arithmetic. Named
// barriers `first` .. `first + GROUPS - 1`; the block barrier where a group is
// no whole warp or the 15 named barriers do not suffice.
template <int THREADS, int GROUPS>
__device__ __forceinline__ void group_sync(int first, int group) {
  if (THREADS % 32 == 0 && GROUPS > 1 && first + GROUPS <= 16) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(first + group), "r"(THREADS) : "memory");
  } else {
    __syncthreads();
  }
}

// Twiddles, constants and barriers into shared memory; ends without a block
// barrier (the caller has one before the first product).
template <class L>
__device__ __forceinline__ void cmux_block_setup(uint32_t* smem,
                                                 const uint32_t* __restrict__ tab) {
  constexpr int N = L::N;
  uint2* tw = reinterpret_cast<uint2*>(smem + L::TW);
  for (int i = threadIdx.x; i < kPrimes * N; i += L::NT) {
    const int pi = i / N, e = i % N;
    const uint32_t* t = tab + (size_t)pi * kTabRows * N;
    tw[(2 * pi) * N + e] = make_uint2(__ldg(t + e), __ldg(t + N + e));
    tw[(2 * pi + 1) * N + e] = make_uint2(__ldg(t + 2 * N + e), __ldg(t + 3 * N + e));
  }
  if (threadIdx.x < 16) {
    smem[L::CST + threadIdx.x] = __ldg(tab + (size_t)kPrimes * kTabRows * N + threadIdx.x);
  }
  if (threadIdx.x == 0) {
    for (int b = 0; b < L::kNbuf; ++b) mbar_init(shared_u32(smem + L::BARS + 2 * b), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// One thread: the key slice of use u = 2*step + prime (value and Shoup twin,
// each contiguous in bk_rows) into buffer u % NBUF, completing on its barrier.
template <class L>
__device__ __forceinline__ void cmux_fetch_key(uint32_t* smem, const uint32_t* __restrict__ bk,
                                               const uint32_t* __restrict__ bksh, int u, int uses) {
  if (L::kNbuf > 0 && threadIdx.x == 0 && u < uses) {
    const int buf = u % (L::kNbuf > 0 ? L::kNbuf : 1);
    const uint32_t bar = shared_u32(smem + L::BARS + 2 * buf);
    const uint32_t dst = shared_u32(smem + L::KEY + buf * 2 * L::SLICE);
    mbar_arrive_expect_tx(bar, 2u * L::SLICE_BYTES);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(dst), "l"(bk + (size_t)u * L::SLICE), "r"(L::SLICE_BYTES), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
            "r"(dst + L::SLICE_BYTES), "l"(bksh + (size_t)u * L::SLICE), "r"(L::SLICE_BYTES),
        "r"(bar)
        : "memory");
  }
}

// Garner CRT of (r1 mod P1, r2 mod P2) to the signed value mod 2^32;
// cst: the 16 constants.
__device__ __forceinline__ uint32_t crt(uint32_t r1, uint32_t r2, const uint32_t* cst) {
  const uint32_t P1 = cst[0], P2 = cst[5];
  const uint32_t r1p2 = r1 >= P2 ? r1 - P2 : r1;
  const uint32_t t = mulm(subm(r2, r1p2, P2), cst[10], cst[11], P2);
  const uint32_t rep = r1 + P1 * t;
  const bool upper = t > cst[12] || (t == cst[12] && r1 >= cst[13]);
  return upper ? rep - cst[14] : rep;
}

// The external product of step `step` of `steps` for the block's S samples.
//
// digits(s, row, q, p, v): this thread's forward work is row `row` of sample
// s; fills v[j] with the signed digit at coefficient q + j*N/8 as a residue
// mod p, in [0, 4p). It may read shared memory written before the last block
// barrier.
// bk/bksh: the whole key uint32[steps][kPrimes][N][4*GL], column r*2 + c.
// delta[j]: thread t holds polynomial (t / (N/4)) % 2 of sample t / (N/2),
// coefficient t % (N/4) + j*N/4.
// The caller puts a block barrier between its use of delta and the next call.
template <int LOGN, int GL, int S, int NBUF, class Digits>
__device__ __forceinline__ void extern_product(const Digits& digits, uint32_t* smem,
                                               const uint32_t* __restrict__ bk,
                                               const uint32_t* __restrict__ bksh, int step,
                                               int steps, uint32_t (&delta)[4]) {
  using L = CmuxBlock<LOGN, GL, S, NBUF>;
  constexpr int N = L::N, RS = L::RS, NT = L::NT;
  constexpr int RING = NBUF > 0 ? NBUF : 1;
  const int t = threadIdx.x;
  const uint2* tw = reinterpret_cast<const uint2*>(smem + L::TW);
  const uint32_t* cst = smem + L::CST;
  uint32_t* rows = smem + L::ROWS;
#pragma unroll
  for (int pi = 0; pi < kPrimes; ++pi) {
    const int use = kPrimes * step + pi;
    const uint2* twf = tw + (2 * pi) * N;
    const uint2* twi = twf + N;
    Prime P;
    P.p = cst[5 * pi], P.ninv = cst[5 * pi + 1], P.ninv_sh = cst[5 * pi + 2];
    P.ip1 = cst[5 * pi + 3], P.ip1_sh = cst[5 * pi + 4];

    // forward passes: three stages on 8 values, the first straight from the
    // digits; row group `row` of a sample does rows row, row + 4, ... < KPL
    {
      const int q = t % L::EIGHTH, row = (t / L::EIGHTH) % 4, s = t / L::HALF;
      uint32_t* x0 = rows + s * L::SS + row * RS;
#pragma unroll
      for (int s0 = 0; s0 < LOGN - L::TAIL; s0 += 3) {
        const int lu = LOGN - s0 - 3;
        const int hi = q >> lu;
        const int xb = row_pad((hi << (lu + 3)) + (q & ((1 << lu) - 1)));
#pragma unroll
        for (int rr = 0; rr < L::RPT; ++rr) {
          if (rr > 0 && row + 4 * rr >= L::KPL) break;
          uint32_t* x = x0 + 4 * rr * RS;
          uint32_t v[8];
          if (s0 == 0) {
            digits(s, row + 4 * rr, q, P.p, v);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = x[xb + row_pad(j << lu)];
          }
          fwd_pass(v, s0, hi, twf, P.p);
#pragma unroll
          for (int j = 0; j < 8; ++j) x[xb + row_pad(j << lu)] = v[j];
        }
        // a pass hands its rows to the group's own threads; the product reads all rows
        if (s0 + 3 < LOGN - L::TAIL) {
          group_sync<L::EIGHTH, NT / L::EIGHTH>(1, t / L::EIGHTH);
        } else {
          __syncthreads();
        }
      }
    }

    // the forward stages left over on the GL rows of input polynomial `half`,
    // their products against the key columns of both output polynomials at 4
    // neighbouring coefficients, the sum with the other polynomial's products
    // (the neighbouring thread's, by shuffle) for one output polynomial, and
    // inverse pass 1 (stages 0-1). The result goes over row `half` of the
    // sample, which only this thread and that neighbour (a lane of the same
    // warp) still read.
    if (NBUF > 0) {
      mbar_wait(shared_u32(smem + L::BARS + 2 * (use % RING)), (uint32_t)(use / RING) & 1u);
    }
    {
      const int s = t % S, half = (t / S) % 2, iq = t / (S * 2);
      uint32_t* xs = rows + s * L::SS + row_pad(4 * iq);
      const uint32_t p2 = 2u * P.p;
      uint32_t x[GL][4];                            // rows GL*half .. GL*half + GL-1
#pragma unroll
      for (int rr = 0; rr < GL; ++rr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[rr][j] = xs[(GL * half + rr) * RS + j];
        fwd_tail(x[rr], L::TAIL, iq, N, twf, P.p);
      }
      uint32_t z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // one chunk: columns (GL*half + rr, c = 0, 1) for rr < GL: 2*GL words
        // from word 2*GL*half of the coefficient's COLS
        const int at = (4 * iq + j) * L::COLS + 2 * GL * half;
        uint32_t w[2 * GL], sw[2 * GL];
        if (GL == 2) {                              // 16 bytes
          uint4 a, b;
          if (NBUF > 0) {
            const uint32_t* kb = smem + L::KEY + (use % RING) * 2 * L::SLICE;
            a = *reinterpret_cast<const uint4*>(kb + at);
            b = *reinterpret_cast<const uint4*>(kb + L::SLICE + at);
          } else {
            a = __ldg(reinterpret_cast<const uint4*>(bk + (size_t)use * L::SLICE + at));
            b = __ldg(reinterpret_cast<const uint4*>(bksh + (size_t)use * L::SLICE + at));
          }
          w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
          sw[0] = b.x, sw[1] = b.y, sw[2] = b.z, sw[3] = b.w;
        } else {                                    // 8-byte pieces: `at` is even
#pragma unroll
          for (int i = 0; i < GL; ++i) {
            uint2 a, b;
            if (NBUF > 0) {
              const uint32_t* kb = smem + L::KEY + (use % RING) * 2 * L::SLICE;
              a = *reinterpret_cast<const uint2*>(kb + at + 2 * i);
              b = *reinterpret_cast<const uint2*>(kb + L::SLICE + at + 2 * i);
            } else {
              a = __ldg(reinterpret_cast<const uint2*>(bk + (size_t)use * L::SLICE + at + 2 * i));
              b = __ldg(reinterpret_cast<const uint2*>(bksh + (size_t)use * L::SLICE + at + 2 * i));
            }
            w[2 * i] = a.x, w[2 * i + 1] = a.y;
            sw[2 * i] = b.x, sw[2 * i + 1] = b.y;
          }
        }
        // each product in [0, 2p): a sum of two lies below 4p < 2^32, so a
        // third row's product is added to the folded sum
        uint32_t c0 = lazy_mul(x[0][j], w[0], sw[0], P.p) + lazy_mul(x[1][j], w[2], sw[2], P.p);
        uint32_t c1 = lazy_mul(x[0][j], w[1], sw[1], P.p) + lazy_mul(x[1][j], w[3], sw[3], P.p);
#pragma unroll
        for (int rr = 2; rr < GL; ++rr) {
          c0 = fold(c0, p2) + lazy_mul(x[rr][j], w[2 * rr], sw[2 * rr], P.p);
          c1 = fold(c1, p2) + lazy_mul(x[rr][j], w[2 * rr + 1], sw[2 * rr + 1], P.p);
        }
        c0 = fold(c0, p2);
        c1 = fold(c1, p2);
        // this thread finishes polynomial `half`, its neighbour the other
        const uint32_t theirs = __shfl_xor_sync(0xffffffffu, half ? c0 : c1, S);
        z[j] = fold((half ? c1 : c0) + theirs, p2);
      }
      inv_pass(z, 0, 0, iq, N, LOGN, twi, P);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[half * RS + j] = z[j];
    }
    __syncthreads();
    cmux_fetch_key<L>(smem, bk, bksh, use + NBUF, kPrimes * steps);

    // inverse passes: two stages on 4 values; the last leaves the residues in
    // registers, in natural order
    {
      const int iq = t % L::QUARTER, pol = (t / L::QUARTER) % kOut, s = t / L::HALF;
      uint32_t* y = rows + s * L::SS + pol * RS;
#pragma unroll
      for (int l0 = 2; l0 < LOGN; l0 += 2) {
        const bool last = l0 + 2 >= LOGN;
        const int l0e = l0 < LOGN - 2 ? l0 : LOGN - 2;
        const int hi = iq >> l0e;
        const int yb = row_pad((hi << (l0e + 2)) + (iq & ((1 << l0e) - 1)));
        uint32_t z[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) z[j] = y[yb + row_pad(j << l0e)];
        inv_pass(z, l0e, l0 - l0e, hi, N, LOGN, twi, P);
        if (!last) {
#pragma unroll
          for (int j = 0; j < 4; ++j) y[yb + row_pad(j << l0e)] = z[j];
          // a pass hands its row to the polynomial's own threads
          group_sync<L::QUARTER, NT / L::QUARTER>(1 + NT / L::EIGHTH, t / L::QUARTER);
        } else if (pi == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) delta[j] = z[j];
          __syncthreads();      // the next prime's forward passes write the rows this pass read
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) delta[j] = crt(delta[j], z[j], cst);
        }
      }
    }
  }
}

}  // namespace tfhe
