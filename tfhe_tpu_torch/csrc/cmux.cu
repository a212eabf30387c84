// Hand-written Hopper kernels of the gate bootstrap (sm_90a), with a plain C
// interface for ctypes (tfhe_tpu_torch/ops/_build.py, tfhe_tpu_torch/ops/cmux.py).
//
// Kernels and the TPU kernels they replace (tfhe_tpu/ops/cmux_pallas.py):
//   cmux_delta_kernel   <- cmux_delta (:575, body _kernel :225): one external
//                          product, the card's test of the NTT alone.
//   blind_rotate_kernel <- blind_rotate_fused (:533, body _scan_kernel :369)
//                          and, with n = 1, blind_rotate_step (:312,
//                          _step_kernel :291): all n CMux steps in one launch.
//   ks_*_kernel         <- the key-switch epilogue of blind_rotate_ks_fused
//                          (:485, _scan_ks_kernel :398); tfhe_blind_rotate_ks
//                          launches blind_rotate_kernel and then the key
//                          switch, blind_rotate_small.cu its own blind rotate
//                          and then the key switch (through tfhe_keyswitch).
//
// Blind rotate (cmux_delta_kernel, blind_rotate_kernel): one block holds S
// whole samples (both polynomials, both primes), so nothing crosses blocks,
// and the S samples walk the n steps together. The accumulators int32[S][2][N]
// stay in shared memory for all n steps beside the samples' digit rows, the
// twiddles of both primes and, in the staged form, the key slices. The
// per-sample X^a rotation is index arithmetic, as in the reference's
// torusPolynomialMulByXai, not the TPU's roll bit-ladder (:333-350). A block
// whose samples run past the batch computes on zeros for them, loads nothing
// of theirs and stores nothing.
//
// What bounds the blind rotate on an H100: int32 instructions. Every sample
// needs the whole bootstrapping key, value and Shoup twin, 2 x 32.8 MB =
// 65.5 MB at PARAMS_110 (123.9 MB at PARAMS_128), once per bootstrap; blocks
// run the steps in roughly the same order, so a slice is shared in L2 by the
// blocks in flight, and a block that stages it reads it once for its S
// samples. The transforms,
// the forms (S samples a block, key slices staged in shared memory or read
// from L2) and what each costs are described in extern_product.cuh;
// ops/cmux.py blind_rotate_plan chooses the form by N and the gadget length
// l (a template parameter, 2 or 3: kOut * l digit rows). 6.15 ms at B = 256 and
// 49.3 ms at 2048 at PARAMS_110 on an H100 (700 W); its int32 operations alone
// would take 3.9 and 31.3 ms at the card's peak, 64 % of that. At PARAMS_128
// (l = 3, 630 steps, the form (2, 1)) 10.0 and 79.2 ms, 67-68 % of 6.7 and
// 53.7 ms.
//
// Key switch (ks_gather_kernel, ks_mma_kernel, ks_finish_kernel): the TPU
// version multiplies a one-hot digit matrix by the int8 limb table on the
// matrix unit and sums in float32 (exact there); int32 is exact here. For
// each nonzero base-4 digit h of coefficient m, digit position j, the sample
// takes the int8 limb row tks[j*(base-1) + h-1][m][:] (4 limbs x C columns),
// and the result is l0 + l1<<8 + l2<<16 + l3<<24 of the summed limbs with
// uint32 wrap. What bounds it: bytes. One sample selects about 6,144 rows of
// 2 KB (12.6 MB, 0.004 ms at the card's memory rate); a batch of 256 touches
// all of the 48 MiB table (0.015 ms). The earlier kernel gave a sample one
// block of 128 threads that walked its 8,192 digits in order, one dependent
// 4-byte load at a time (2.75 ms at B = 1, 1.58 ms at B = 256). Now two arms
// behind tfhe_keyswitch, chosen by ops/cmux.py keyswitch_plan:
// - small batches: a gather spread over the card, a few coefficients of one
//   sample per block, 16-byte loads, all digits of a coefficient in flight;
// - large batches: the one-hot product on the tensor cores (mma.sync s8), so
//   that a table byte is read once for up to 128 samples.
// Both add int32 partial sums into a zeroed scratch with atomicAdd (exact,
// the same in any order) and a short kernel recombines the limbs.

#include <cuda_runtime.h>

#include <cstdint>

#include "extern_product.cuh"

using tfhe::kOut;
using tfhe::kPrimes;

namespace {

constexpr int kSmemDefault = 48 * 1024;

template <class L>
constexpr int min_blocks() { return L::kNbuf == 0 && L::NT <= 512 ? 2 : 1; }

// One external product per sample: dec int32[B][2*GL][N] signed digits in
// [-Bg/2, Bg/2), out int32[B][2][N]; bk/bksh uint32[2][N][4*GL]. Block b
// holds samples b*S .. b*S + S-1.
template <int LOGN, int GL, int S, int NBUF>
__global__ void __launch_bounds__((tfhe::CmuxBlock<LOGN, GL, S, NBUF>::NT),
                                  (min_blocks<tfhe::CmuxBlock<LOGN, GL, S, NBUF>>()))
    cmux_delta_kernel(const int32_t* __restrict__ dec, const uint32_t* __restrict__ bk,
                      const uint32_t* __restrict__ bksh, const uint32_t* __restrict__ tab,
                      int32_t* __restrict__ out, int B) {
  using L = tfhe::CmuxBlock<LOGN, GL, S, NBUF>;
  constexpr int N = L::N;
  extern __shared__ __align__(128) uint32_t smem[];
  const int first = blockIdx.x * S;
  tfhe::cmux_block_setup<L>(smem, tab);
  tfhe::cmux_fetch_key<L>(smem, bk, bksh, 0, kPrimes);
  tfhe::cmux_fetch_key<L>(smem, bk, bksh, 1, NBUF > 1 ? kPrimes : 0);
  __syncthreads();
  auto digits = [&](int s, int row, int q, uint32_t p, uint32_t (&v)[8]) {
    const int32_t* d = dec + ((size_t)(first + s) * L::KPL + row) * N + q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int32_t x = first + s < B ? __ldg(d + j * L::EIGHTH) : 0;
      v[j] = (uint32_t)x + 2u * p;                  // |x| <= Bg/2 < p: in (p, 3p)
    }
  };
  uint32_t delta[4];
  tfhe::extern_product<LOGN, GL, S, NBUF>(digits, smem, bk, bksh, 0, 1, delta);
  const int t = threadIdx.x;            // polynomial (t / (N/4)) % 2 of sample t / (N/2)
  if (first + t / L::HALF < B) {
    uint32_t* o = reinterpret_cast<uint32_t*>(out) + (size_t)first * kOut * N +
                  t / L::QUARTER * N + t % L::QUARTER;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j * L::QUARTER] = delta[j];
  }
}

// n CMux steps: acc int32[B][2][N] in place, bara int32[B][n] in [0, 2N),
// bk/bksh uint32[n][2][N][4*GL]. Block b holds samples b*S .. b*S + S-1.
template <int LOGN, int GL, int S, int NBUF>
__global__ void __launch_bounds__((tfhe::CmuxBlock<LOGN, GL, S, NBUF>::NT),
                                  (min_blocks<tfhe::CmuxBlock<LOGN, GL, S, NBUF>>()))
    blind_rotate_kernel(int32_t* __restrict__ acc_io, const int32_t* __restrict__ bara,
                        const uint32_t* __restrict__ bk, const uint32_t* __restrict__ bksh,
                        const uint32_t* __restrict__ tab, int B, int n, int bgbit,
                        uint32_t offset) {
  using L = tfhe::CmuxBlock<LOGN, GL, S, NBUF>;
  constexpr int N = L::N;
  extern __shared__ __align__(128) uint32_t smem[];
  uint32_t* acc = smem + L::ACC;                    // [S][2][N]
  const int tid = threadIdx.x;
  const int first = blockIdx.x * S;
  const uint32_t mask = (1u << bgbit) - 1u;
  const uint32_t half_bg = 1u << (bgbit - 1);
  uint32_t* g = reinterpret_cast<uint32_t*>(acc_io) + (size_t)first * kOut * N;

  tfhe::cmux_block_setup<L>(smem, tab);
  tfhe::cmux_fetch_key<L>(smem, bk, bksh, 0, kPrimes * n);
  tfhe::cmux_fetch_key<L>(smem, bk, bksh, 1, NBUF > 1 ? kPrimes * n : 0);
  for (int i = tid; i < S * kOut * N; i += L::NT) {
    acc[i] = first + i / (kOut * N) < B ? g[i] : 0u;
  }
  // the rotation amounts of the sample this thread transforms, one step ahead
  // (-1: a sample past the batch, which rotates by nothing)
  const int mine = first + tid / L::HALF < B ? first + tid / L::HALF : -1;
  int a_next = mine >= 0 ? __ldg(bara + (size_t)mine * n) : 0;
  __syncthreads();

  for (int step = 0; step < n; ++step) {
    const int a = a_next;
    a_next = mine >= 0 && step + 1 < n ? __ldg(bara + (size_t)mine * n + step + 1) : 0;
    // signed digits of X^a * acc - acc, row c*l + d, as residues mod p
    auto digits = [&](int s, int row, int q, uint32_t p, uint32_t (&v)[8]) {
      const int c = GL == 2 ? row >> 1 : row / GL, d = GL == 2 ? row & 1 : row % GL;
      const uint32_t* ac = acc + (s * kOut + c) * N;
      const int sh = 32 - (d + 1) * bgbit;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = q + j * L::EIGHTH;
        int d = i - a;
        if (d < 0) d += 2 * N;
        const bool neg = d >= N;
        const uint32_t x = ac[neg ? d - N : d];
        const uint32_t u = (neg ? 0u - x : x) - ac[i] + offset;
        v[j] = ((u >> sh) & mask) + (2u * p - half_bg);     // digit - Bg/2, in (p, 3p)
      }
    };
    uint32_t delta[4];
    tfhe::extern_product<LOGN, GL, S, NBUF>(digits, smem, bk, bksh, step, n, delta);
    uint32_t* ac = acc + tid / L::QUARTER * N + tid % L::QUARTER;
#pragma unroll
    for (int j = 0; j < 4; ++j) ac[j * L::QUARTER] += delta[j];
    __syncthreads();
  }

  for (int i = tid; i < S * kOut * N; i += L::NT) {
    if (first + i / (kOut * N) < B) g[i] = acc[i];
  }
}

// ---------------------------------------------------------------- key switch
//
// Sample extract and key switch of acc int32[B][2][N]. The extracted sample is
// x[m] = acc0[0] if m == 0 else -acc0[m] (native order; the index map is
// folded into the table), u = x + prec_offset, digit jd of coefficient m is
// (u >> (32 - (jd+1)*basebit)) & (base-1). tks int8[t*(base-1)][N][4*C] holds,
// for plane jh = jd*(base-1) + h-1 and coefficient m, a row of four limb
// planes of C columns. Both arms add int32 partial sums of the selected rows
// into sums int32[B][4*C] (zeroed by the wrapper) with atomicAdd, which is
// exact and the same whatever the order; ks_finish_kernel recombines the
// limbs into r int32[B][C] and writes ext int32[2][B] = (b_ext, count of
// nonzero digits).
//
// Paired mode (PAIRED, `pairs` P > 0: a MUX or a parallel-prefix combine,
// whose gate sums two bootstrapped samples before one key switch). The
// accumulator holds B + P samples and the output B: output b < P key-switches
// the sum of samples b and P + b plus (0, b_add), output b >= P sample P + b.
// Extraction and key switch are linear mod 2^32, so summing the two
// accumulators' words where u is read is the sum of the extracted samples;
// the count of nonzero digits is the summed sample's. PAIRED is a template
// parameter so that the plain key switch, behind every bootstrap, holds no
// instruction of the paired mode.

// Coefficient m of the accumulator output b reads, a0 pointing at sample
// PAIRED ? P + b : b: in paired mode output b < P adds sample b.
template <bool PAIRED>
__device__ __forceinline__ uint32_t ks_word(const uint32_t* a0, int m, int b, int pairs, int N) {
  uint32_t v = __ldg(a0 + m);
  if constexpr (PAIRED) {
    if (b < pairs) v += __ldg(a0 - (size_t)pairs * kOut * N + m);
  }
  return v;
}

// Small batches. Grid (S, B): block s of sample b gathers the rows of `per`
// = N/S coefficients. Thread tid owns bytes 16*tid .. 16*tid+15 of a row
// (blockDim = 4*C/16), so a row is one 16-byte load per thread and the t
// digits of a coefficient are t independent loads in flight.
template <bool PAIRED>
__global__ void ks_gather_kernel(const int32_t* __restrict__ acc, const int8_t* __restrict__ tks,
                                 int32_t* __restrict__ sums, int N, int C, int t, int basebit,
                                 uint32_t prec_offset, int per, int pairs) {
  extern __shared__ uint32_t su[];    // [max(per, 16*blockDim)]
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * per;
  const uint32_t dmask = (1u << basebit) - 1u;
  const int bm1 = (1 << basebit) - 1;
  const uint32_t* a0 =
      reinterpret_cast<const uint32_t*>(acc) + (size_t)(PAIRED ? pairs + b : b) * kOut * N;
  for (int i = tid; i < per; i += blockDim.x) {
    const int m = m0 + i;
    const uint32_t v = ks_word<PAIRED>(a0, m, b, pairs, N);
    su[i] = (m == 0 ? v : 0u - v) + prec_offset;
  }
  __syncthreads();

  int sum[16] = {};
  const size_t row_bytes = 4 * (size_t)C;
  const int8_t* col = tks + 16 * (size_t)tid;
  for (int i = 0; i < per; ++i) {
    const uint32_t u = su[i];
    const size_t m = (size_t)(m0 + i);
    for (int j0 = 0; j0 < t; j0 += 8) {
      int4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int jd = j0 + k;
        const uint32_t h = jd < t ? (u >> (32 - (jd + 1) * basebit)) & dmask : 0u;
        v[k] = make_int4(0, 0, 0, 0);
        if (h != 0u) {
          const size_t row = (size_t)(jd * bm1 + (int)h - 1) * N + m;
          v[k] = __ldg(reinterpret_cast<const int4*>(col + row * row_bytes));
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sum[4 * q + 0] = __dp4a(w[q], 0x00000001, sum[4 * q + 0]);
          sum[4 * q + 1] = __dp4a(w[q], 0x00000100, sum[4 * q + 1]);
          sum[4 * q + 2] = __dp4a(w[q], 0x00010000, sum[4 * q + 2]);
          sum[4 * q + 3] = __dp4a(w[q], 0x01000000, sum[4 * q + 3]);
        }
      }
    }
  }
  // through shared memory, so that a warp's atomics fall on neighbouring words
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 16; ++q) su[16 * tid + q] = (uint32_t)sum[q];
  __syncthreads();
  int32_t* out = sums + (size_t)b * row_bytes;
  for (int i = tid; i < 16 * (int)blockDim.x; i += blockDim.x) {
    const int v = (int)su[i];
    if (v != 0) atomicAdd(out + i, v);
  }
}

// Large batches: the one-hot product on the tensor cores, so that a table
// byte is read once for up to kMmaRows samples. A block of 8 warps owns
// kMmaRows samples x kMmaCols bytes of the row and the coefficients
// [m0, m0 + per) of every plane (grid: column tiles, sample tiles, splits of
// N). Warp w owns samples 16w .. 16w+15 and all kMmaCols columns: 16
// mma.m16n8k32 (s8 x s8 -> s32) per step of 32 coefficients of one plane.
// The one-hot A fragments are built in registers from u and never stored.
// The table tile (32 coefficients x kMmaCols bytes of one plane) streams
// through a ring of kMmaStages shared-memory stages filled by cp.async, one
// 16-byte chunk per thread. The mma wants 4 consecutive k of one column in a
// register, the table has 4 consecutive columns of one k in a word: each
// thread loads 4 words (4 k x 4 columns) and transposes the 4x4 bytes with
// byte permutes, which gives the B fragments of 4 column tiles at once
// (column tile q of a group of 32 columns holds columns 4*v + q, v = 0..7).
// Fragment k position 4*tig + i stands for coefficient tig + 4*i of the
// step (and 16 + ...), in A and in B alike: with the stage rows padded to
// kMmaRowWords words, the four tig then read four different bank groups.
constexpr int kMmaRows = 128;
constexpr int kMmaCols = 128;
constexpr int kMmaStages = 4;
constexpr int kMmaRowWords = 40;                       // 32 words of data, 8 of padding
constexpr int kMmaStageWords = 32 * kMmaRowWords;
constexpr int kMmaUStride = 33;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst_shared);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <bool PAIRED>
__global__ void __launch_bounds__(256)
    ks_mma_kernel(const int32_t* __restrict__ acc, const int8_t* __restrict__ tks,
                  int32_t* __restrict__ sums, int B, int N, int C, int t, int basebit,
                  uint32_t prec_offset, int per, int pairs) {
  __shared__ __align__(16) uint32_t stage[kMmaStages * kMmaStageWords];
  __shared__ uint32_t ut[kMmaRows * kMmaUStride];     // u of this block's samples, one step
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * kMmaCols;             // byte column of the 4*C-wide row
  const int b0 = blockIdx.y * kMmaRows;
  const int m0 = blockIdx.z * per;
  const int bm1 = (1 << basebit) - 1;
  const int planes = t * bm1;
  const uint32_t dmask = (1u << basebit) - 1u;
  const size_t row_bytes = 4 * (size_t)C;
  const int steps = (per / 32) * planes;              // step = (block of 32 coefficients, plane)
  const bool active = b0 + 16 * warp < B;             // warp-uniform

  // stage `st` of the ring <- step `s`: row tid/8 of the tile, chunk tid%8
  auto fetch = [&](int s) {
    if (s < steps) {
      const int mb = s / planes, jh = s - mb * planes;
      const int rrow = tid >> 3, chunk = tid & 7;
      const size_t m = (size_t)(m0 + 32 * mb + rrow);
      const int8_t* src = tks + ((size_t)jh * N + m) * row_bytes + col0 + 16 * chunk;
      cp_async16(stage + (s % kMmaStages) * kMmaStageWords + rrow * kMmaRowWords + 4 * chunk,
                 src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int c[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0;

#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) fetch(s);

  uint32_t uu[4][4];     // [a-register][byte]: u of (sample, coefficient) behind each A byte
  uint32_t dg[4] = {};   // the digits jd of those, packed as bytes
  for (int s = 0; s < steps; ++s) {
    const int mb = s / planes, jh = s - mb * planes;
    if (jh == 0) {
      __syncthreads();                                // the last step's readers of ut are done
      for (int i = tid; i < kMmaRows * 32; i += 256) {
        const int rr = i >> 5, mm = i & 31;
        const int m = m0 + 32 * mb + mm;
        uint32_t u = 0u;
        if (b0 + rr < B) {
          const uint32_t* ar = reinterpret_cast<const uint32_t*>(acc) +
                               (size_t)(b0 + rr + (PAIRED ? pairs : 0)) * kOut * N;
          const uint32_t v = ks_word<PAIRED>(ar, m, b0 + rr, pairs, N);
          u = (m == 0 ? v : 0u - v) + prec_offset;
        }
        ut[rr * kMmaUStride + mm] = u;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int rr = 16 * warp + g + 8 * (a & 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) uu[a][i] = ut[rr * kMmaUStride + 16 * (a >> 1) + tig + 4 * i];
      }
    }
    const int jd = jh / bm1, h = jh - jd * bm1 + 1;
    if (h == 1) {
      const int sh = 32 - (jd + 1) * basebit;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        dg[a] = ((uu[a][0] >> sh) & dmask) | (((uu[a][1] >> sh) & dmask) << 8) |
                (((uu[a][2] >> sh) & dmask) << 16) | (((uu[a][3] >> sh) & dmask) << 24);
      }
    }
    // one-hot bytes of digit h; the rows of samples past B are masked here
    uint32_t afrag[4];
    const uint32_t hh = (uint32_t)h * 0x01010101u;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const bool row_ok = b0 + 16 * warp + g + 8 * (a & 1) < B;
      afrag[a] = row_ok ? (__vcmpeq4(dg[a], hh) & 0x01010101u) : 0u;
    }

    asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmaStages - 2));
    __syncthreads();                                  // step s has landed for every thread
    fetch(s + kMmaStages - 1);                        // into the stage read at step s - 1

    if (active) {
      const uint32_t* tile = stage + (s % kMmaStages) * kMmaStageWords;
#pragma unroll
      for (int G = 0; G < 4; ++G) {
        uint32_t w[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[hf][i] = tile[(16 * hf + tig + 4 * i) * kMmaRowWords + 8 * G + g];
          }
        }
        uint32_t bf[2][4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint32_t t0 = __byte_perm(w[hf][0], w[hf][1], 0x5140);
          const uint32_t t1 = __byte_perm(w[hf][0], w[hf][1], 0x7362);
          const uint32_t t2 = __byte_perm(w[hf][2], w[hf][3], 0x5140);
          const uint32_t t3 = __byte_perm(w[hf][2], w[hf][3], 0x7362);
          bf[hf][0] = __byte_perm(t0, t2, 0x5410);
          bf[hf][1] = __byte_perm(t0, t2, 0x7632);
          bf[hf][2] = __byte_perm(t1, t3, 0x5410);
          bf[hf][3] = __byte_perm(t1, t3, 0x7632);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_s8(c[4 * G + q], afrag, bf[0][q], bf[1][q]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  if (active) {
#pragma unroll
    for (int G = 0; G < 4; ++G) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = b0 + 16 * warp + g + 8 * (e >> 1);
          const int cc = col0 + 32 * G + 4 * (2 * tig + (e & 1)) + q;
          const int v = c[4 * G + q][e];
          if (rr < B && v != 0) atomicAdd(sums + (size_t)rr * row_bytes + cc, v);
        }
      }
    }
  }
}

// Limb recombine l0 + l1<<8 + l2<<16 + l3<<24 (uint32 wrap) of the summed
// planes, b_ext and the count of nonzero digits; one block per sample.
template <bool PAIRED>
__global__ void ks_finish_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ sums,
                                 int32_t* __restrict__ r, int32_t* __restrict__ ext, int B, int N,
                                 int C, int t, int basebit, uint32_t prec_offset, int pairs,
                                 uint32_t b_add) {
  __shared__ unsigned int count;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const uint32_t dmask = (1u << basebit) - 1u;
  const uint32_t* a0 =
      reinterpret_cast<const uint32_t*>(acc) + (size_t)(PAIRED ? pairs + b : b) * kOut * N;
  if (tid == 0) count = 0u;
  __syncthreads();
  unsigned int nnz = 0;
  for (int m = tid; m < N; m += blockDim.x) {
    const uint32_t v = ks_word<PAIRED>(a0, m, b, pairs, N);
    const uint32_t u = (m == 0 ? v : 0u - v) + prec_offset;
    for (int jd = 0; jd < t; ++jd) nnz += ((u >> (32 - (jd + 1) * basebit)) & dmask) != 0u;
  }
  atomicAdd(&count, nnz);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(sums) + (size_t)b * 4 * C;
  uint32_t* ro = reinterpret_cast<uint32_t*>(r) + (size_t)b * C;
  for (int cc = tid; cc < C; cc += blockDim.x) {
    ro[cc] = s[cc] + (s[C + cc] << 8) + (s[2 * C + cc] << 16) + (s[3 * C + cc] << 24);
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (PAIRED) {
      ext[b] = (int32_t)(ks_word<true>(a0, N, b, pairs, N) + (b < pairs ? b_add : 0u));
    } else {
      ext[b] = acc[(size_t)b * kOut * N + N];
    }
    ext[B + b] = (int32_t)count;
  }
}

int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// allow_smem once per kernel and device (`allowed`: the kernel's flags, one
// a device): the call costs several microseconds of host time, as much as a
// launch, and a one-step launch is nothing else.
constexpr int kDevices = 64;
template <class K>
cudaError_t allow_smem_once(bool (&allowed)[kDevices], K kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && allowed[dev]) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = true;
  return err;
}

// What a launch of one form does: the external product alone (dec != nullptr)
// or n steps of the blind rotate; with smem_bytes != nullptr nothing is
// launched and the form's shared-memory size is written there.
struct CmuxCall {
  const int32_t* dec;
  int32_t* out;
  int32_t* acc;
  const int32_t* bara;
  const uint32_t *bk, *bksh, *tab;
  int B, n, bgbit;
  uint32_t offset;
  cudaStream_t stream;
  int* smem_bytes;
};

template <int LOGN, int GL, int S, int NBUF>
cudaError_t launch_form(const CmuxCall& c) {
  using L = tfhe::CmuxBlock<LOGN, GL, S, NBUF>;
  if constexpr (L::BYTES > tfhe::kSmemMax) {
    return cudaErrorInvalidValue;
  } else {
    if (c.smem_bytes != nullptr) {
      *c.smem_bytes = (int)L::BYTES;
      return cudaSuccess;
    }
    static bool allowed[2][kDevices] = {};          // this form's two kernels
    const int blocks = (c.B + S - 1) / S;
    if (c.dec != nullptr) {
      const cudaError_t err =
          allow_smem_once(allowed[0], cmux_delta_kernel<LOGN, GL, S, NBUF>, L::BYTES);
      if (err != cudaSuccess) return err;
      cmux_delta_kernel<LOGN, GL, S, NBUF><<<blocks, L::NT, L::BYTES, c.stream>>>(
          c.dec, c.bk, c.bksh, c.tab, c.out, c.B);
    } else {
      const cudaError_t err =
          allow_smem_once(allowed[1], blind_rotate_kernel<LOGN, GL, S, NBUF>, L::BYTES);
      if (err != cudaSuccess) return err;
      blind_rotate_kernel<LOGN, GL, S, NBUF><<<blocks, L::NT, L::BYTES, c.stream>>>(
          c.acc, c.bara, c.bk, c.bksh, c.tab, c.B, c.n, c.bgbit, c.offset);
    }
    return cudaGetLastError();
  }
}

template <int LOGN, int GL>
cudaError_t launch_logn(const CmuxCall& c, int S, int nbuf) {
  if constexpr (GL == 2) {
    if (S == 2 && nbuf == 2) return launch_form<LOGN, GL, 2, 2>(c);
  } else {
    if (S == 2 && nbuf == 1) return launch_form<LOGN, GL, 2, 1>(c);
  }
  if (S == 1 && nbuf == 0) return launch_form<LOGN, GL, 1, 0>(c);
  return cudaErrorInvalidValue;
}

template <int GL>
cudaError_t launch_gl(const CmuxCall& c, int N, int S, int nbuf) {
  switch (log2i(N)) {
    case 6: return launch_logn<6, GL>(c, S, nbuf);
    case 7: return launch_logn<7, GL>(c, S, nbuf);
    case 8: return launch_logn<8, GL>(c, S, nbuf);
    case 9: return launch_logn<9, GL>(c, S, nbuf);
    case 10: return launch_logn<10, GL>(c, S, nbuf);
    case 11: return launch_logn<11, GL>(c, S, nbuf);
    default: return cudaErrorInvalidValue;
  }
}

// The forms: S samples a block with nbuf key buffers in shared memory
// (0: the product reads the key from L2): (2, 2) and (1, 0) at gadget length
// l = 2, (2, 1) and (1, 0) at l = 3; ops/cmux.py blind_rotate_plan chooses.
// A form that does not fit the block's shared memory at this N, or does not
// exist, is an invalid value.
cudaError_t launch_cmux(const CmuxCall& c, int N, int l, int S, int nbuf) {
  if (N < 64 || N > 2048 || (N & (N - 1)) || c.B < 1 || c.n < 1) return cudaErrorInvalidValue;
  if (l == 2) return launch_gl<2>(c, N, S, nbuf);
  if (l == 3) return launch_gl<3>(c, N, S, nbuf);
  return cudaErrorInvalidValue;
}

cudaError_t launch_blind_rotate(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                                const uint32_t* bksh, const uint32_t* tab, int B, int n, int N,
                                int l, int bgbit, uint32_t offset, int S, int nbuf,
                                cudaStream_t stream) {
  const CmuxCall c{nullptr, nullptr, acc, bara, bk, bksh, tab, B, n, bgbit, offset, stream, nullptr};
  return launch_cmux(c, N, l, S, nbuf);
}

// The key switch's launches: an arm, then ks_finish_kernel; B the samples of
// the output.
template <bool PAIRED>
cudaError_t launch_keyswitch(const int32_t* acc, const int8_t* tks, int32_t* sums, int32_t* r,
                             int32_t* ext, int B, int N, int C, int t, int basebit,
                             uint32_t prec_offset, int mma, int split, int pairs, uint32_t b_add,
                             cudaStream_t stream) {
  const int per = N / split;
  if (mma) {
    if (per % 32 || (4 * C) % kMmaCols) return cudaErrorInvalidValue;
    const dim3 grid(4 * C / kMmaCols, (B + kMmaRows - 1) / kMmaRows, split);
    ks_mma_kernel<PAIRED><<<grid, 256, 0, stream>>>(acc, tks, sums, B, N, C, t, basebit,
                                                    prec_offset, per, pairs);
  } else {
    const int threads = C / 4;
    const size_t smem = sizeof(uint32_t) * (size_t)(per > 16 * threads ? per : 16 * threads);
    const cudaError_t err = allow_smem(ks_gather_kernel<PAIRED>, smem);
    if (err != cudaSuccess) return err;
    ks_gather_kernel<PAIRED><<<dim3(split, B), threads, smem, stream>>>(
        acc, tks, sums, N, C, t, basebit, prec_offset, per, pairs);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ks_finish_kernel<PAIRED><<<B, 128, 0, stream>>>(acc, sums, r, ext, B, N, C, t, basebit,
                                                  prec_offset, pairs, b_add);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tfhe_cmux_delta(const int32_t* dec, const uint32_t* bk, const uint32_t* bksh,
                    const uint32_t* tab, int32_t* out, int B, int N, int l, int S, int nbuf,
                    cudaStream_t stream) {
  const CmuxCall c{dec, out, nullptr, nullptr, bk, bksh, tab, B, 1, 0, 0u, stream, nullptr};
  return (int)launch_cmux(c, N, l, S, nbuf);
}

int tfhe_blind_rotate(int32_t* acc, const int32_t* bara, const uint32_t* bk, const uint32_t* bksh,
                      const uint32_t* tab, int B, int n, int N, int l, int bgbit,
                      unsigned int offset, int S, int nbuf, cudaStream_t stream) {
  return (int)launch_blind_rotate(acc, bara, bk, bksh, tab, B, n, N, l, bgbit, offset, S, nbuf,
                                  stream);
}

// The shared memory, in bytes, of a block of the form (S, nbuf) at this N and
// gadget length l; an error if the form does not exist or does not fit.
int tfhe_cmux_smem_bytes(int N, int l, int S, int nbuf, int* bytes) {
  const CmuxCall c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 0, 0u,
                   nullptr, bytes};
  return (int)launch_cmux(c, N, l, S, nbuf);
}

// Sample extract and key switch of acc int32[B][2][N] into r int32[B - pairs][C]
// and ext int32[2][B - pairs]; sums int32[B - pairs][4*C] is scratch that the
// caller has zeroed. pairs > 0: the paired mode (above), b_add added to the
// b of each summed pair. mma == 0: the gather arm with `split` blocks per
// sample; else the tensor-core arm with N cut into `split` ranges
// (ops/cmux.py keyswitch_plan chooses, by the output's samples). Also called
// by blind_rotate_small.cu after its blind rotate.
int tfhe_keyswitch(const int32_t* acc, const int8_t* tks, int32_t* sums, int32_t* r, int32_t* ext,
                   int B, int N, int C, int t, int basebit, unsigned int prec_offset, int mma,
                   int split, int pairs, unsigned int b_add, cudaStream_t stream) {
  if (split < 1 || N % split || pairs < 0 || 2 * pairs > B) return (int)cudaErrorInvalidValue;
  if (pairs > 0) {
    return (int)launch_keyswitch<true>(acc, tks, sums, r, ext, B - pairs, N, C, t, basebit,
                                       prec_offset, mma, split, pairs, b_add, stream);
  }
  return (int)launch_keyswitch<false>(acc, tks, sums, r, ext, B, N, C, t, basebit, prec_offset,
                                      mma, split, 0, 0u, stream);
}

int tfhe_blind_rotate_ks(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                         const uint32_t* bksh, const uint32_t* tab, const int8_t* tks,
                         int32_t* sums, int32_t* r, int32_t* ext, int B, int n, int N, int l,
                         int bgbit, unsigned int offset, int S, int nbuf, int C, int t,
                         int basebit, unsigned int prec_offset, int mma, int split, int pairs,
                         unsigned int b_add, cudaStream_t stream) {
  const cudaError_t err =
      launch_blind_rotate(acc, bara, bk, bksh, tab, B, n, N, l, bgbit, offset, S, nbuf, stream);
  if (err != cudaSuccess) return (int)err;
  return tfhe_keyswitch(acc, tks, sums, r, ext, B, N, C, t, basebit, prec_offset, mma, split,
                        pairs, b_add, stream);
}

const char* tfhe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
