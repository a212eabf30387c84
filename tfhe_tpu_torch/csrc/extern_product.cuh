// Device-side external product of the CMux: the shared body of the
// one-block-per-sample kernels of cmux.cu (cmux_delta_kernel,
// blind_rotate_kernel). blind_rotate_small.cu takes the table layout, the
// prime constants and mulm/subm from here and has its own transforms (three
// stages a pass in registers, lazy reduction); they give the same residues.
//
// Replaces tfhe_tpu/ops/cmux_pallas.py:_ntt_extern_product (:246) and the
// helpers it calls: _fwd_rows (:79), _inv_rows (:110), _crt (:235) and
// _shoup/_umulhi (:42-56). For one sample, with the offset gadget digits of
// the (k+1)*l = 4 rows in shared memory, it computes per CRT prime
//   dhat_r = NTT(digits_r) - NTT(halfBg * 1)
//   prod_c = sum_r dhat_r * bk[r, c]          (Shoup products, c = 0, 1)
//   res_c  = NTT^-1(prod_c)
// and lifts (res_c mod P1, res_c mod P2) to Torus32 with Garner's CRT.
// Exact integer math in uint32 with wraparound: the same bits as the TPU
// kernel and the plain-torch version.
//
// Translation: the TPU's three butterfly flavours (scalar-literal, sublane
// reshape, roll-select) are one butterfly loop over shared memory here; the
// 16-bit-split _umulhi is __umulhi. A block of N/2 threads owns one sample:
// thread b runs butterfly b of every row in every stage, and owns
// coefficients b and b + N/2 outside the transforms.
//
// What bounds it: 2 primes x (4 forward + 2 inverse) transforms of log2(N)
// stages, each stage a __syncthreads with 4 butterflies a thread between two
// of them (about 44 barriers a CMux step), twiddles fetched with __ldg in
// every stage; the bootstrapping-key slice is read once per call from global
// memory (128 KB at N = 1024, value and Shoup twin), with 16-byte loads per
// coefficient, at the moment of the MAC. blind_rotate_small.cu shows what
// removing each of these is worth on an H100.
#pragma once

#include <cstdint>

namespace tfhe {

constexpr int kKpl = 4;      // (k+1)*l gadget rows (k = 1, l = 2)
constexpr int kOut = 2;      // k+1 output polynomials
constexpr int kPrimes = 2;
constexpr int kTabRows = 5;  // psi, psi_sh, ipsi, ipsi_sh, NTT(halfBg * 1)

// Table buffer layout (built by ops/cmux.py:_kernel_tables):
//   uint32[kPrimes][kTabRows][N] twiddles, then 16 constants:
//   per prime (p, n_inv, n_inv_sh, ipsi1_ninv, ipsi1_ninv_sh),
//   then CRT (P1^-1 mod P2, its Shoup twin, T_HALF, R1_HALF, P1*P2 mod 2^32).
struct Prime {
  uint32_t p, ninv, ninv_sh, ip1, ip1_sh;
  const uint32_t *psi, *psi_sh, *ipsi, *ipsi_sh, *ones;
};

__device__ __forceinline__ Prime load_prime(const uint32_t* tab, int N, int pi) {
  const uint32_t* t = tab + (size_t)pi * kTabRows * N;
  const uint32_t* c = tab + (size_t)kPrimes * kTabRows * N + pi * 5;
  Prime P;
  P.p = __ldg(c + 0);
  P.ninv = __ldg(c + 1);
  P.ninv_sh = __ldg(c + 2);
  P.ip1 = __ldg(c + 3);
  P.ip1_sh = __ldg(c + 4);
  P.psi = t;
  P.psi_sh = t + N;
  P.ipsi = t + 2 * N;
  P.ipsi_sh = t + 3 * N;
  P.ones = t + 4 * N;
  return P;
}

__device__ __forceinline__ uint32_t addm(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t subm(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a - b + p;
}

// x * w mod p for a fixed w with w_sh = floor(w * 2^32 / p); result in [0, p).
__device__ __forceinline__ uint32_t mulm(uint32_t x, uint32_t w, uint32_t w_sh, uint32_t p) {
  const uint32_t q = __umulhi(x, w_sh);
  const uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

// Forward negacyclic NTT (DIF, natural -> bit-reversed) of R rows of length N
// in shared memory, in place. Ends with a barrier.
template <int R>
__device__ __forceinline__ void ntt_forward(uint32_t* x, int N, int logN, const Prime& P) {
  const int b = threadIdx.x;
  for (int lm = 0; lm < logN; ++lm) {         // m = 2^lm groups of 2t
    const int lt = logN - 1 - lm;
    const int t = 1 << lt;
    const int i = b >> lt;
    const int idx = (i << (lt + 1)) + (b & (t - 1));
    const uint32_t w = __ldg(P.psi + (1 << lm) + i);
    const uint32_t wsh = __ldg(P.psi_sh + (1 << lm) + i);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t* row = x + r * N;
      const uint32_t u = row[idx];
      const uint32_t wv = mulm(row[idx + t], w, wsh, P.p);
      row[idx] = addm(u, wv, P.p);
      row[idx + t] = subm(u, wv, P.p);
    }
    __syncthreads();
  }
}

// Inverse negacyclic NTT (DIT, bit-reversed -> natural, scaled by N^-1) of R
// rows in shared memory. The last stage is not written back: out[r][0] is
// coefficient b and out[r][1] coefficient b + N/2 of row r.
template <int R>
__device__ __forceinline__ void ntt_inverse(uint32_t* x, int N, int logN, const Prime& P,
                                            uint32_t (&out)[R][2]) {
  const int b = threadIdx.x;
  for (int lt = 0; lt < logN - 1; ++lt) {     // t = 2^lt, h = N / 2t groups
    const int t = 1 << lt;
    const int h = N >> (lt + 1);
    const int i = b >> lt;
    const int idx = (i << (lt + 1)) + (b & (t - 1));
    const uint32_t w = __ldg(P.ipsi + h + i);
    const uint32_t wsh = __ldg(P.ipsi_sh + h + i);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t* row = x + r * N;
      const uint32_t u = row[idx];
      const uint32_t v = row[idx + t];
      row[idx] = addm(u, v, P.p);
      row[idx + t] = mulm(subm(u, v, P.p), w, wsh, P.p);
    }
    __syncthreads();
  }
  const int half = N >> 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t u = x[r * N + b];
    const uint32_t v = x[r * N + b + half];
    out[r][0] = mulm(addm(u, v, P.p), P.ninv, P.ninv_sh, P.p);
    out[r][1] = mulm(subm(u, v, P.p), P.ip1, P.ip1_sh, P.p);
  }
}

// Garner CRT of (r1 mod P1, r2 mod P2) to the signed value mod 2^32.
__device__ __forceinline__ uint32_t crt(uint32_t r1, uint32_t r2, uint32_t P1, uint32_t P2,
                                        const uint32_t* c) {
  const uint32_t inv = __ldg(c + 0), inv_sh = __ldg(c + 1);
  const uint32_t t_half = __ldg(c + 2), r1_half = __ldg(c + 3), m_mod = __ldg(c + 4);
  const uint32_t r1p2 = r1 >= P2 ? r1 - P2 : r1;
  const uint32_t t = mulm(subm(r2, r1p2, P2), inv, inv_sh, P2);
  const uint32_t rep = r1 + P1 * t;
  const bool upper = t > t_half || (t == t_half && r1 >= r1_half);
  return upper ? rep - m_mod : rep;
}

// The external product for the block's sample. `fill(dig)` writes the offset
// digits (in [0, Bg)) of rows 0..3 at coefficients b and b + N/2 and may read
// anything written before the call. bk/bksh: this step's uint32[kPrimes][N][8]
// slice, column r*2 + c. delta[c][q] receives coefficient b + q*N/2 of output
// polynomial c. `dig` is shared uint32[kKpl][N].
template <class Fill>
__device__ __forceinline__ void extern_product(const Fill& fill, const uint32_t* __restrict__ bk,
                                               const uint32_t* __restrict__ bksh,
                                               const uint32_t* __restrict__ tab, int N, int logN,
                                               uint32_t* dig, uint32_t (&delta)[kOut][2]) {
  const int b = threadIdx.x;
  const int half = N >> 1;
  uint32_t res[kPrimes][kOut][2];
#pragma unroll
  for (int pi = 0; pi < kPrimes; ++pi) {
    const Prime P = load_prime(tab, N, pi);
    fill(dig);
    __syncthreads();
    ntt_forward<kKpl>(dig, N, logN, P);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = b + q * half;
      const uint4* w4 = reinterpret_cast<const uint4*>(bk + ((size_t)pi * N + i) * 8);
      const uint4* s4 = reinterpret_cast<const uint4*>(bksh + ((size_t)pi * N + i) * 8);
      const uint4 w0 = __ldg(w4), w1 = __ldg(w4 + 1), s0 = __ldg(s4), s1 = __ldg(s4 + 1);
      const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const uint32_t s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const uint32_t one = __ldg(P.ones + i);
      uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
      for (int r = 0; r < kKpl; ++r) {
        const uint32_t d = subm(dig[r * N + i], one, P.p);
        acc0 = addm(acc0, mulm(d, w[2 * r], s[2 * r], P.p), P.p);
        acc1 = addm(acc1, mulm(d, w[2 * r + 1], s[2 * r + 1], P.p), P.p);
      }
      dig[i] = acc0;
      dig[N + i] = acc1;
    }
    __syncthreads();
    ntt_inverse<kOut>(dig, N, logN, P, res[pi]);
    __syncthreads();
  }
  const uint32_t* c = tab + (size_t)kPrimes * kTabRows * N;
  const uint32_t P1 = __ldg(c + 0), P2 = __ldg(c + 5);
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    delta[o][0] = crt(res[0][o][0], res[1][o][0], P1, P2, c + 10);
    delta[o][1] = crt(res[0][o][1], res[1][o][1], P1, P2, c + 10);
  }
}

}  // namespace tfhe
