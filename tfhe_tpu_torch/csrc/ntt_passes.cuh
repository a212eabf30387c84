// What the blind-rotate kernels of cmux.cu (through extern_product.cuh) and of
// blind_rotate_small.cu share: the table layout, Shoup arithmetic, pass-wise
// negacyclic transforms on values in registers, and shared-memory barriers.
//
// A forward pass runs three stages of the DIF transform on 8 values a thread,
// the last one or two stages are done by the threads of the multiply-accumulate
// on the 4 neighbours they read anyway, and an inverse pass runs two stages of
// the DIT transform on 4 values so that every thread has work. Between passes
// the rows live in shared memory in the padded layout of pad(). With N a
// compile-time value every pass unrolls: shifts and shared-memory offsets are
// immediates.
//
// Lazy reduction (both primes are below 2^30, so 4p fits in 32 bits): inside
// the transforms values stay in [0, 4p) (forward) or [0, 2p) (inverse) and a
// Shoup product skips its last conditional subtraction; the residues that
// leave the inverse transform are reduced to [0, p), so they are the numbers
// a fully reduced transform gives.
#pragma once

#include <cstdint>

namespace tfhe {

constexpr int kOut = 2;      // k+1 output polynomials (k = 1); a kernel's gadget length L
                             // (2 or 3) is a template parameter: kOut * L digit rows
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

__device__ __forceinline__ uint32_t subm(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a - b + p;
}

// x * w mod p for a fixed w with w_sh = floor(w * 2^32 / p); result in [0, p).
__device__ __forceinline__ uint32_t mulm(uint32_t x, uint32_t w, uint32_t w_sh, uint32_t p) {
  const uint32_t q = __umulhi(x, w_sh);
  const uint32_t r = x * w - q * p;
  return r >= p ? r - p : r;
}

// A transform row in shared memory: element e at word e + e/16, which keeps
// the strided reads and writes of every pass to two-way bank conflicts at
// most. For the element sets of the passes below (base + j*u, j < 8 or 4, u a
// power of two, base = hi*8u + lo or hi*4u + lo with lo < u)
// pad(base + j*u) = pad(base) + pad(j*u), a constant offset once the pass is
// unrolled.
__device__ __forceinline__ int pad(int e) { return e + (e >> 4); }
__host__ __device__ constexpr int row_words(int N) { return N + (N >> 4); }

// x * w mod p up to one p: in [0, 2p) for any 32-bit x.
__device__ __forceinline__ uint32_t lazy_mul(uint32_t x, uint32_t w, uint32_t w_sh, uint32_t p) {
  return x * w - __umulhi(x, w_sh) * p;
}
// x in [0, 2m) -> [0, m)
__device__ __forceinline__ uint32_t fold(uint32_t x, uint32_t m) { return min(x, x - m); }

// Forward stages s0, s0 + 1, s0 + 2 of the DIF transform (natural ->
// bit-reversed order) on the 8 values v[j] = x[hi*8u + lo + j*u],
// u = N >> (s0 + 3): stage s0 + a pairs j with j + (4 >> a), and element
// hi*8u + lo + j*u lies in group hi*2^a + (j >> (3 - a)) of that stage.
// tw[i] = (psi_br[i], its Shoup twin). Values in and out in [0, 4p).
__device__ __forceinline__ void fwd_pass(uint32_t (&v)[8], int s0, int hi, const uint2* tw,
                                         uint32_t p) {
  const uint32_t p2 = 2u * p;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const uint2* t = tw + (1 << (s0 + a)) + (hi << a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((j & (4 >> a)) == 0) {
        const uint2 w = t[j >> (3 - a)];
        const uint32_t x = fold(v[j], p2);
        const uint32_t wv = lazy_mul(v[j + (4 >> a)], w.x, w.y, p);
        v[j] = x + wv;
        v[j + (4 >> a)] = x + p2 - wv;
      }
    }
  }
}

// The last `tail` (0, 1 or 2) forward stages on the 4 neighbouring values
// v[j] = x[4*g + j]: stage logN - 2 pairs j with j + 2 (group g), stage
// logN - 1 pairs j with j + 1 (group 2g + (j >> 1)).
__device__ __forceinline__ void fwd_tail(uint32_t (&v)[4], int tail, int g, int N,
                                         const uint2* tw, uint32_t p) {
  const uint32_t p2 = 2u * p;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a >= 2 - tail) {
      const uint2* t = tw + (N >> (2 - a)) + (g << a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((j & (2 >> a)) == 0) {
          const uint2 w = t[j >> (2 - a)];
          const uint32_t x = fold(v[j], p2);
          const uint32_t wv = lazy_mul(v[j + (2 >> a)], w.x, w.y, p);
          v[j] = x + wv;
          v[j + (2 >> a)] = x + p2 - wv;
        }
      }
    }
  }
}

// Inverse stages lt0 + a, a = a_first .. 1, of the DIT transform
// (bit-reversed -> natural order) on the 4 values v[j] = x[hi*4u + lo + j*u],
// u = 1 << lt0: stage lt0 + a pairs j with j + (1 << a); the element lies in
// group hi*(2 >> a) + (j >> (a + 1)). tw[i] = (ipsi_br[i], its Shoup twin).
// Values in and out in [0, 2p); the last stage (lt = logN - 1) carries N^-1
// and leaves residues in [0, p).
__device__ __forceinline__ void inv_pass(uint32_t (&v)[4], int lt0, int a_first, int hi, int N,
                                         int logN, const uint2* tw, const tfhe::Prime& P) {
  const uint32_t p2 = 2u * P.p;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a >= a_first) {
      const int lt = lt0 + a;
      if (lt == logN - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((j & (1 << a)) == 0) {
            const uint32_t x = v[j], y = v[j + (1 << a)];
            v[j] = fold(lazy_mul(x + y, P.ninv, P.ninv_sh, P.p), P.p);
            v[j + (1 << a)] = fold(lazy_mul(x + p2 - y, P.ip1, P.ip1_sh, P.p), P.p);
          }
        }
      } else {
        const uint2* t = tw + (N >> (lt + 1)) + hi * (2 >> a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if ((j & (1 << a)) == 0) {
            const uint2 w = t[j >> (a + 1)];
            const uint32_t x = v[j], y = v[j + (1 << a)];
            v[j] = fold(x + y, p2);
            v[j + (1 << a)] = lazy_mul(x + p2 - y, w.x, w.y, P.p);
          }
        }
      }
    }
  }
}

// ---- shared-memory barriers with transaction counts: a thread that expects
// bytes (a bulk copy, or another CTA's st.async) arrives with the count, the
// readers wait for the phase to flip

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

}  // namespace tfhe
