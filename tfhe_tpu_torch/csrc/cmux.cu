// Hand-written Hopper kernels of the gate bootstrap (sm_90a), with a plain C
// interface for ctypes (tfhe_tpu_torch/ops/_build.py, tfhe_tpu_torch/ops/cmux.py).
//
// Kernels and the TPU kernels they replace (tfhe_tpu/ops/cmux_pallas.py):
//   cmux_delta_kernel   <- cmux_delta (:575, body _kernel :225): one external
//                          product, the card's test of the NTT alone.
//   blind_rotate_kernel <- blind_rotate_fused (:533, body _scan_kernel :369)
//                          and, with n = 1, blind_rotate_step (:312,
//                          _step_kernel :291): all n CMux steps in one launch.
//   keyswitch_kernel    <- the key-switch epilogue of blind_rotate_ks_fused
//                          (:485, _scan_ks_kernel :398); tfhe_blind_rotate_ks
//                          launches blind_rotate_kernel and then this kernel,
//                          blind_rotate_small.cu its own blind rotate and then
//                          this kernel (through tfhe_keyswitch).
//
// Design (first, simple version): one block of N/2 threads per sample. The
// accumulator int32[2][N] (8 KB at N = 1024) stays in shared memory for all
// n steps, beside the 4 digit rows (16 KB). The per-sample X^a rotation is
// index arithmetic, as in the reference's torusPolynomialMulByXai, not the
// TPU's roll bit-ladder (:333-350).
//
// What bounds it on an H100: every block streams the whole bootstrapping key,
// value and Shoup twin, 2 x 32.8 MB = 65.5 MB at PARAMS_110, once per
// bootstrap. At B = 256 that is 256 passes over a key larger than the 50 MB
// L2. Blocks run the steps in roughly the same order, so most slices are
// shared in L2 by the blocks in flight; the arithmetic (2 primes x 6
// transforms of 10 stages, each behind a barrier) is the other bound. Sharing
// one key read between several samples of a block is later work.
//
// The key switch (keyswitch_kernel) needs no matrix unit: the one-hot digit
// matrix of the TPU version is a gather-sum. For each nonzero base-4 digit
// h of coefficient m, digit position j, the block adds the int8 limb row
// tks[j*(base-1) + h-1][m][:] (4 limbs x C columns) into int32 sums, then
// recombines l0 + l1<<8 + l2<<16 + l3<<24 with uint32 wrap. The 48 MiB table
// does not fit in shared memory; it is read from global memory through L2.
// The TPU kernel summed in float32 (exact there); int32 is exact here.

#include <cuda_runtime.h>

#include <cstdint>

#include "extern_product.cuh"

using tfhe::kKpl;
using tfhe::kOut;

namespace {

constexpr int kSmemDefault = 48 * 1024;

// One external product per sample: dec int32[B][4][N] signed digits in
// [-Bg/2, Bg/2), out int32[B][2][N].
__global__ void cmux_delta_kernel(const int32_t* __restrict__ dec, const uint32_t* __restrict__ bk,
                                  const uint32_t* __restrict__ bksh,
                                  const uint32_t* __restrict__ tab, int32_t* __restrict__ out,
                                  int N, int logN, uint32_t half_bg) {
  extern __shared__ uint32_t smem[];
  const int b = threadIdx.x;
  const int half = N >> 1;
  const int32_t* d = dec + (size_t)blockIdx.x * kKpl * N;
  auto fill = [&](uint32_t* dig) {
#pragma unroll
    for (int r = 0; r < kKpl; ++r) {
      dig[r * N + b] = (uint32_t)d[r * N + b] + half_bg;
      dig[r * N + b + half] = (uint32_t)d[r * N + b + half] + half_bg;
    }
  };
  uint32_t delta[kOut][2];
  tfhe::extern_product(fill, bk, bksh, tab, N, logN, smem, delta);
  uint32_t* o = reinterpret_cast<uint32_t*>(out) + (size_t)blockIdx.x * kOut * N;
#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    o[c * N + b] = delta[c][0];
    o[c * N + b + half] = delta[c][1];
  }
}

// n CMux steps: acc int32[B][2][N] in place, bara int32[B][n] in [0, 2N),
// bk/bksh uint32[n][2][N][8].
__global__ void blind_rotate_kernel(int32_t* __restrict__ acc_io, const int32_t* __restrict__ bara,
                                    const uint32_t* __restrict__ bk,
                                    const uint32_t* __restrict__ bksh,
                                    const uint32_t* __restrict__ tab, int n, int N, int logN,
                                    int bgbit, uint32_t offset) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;               // [2][N]
  uint32_t* dig = smem + kOut * N;    // [4][N]
  const int b = threadIdx.x;
  const int half = N >> 1;
  const uint32_t mask = (1u << bgbit) - 1u;
  uint32_t* g = reinterpret_cast<uint32_t*>(acc_io) + (size_t)blockIdx.x * kOut * N;
  const int32_t* a_s = bara + (size_t)blockIdx.x * n;
  const size_t slice = (size_t)tfhe::kPrimes * N * 8;

#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    acc[c * N + b] = g[c * N + b];
    acc[c * N + b + half] = g[c * N + b + half];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int a = __ldg(a_s + j);
    // digits of X^a * acc - acc, row c*l + p (offset form, in [0, Bg))
    auto fill = [&](uint32_t* dg) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = b + q * half;
          int d = i - a;
          if (d < 0) d += 2 * N;
          const bool neg = d >= N;
          const uint32_t v = acc[c * N + (neg ? d - N : d)];
          const uint32_t u = (neg ? 0u - v : v) - acc[c * N + i] + offset;
          dg[(2 * c) * N + i] = (u >> (32 - bgbit)) & mask;
          dg[(2 * c + 1) * N + i] = (u >> (32 - 2 * bgbit)) & mask;
        }
      }
    };
    uint32_t delta[kOut][2];
    tfhe::extern_product(fill, bk + j * slice, bksh + j * slice, tab, N, logN, dig, delta);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      acc[c * N + b] += delta[c][0];
      acc[c * N + b + half] += delta[c][1];
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    g[c * N + b] = acc[c * N + b];
    g[c * N + b + half] = acc[c * N + b + half];
  }
}

// Sample extract (native order: x[m] = acc0[0] if m == 0 else -acc0[m]) and
// key switch of one sample per block of C/4 threads; thread tid owns columns
// 4*tid .. 4*tid+3 of every limb plane. tks int8[t*(base-1)][N][4*C];
// r int32[B][C]; ext int32[2][B] = (b_ext, count of nonzero digits).
__global__ void keyswitch_kernel(const int32_t* __restrict__ acc, const int8_t* __restrict__ tks,
                                 int32_t* __restrict__ r, int32_t* __restrict__ ext, int B,
                                 int N, int C, int t, int basebit, uint32_t prec_offset) {
  extern __shared__ uint32_t su[];    // [N] offset coefficients, then the digit count
  const int tid = threadIdx.x;
  const uint32_t dmask = (1u << basebit) - 1u;
  const int bm1 = (1 << basebit) - 1;
  const uint32_t* a0 = reinterpret_cast<const uint32_t*>(acc) + (size_t)blockIdx.x * kOut * N;
  if (tid == 0) su[N] = 0u;
  uint32_t nnz = 0;
  for (int m = tid; m < N; m += blockDim.x) {
    const uint32_t x = m == 0 ? a0[0] : 0u - a0[m];
    const uint32_t u = x + prec_offset;
    su[m] = u;
    for (int jd = 0; jd < t; ++jd) nnz += ((u >> (32 - (jd + 1) * basebit)) & dmask) != 0u;
  }
  __syncthreads();
  atomicAdd(su + N, nnz);

  int sum[4][4] = {};
  const size_t row_bytes = 4 * (size_t)C;
  for (int m = 0; m < N; ++m) {
    const uint32_t u = su[m];
    for (int jd = 0; jd < t; ++jd) {
      const uint32_t h = (u >> (32 - (jd + 1) * basebit)) & dmask;
      if (h == 0u) continue;
      const int8_t* row = tks + ((size_t)(jd * bm1 + (int)h - 1) * N + m) * row_bytes;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const char4 v = __ldg(reinterpret_cast<const char4*>(row + (size_t)l * C) + tid);
        sum[l][0] += v.x;
        sum[l][1] += v.y;
        sum[l][2] += v.z;
        sum[l][3] += v.w;
      }
    }
  }
  uint32_t* ro = reinterpret_cast<uint32_t*>(r) + (size_t)blockIdx.x * C + 4 * tid;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    ro[q] = (uint32_t)sum[0][q] + ((uint32_t)sum[1][q] << 8) + ((uint32_t)sum[2][q] << 16) +
            ((uint32_t)sum[3][q] << 24);
  }
  __syncthreads();
  if (tid == 0) {
    ext[blockIdx.x] = acc[(size_t)blockIdx.x * kOut * N + N];
    ext[B + blockIdx.x] = (int32_t)su[N];
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

cudaError_t launch_blind_rotate(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                                const uint32_t* bksh, const uint32_t* tab, int B, int n, int N,
                                int bgbit, uint32_t offset, cudaStream_t stream) {
  const size_t smem = (size_t)(kOut + kKpl) * N * sizeof(uint32_t);
  cudaError_t err = allow_smem(blind_rotate_kernel, smem);
  if (err != cudaSuccess) return err;
  blind_rotate_kernel<<<B, N / 2, smem, stream>>>(acc, bara, bk, bksh, tab, n, N, log2i(N), bgbit,
                                                  offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int tfhe_cmux_delta(const int32_t* dec, const uint32_t* bk, const uint32_t* bksh,
                    const uint32_t* tab, int32_t* out, int B, int N, int half_bg,
                    cudaStream_t stream) {
  const size_t smem = (size_t)kKpl * N * sizeof(uint32_t);
  cudaError_t err = allow_smem(cmux_delta_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cmux_delta_kernel<<<B, N / 2, smem, stream>>>(dec, bk, bksh, tab, out, N, log2i(N),
                                                (uint32_t)half_bg);
  return (int)cudaGetLastError();
}

int tfhe_blind_rotate(int32_t* acc, const int32_t* bara, const uint32_t* bk, const uint32_t* bksh,
                      const uint32_t* tab, int B, int n, int N, int bgbit, unsigned int offset,
                      cudaStream_t stream) {
  return (int)launch_blind_rotate(acc, bara, bk, bksh, tab, B, n, N, bgbit, offset, stream);
}

// Sample extract and key switch of acc int32[B][2][N]; also called by
// blind_rotate_small.cu after its blind rotate.
int tfhe_keyswitch(const int32_t* acc, const int8_t* tks, int32_t* r, int32_t* ext, int B, int N,
                   int C, int t, int basebit, unsigned int prec_offset, cudaStream_t stream) {
  const size_t smem = (size_t)(N + 1) * sizeof(uint32_t);
  const cudaError_t err = allow_smem(keyswitch_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  keyswitch_kernel<<<B, C / 4, smem, stream>>>(acc, tks, r, ext, B, N, C, t, basebit, prec_offset);
  return (int)cudaGetLastError();
}

int tfhe_blind_rotate_ks(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                         const uint32_t* bksh, const uint32_t* tab, const int8_t* tks,
                         int32_t* r, int32_t* ext, int B, int n, int N, int bgbit,
                         unsigned int offset, int C, int t, int basebit,
                         unsigned int prec_offset, cudaStream_t stream) {
  const cudaError_t err =
      launch_blind_rotate(acc, bara, bk, bksh, tab, B, n, N, bgbit, offset, stream);
  if (err != cudaSuccess) return (int)err;
  return tfhe_keyswitch(acc, tks, r, ext, B, N, C, t, basebit, prec_offset, stream);
}

const char* tfhe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
