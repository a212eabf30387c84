// Hand-written Hopper kernel of the small-batch blind rotate (sm_90a), with a
// plain C interface for ctypes (tfhe_tpu_torch/ops/_build.py,
// tfhe_tpu_torch/ops/cmux_packed.py).
//
// Replaces tfhe_tpu/ops/cmux_pallas_packed.py:blind_rotate_fused_packed
// (:259, body _scan_kernel_packed :234 and _cmux_iter :183): all n CMux steps
// of a blind rotate for the serial-circuit batches (B <= SMALL_BATCH_MAX in
// core/bootstrap.py). It computes the same accumulator as blind_rotate_kernel
// in cmux.cu, bit for bit. The TPU kernel's tile layout, roll ladder and
// twiddle planes exist to fill 128-lane vector registers and are not carried
// over: the rotation is index arithmetic and the transforms are the shared
// butterfly loops of extern_product.cuh.
//
// Design: blind_rotate_kernel gives one block to a sample, so at B = 1 one SM
// works and 131 idle. Here each sample gets a thread-block cluster of two
// CTAs, one per CRT prime. CTA p computes the digits of X^a * acc - acc,
// their 4 forward transforms mod p, the Shoup MAC against its prime's 32 KB
// key slice bk_ntt[j, p] (plus its Shoup twin), and the 2 inverse
// transforms: half the transforms of the one-block kernel. The CRT lift needs
// both residues of a coefficient, so each CTA writes its residues to shared
// memory, the cluster synchronises, and each reads its peer's residues
// through distributed shared memory (map_shared_rank). Both CTAs keep the
// whole accumulator (8 KB at N = 1024), because the next step's X^a rotation
// reads all of it, and both add the same delta. The residue buffer is double
// buffered by step parity, so one cluster barrier per step suffices: a CTA
// writes buffer j & 1 again only at step j + 2, after the barrier of step
// j + 1, which its peer reaches only once it has read step j's residues.
//
// A cluster of 2 rather than 4 (prime x output polynomial): the split by
// prime needs no sharing of the transformed digit rows, only the final
// residues, and at B = 64 its 128 CTAs of N/2 threads and 40 KB of shared
// memory fill one wave with one CTA per SM of the H100's 132.
//
// What bounds it on an H100: at small B the step is latency-bound, not
// throughput-bound. Each CTA runs, per CMux step, 4 + 2 transforms of
// log2(N) stages, about 21 block barriers and one cluster barrier, with
// little work between them (4 butterflies per thread and stage). Each CTA
// also reads 64 KB of key per step (value and Shoup twin of its prime's
// slice), which at B = 1 comes from device memory (the 65.5 MB key does not
// fit in the 50 MB L2) with no prefetch. Prefetching the next step's slice
// (cp.async or TMA) and fewer barriers are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "extern_product.cuh"

namespace cg = cooperative_groups;
using tfhe::kKpl;
using tfhe::kOut;
using tfhe::kPrimes;

extern "C" int tfhe_keyswitch(const int32_t* acc, const int8_t* tks, int32_t* r, int32_t* ext,
                              int B, int N, int C, int t, int basebit, unsigned int prec_offset,
                              cudaStream_t stream);

namespace {

// n CMux steps on a cluster of kPrimes CTAs per sample; CTA rank p works mod
// prime p. Coefficient i of polynomial c of sample s is
// acc_io[s * s_stride + c * c_stride + i], updated in place; bara int32[B][n]
// in [0, 2N); bk/bksh uint32[n][kPrimes][kKpl][kOut][N] (the bk_ntt layout).
__global__ void __cluster_dims__(kPrimes, 1, 1)
    blind_rotate_small_kernel(int32_t* __restrict__ acc_io, int s_stride, int c_stride,
                              const int32_t* __restrict__ bara, const uint32_t* __restrict__ bk,
                              const uint32_t* __restrict__ bksh, const uint32_t* __restrict__ tab,
                              int n, int N, int logN, int bgbit, uint32_t offset) {
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;                       // [kOut][N]
  uint32_t* dig = smem + kOut * N;            // [kKpl][N]
  uint32_t* xch = smem + (kOut + kKpl) * N;   // [2 buffers][kOut][N] residues
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned peer = rank ^ 1u;
  const int b = threadIdx.x;
  const int half = N >> 1;
  const uint32_t mask = (1u << bgbit) - 1u;
  const int s = blockIdx.x / kPrimes;
  uint32_t* g = reinterpret_cast<uint32_t*>(acc_io) + (size_t)s * s_stride;
  const int32_t* a_s = bara + (size_t)s * n;
  const tfhe::Prime P = tfhe::load_prime(tab, N, (int)rank);
  const uint32_t* cst = tab + (size_t)kPrimes * tfhe::kTabRows * N;
  const uint32_t P1 = __ldg(cst + 0), P2 = __ldg(cst + 5);
  const size_t slice = (size_t)kKpl * kOut * N;   // one prime's key slice of one step

#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    acc[c * N + b] = g[(size_t)c * c_stride + b];
    acc[c * N + b + half] = g[(size_t)c * c_stride + b + half];
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const int a = __ldg(a_s + j);
    // digits of X^a * acc - acc, row c*l + p (offset form, in [0, Bg))
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
        dig[(2 * c) * N + i] = (u >> (32 - bgbit)) & mask;
        dig[(2 * c + 1) * N + i] = (u >> (32 - 2 * bgbit)) & mask;
      }
    }
    __syncthreads();
    tfhe::ntt_forward<kKpl>(dig, N, logN, P);

    // MAC against this prime's slice; coefficient i of every row is read and
    // written by this thread only
    const uint32_t* w = bk + ((size_t)j * kPrimes + rank) * slice;
    const uint32_t* wsh = bksh + ((size_t)j * kPrimes + rank) * slice;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = b + q * half;
      const uint32_t one = __ldg(P.ones + i);
      uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
      for (int r = 0; r < kKpl; ++r) {
        const uint32_t dv = tfhe::subm(dig[r * N + i], one, P.p);
        const size_t o = (size_t)(r * kOut) * N + i;
        acc0 = tfhe::addm(acc0, tfhe::mulm(dv, __ldg(w + o), __ldg(wsh + o), P.p), P.p);
        acc1 = tfhe::addm(acc1, tfhe::mulm(dv, __ldg(w + o + N), __ldg(wsh + o + N), P.p), P.p);
      }
      dig[i] = acc0;
      dig[N + i] = acc1;
    }
    __syncthreads();
    uint32_t res[kOut][2];
    tfhe::ntt_inverse<kOut>(dig, N, logN, P, res);

    // exchange residues with the peer CTA, then the CRT lift of both
    uint32_t* mine = xch + (size_t)(j & 1) * kOut * N;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      mine[o * N + b] = res[o][0];
      mine[o * N + b + half] = res[o][1];
    }
    cluster.sync();
    const uint32_t* theirs = cluster.map_shared_rank(mine, peer);
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = b + q * half;
        const uint32_t other = theirs[o * N + i];
        const uint32_t r1 = rank == 0 ? res[o][q] : other;
        const uint32_t r2 = rank == 0 ? other : res[o][q];
        acc[o * N + i] += tfhe::crt(r1, r2, P1, P2, cst + 10);
      }
    }
    __syncthreads();
  }

  // the peer may still read this CTA's residues of the last step
  cluster.sync();
  if (rank == 0) {
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      g[(size_t)c * c_stride + b] = acc[c * N + b];
      g[(size_t)c * c_stride + b + half] = acc[c * N + b + half];
    }
  }
}

int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

cudaError_t launch_small(int32_t* acc, int s_stride, int c_stride, const int32_t* bara,
                         const uint32_t* bk, const uint32_t* bksh, const uint32_t* tab, int B,
                         int n, int N, int bgbit, uint32_t offset, cudaStream_t stream) {
  const size_t smem = (size_t)(kOut + kKpl + 2 * kOut) * N * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blind_rotate_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  blind_rotate_small_kernel<<<kPrimes * B, N / 2, smem, stream>>>(
      acc, s_stride, c_stride, bara, bk, bksh, tab, n, N, log2i(N), bgbit, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// acc_p int32[(k+1)][B][N] (the packed layout: polynomial c of sample s at
// row c*B + s), updated in place.
int tfhe_blind_rotate_small(int32_t* acc_p, const int32_t* bara, const uint32_t* bk,
                            const uint32_t* bksh, const uint32_t* tab, int B, int n, int N,
                            int bgbit, unsigned int offset, cudaStream_t stream) {
  return (int)launch_small(acc_p, N, B * N, bara, bk, bksh, tab, B, n, N, bgbit, offset, stream);
}

// The bootstrap of a small batch: the blind rotate on acc int32[B][k+1][N]
// (in place), then sample extract and key switch (cmux.cu keyswitch_kernel)
// into r int32[B][C] and ext int32[2][B].
int tfhe_blind_rotate_small_ks(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                               const uint32_t* bksh, const uint32_t* tab, const int8_t* tks,
                               int32_t* r, int32_t* ext, int B, int n, int N, int bgbit,
                               unsigned int offset, int C, int t, int basebit,
                               unsigned int prec_offset, cudaStream_t stream) {
  const cudaError_t err =
      launch_small(acc, kOut * N, N, bara, bk, bksh, tab, B, n, N, bgbit, offset, stream);
  if (err != cudaSuccess) return (int)err;
  return tfhe_keyswitch(acc, tks, r, ext, B, N, C, t, basebit, prec_offset, stream);
}

}  // extern "C"
