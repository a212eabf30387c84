// Hand-written Hopper kernel of the small-batch blind rotate (sm_90a), with a
// plain C interface for ctypes (tfhe_tpu_torch/ops/_build.py,
// tfhe_tpu_torch/ops/cmux_packed.py).
//
// Replaces tfhe_tpu/ops/cmux_pallas_packed.py:blind_rotate_fused_packed
// (:259, pallas_call :283, body _scan_kernel_packed :234 and _cmux_iter :183):
// all n CMux steps of a blind rotate for the flat batches that
// core/bootstrap.py routes here (small_batch()). It computes the same
// accumulator as blind_rotate_kernel in cmux.cu, bit for bit. The TPU
// kernel's tile layout, roll ladder and twiddle planes exist to fill 128-lane
// vector registers and are not carried over: the rotation is index arithmetic.
//
// What bounds it on an H100: latency, not throughput. A sample's 500 CMux
// steps are a dependent chain; the card could stream the 65.5 MB key in
// 0.02 ms and do one sample's arithmetic in 0.015 ms, the kernel takes about
// 1.9 ms at B = 1. A step is a chain of short phases (a few butterflies a
// thread) behind barriers, on one to four SMs per sample. The design cuts the
// chain's length and the work in it:
//
// - A cluster of 4 CTAs per sample (prime x polynomial; batches that fit one
//   wave of such clusters) or of 2 (one per prime; larger batches):
//   ops/cmux_packed.py small_cluster chooses. With 4, CTA (p, h) keeps acc[h],
//   forward-transforms the l digit rows of X^a * acc[h] - acc[h] mod p,
//   sends them to CTA (p, 1-h), and computes output polynomial h: half the
//   work of a CTA of the cluster of 2, for one more exchange a step. The
//   gadget length l (2 or 3) is a template parameter; at l = 3 the threads of
//   the first row groups of the forward passes also take the rows past 2*NH.
// - Transforms that keep three stages in registers: a forward pass loads 8
//   values a thread, runs stages s0 .. s0+2 on them and stores them (10 stages
//   at N = 1024: 3 passes, the last stage done by the MAC's threads on the 4
//   neighbours they read anyway); the inverse runs two stages a pass on 4
//   values a thread, so that every thread has work. 9 block barriers a step
//   instead of about 44 (two primes in one block) or 22.
// - Lazy reduction (Harvey butterflies): 7 operations a butterfly, not 11.
// - N is a template parameter: every pass is unrolled, shifts and
//   shared-memory offsets are immediates. The padded row layout (pad())
//   keeps each pass's strided accesses to two-way bank conflicts.
// - Twiddles (value and Shoup twin interleaved) are loaded into shared memory
//   once, before the loop.
// - In the cluster of 4 the next step's key rows (32 KB with the Shoup twins
//   at l = 2, 48 KB at l = 3)
//   are fetched by cp.async into a double buffer at the top of each step and
//   the MAC reads shared memory. That buffer limits an SM to one CTA at
//   N = 1024. The cluster of 2 serves the batches of more than one wave and
//   goes without it: the MAC reads the key itself, which the batch's other
//   CTAs keep in L2, and two CTAs share an SM (132 samples at once).
// - The CTAs exchange digit rows and residues by st.async into each other's
//   shared memory, completing on the receiver's mbarrier: the receiver waits
//   for the bytes it expects. cooperative_groups' cluster.sync() compiles to
//   a GPU-scope fence (MEMBAR.ALL.GPU) and an L1 invalidate (CCTL.IVALL) each
//   time and is used only before the loop and after it. Buffers that another CTA writes are
//   double-buffered by step parity: a CTA runs at most one step ahead of the
//   CTA it sends to, because it needs that CTA's data of the step before.
//
// Tried and dropped, each slower on the card: the cluster of 2 with
// cluster.sync() and remote reads of the peer's residues, the inverse on 8
// values a thread with half the threads idle, N as a run-time value with one
// code path (about twice the operations a step, most of them addresses). The
// cluster of 2 with staged key rows (one CTA an SM, 66 samples at once) was
// 6 % faster than without for batches of 31 to 66 (2.20 against 2.35 ms) and
// moved no 16-bit operation beyond run-to-run spread: taken out.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;
using tfhe::kOut;
using tfhe::kPrimes;
using tfhe::fold;
using tfhe::fwd_pass;
using tfhe::fwd_tail;
using tfhe::inv_pass;
using tfhe::lazy_mul;
using tfhe::mbar_arrive_expect_tx;
using tfhe::mbar_init;
using tfhe::mbar_wait;
using tfhe::mulm;
using tfhe::pad;
using tfhe::row_words;
using tfhe::shared_u32;
using tfhe::subm;

extern "C" int tfhe_keyswitch(const int32_t* acc, const int8_t* tks, int32_t* sums, int32_t* r,
                              int32_t* ext, int B, int N, int C, int t, int basebit,
                              unsigned int prec_offset, int mma, int split, int pairs,
                              unsigned int b_add, cudaStream_t stream);

namespace {

// ---- shared-memory barriers with transaction counts, and stores into
// another CTA of the cluster that complete on the receiver's barrier: the
// receiver waits for the bytes it expects, with no fence and no cluster-wide
// barrier

// the shared::cluster address of `addr` (a shared::cta address) in CTA `rank`
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async(uint32_t remote_addr, uint32_t v, uint32_t remote_bar) {
  asm volatile("st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::
                   "r"(remote_addr), "r"(v), "r"(remote_bar)
               : "memory");
}

// n CMux steps on a cluster of kPrimes * kOut / NH CTAs per sample at gadget
// length GL. A CTA works mod one prime on NH of the kOut polynomials: NH = 1
// (cluster of 4, rank 2*prime + h): it keeps acc[h], forward-transforms the
// GL digit rows of X^a * acc[h] - acc[h], takes the other GL rows from the
// CTA of the same prime and the other polynomial, and computes output
// polynomial h of the external product. NH = 2 (cluster of 2, rank =
// prime): all 2*GL rows and both outputs. Either way the CTA of the other
// prime sends its residues of the same polynomials for the CRT lift.
// Coefficient i of polynomial c of sample s is acc_io[s * s_stride + c *
// c_stride + i], updated in place; bara int32[B][n] in [0, 2N); bk/bksh
// uint32[n][kPrimes][2*GL][kOut][N] (the bk_ntt layout). NH * N/4 threads:
// in the forward transforms a thread owns 8 elements of a digit row (two
// rows at GL = 3 for the threads of the first row groups), in the MAC, the
// inverse transform and the CRT 4.
template <int LOGN, int GL, int NH>
__global__ void __launch_bounds__(NH << (LOGN - 2), NH)
    blind_rotate_small_kernel(int32_t* __restrict__ acc_io, int s_stride, int c_stride,
                              const int32_t* __restrict__ bara, const uint32_t* __restrict__ bk,
                              const uint32_t* __restrict__ bksh, const uint32_t* __restrict__ tab,
                              int n, int bgbit, uint32_t offset) {
  constexpr int N = 1 << LOGN;
  constexpr bool STAGED = NH == 1;                    // key rows through shared memory
  constexpr int RS = row_words(N);
  constexpr int NT = NH * (N >> 2);                   // threads
  constexpr int QUARTER = N >> 2, EIGHTH = N >> 3;
  constexpr int TAIL = LOGN % 3;                      // forward stages left to the MAC
  constexpr int KPL = kOut * GL;                      // digit rows of a sample
  constexpr int GROUPS = 2 * NH;                      // forward row groups of N/8 threads
  constexpr int OWN = GL * NH;                        // digit rows made here
  constexpr int RPT = (OWN + GROUPS - 1) / GROUPS;    // forward rows a thread
  constexpr int KEYW = KPL * NH * N;                  // words of this CTA's key rows of one step
  constexpr uint32_t RES_BYTES = NH * N * 4;          // residues the CTA of the other prime sends
  constexpr uint32_t ROW_BYTES = GL * N * 4;          // digit rows the CTA of the other polynomial sends
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* keybuf = smem;                            // STAGED: [2 buffers][value, Shoup twin][KPL][NH][N]
  uint2* twf = reinterpret_cast<uint2*>(keybuf + (STAGED ? 4 * KEYW : 0));   // [N] (psi, psi_sh)
  uint2* twi = twf + N;                               // [N] (ipsi, ipsi_sh)
  uint64_t* bars = reinterpret_cast<uint64_t*>(twi + N);            // [2 kinds][2 parities]
  uint32_t* acc = reinterpret_cast<uint32_t*>(bars + 4);            // [NH][N]
  uint32_t* xch = acc + NH * N;                       // [2 parities][kPrimes][NH][N] residues
  uint32_t* ibuf = xch + 2 * kPrimes * NH * N;        // [NH][RS] inverse rows
  uint32_t* own = ibuf + NH * RS;                     // [OWN][RS] forward rows made here
  uint32_t* recv = own + OWN * RS;                    // NH == 1: [2 parities][GL][RS] rows received
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int prime = NH == 2 ? (int)rank : (int)(rank >> 1);
  const int h = NH == 2 ? 0 : (int)(rank & 1u);       // first polynomial of this CTA
  const unsigned res_peer = NH == 2 ? rank ^ 1u : rank ^ 2u;
  const int tid = threadIdx.x;
  const int row = tid / EIGHTH, q = tid % EIGHTH;     // forward: digit row GL*h + row, group of 8
  const int pol = tid / QUARTER, iq = tid % QUARTER;  // MAC, inverse: polynomial h + pol, group of 4
  const uint32_t mask = (1u << bgbit) - 1u;
  const uint32_t half_bg = 1u << (bgbit - 1);
  const int s = blockIdx.x / (kPrimes * kOut / NH);
  uint32_t* g = reinterpret_cast<uint32_t*>(acc_io) + (size_t)s * s_stride;
  const int32_t* a_s = bara + (size_t)s * n;
  const tfhe::Prime P = tfhe::load_prime(tab, N, prime);
  const uint32_t* cst = tab + (size_t)kPrimes * tfhe::kTabRows * N;
  const uint32_t P1 = __ldg(cst + 0), P2 = __ldg(cst + 5);
  const uint32_t crt_inv = __ldg(cst + 10), crt_inv_sh = __ldg(cst + 11);
  const uint32_t t_half = __ldg(cst + 12), r1_half = __ldg(cst + 13), m_mod = __ldg(cst + 14);
  const uint32_t bar_rows = shared_u32(bars), bar_res = shared_u32(bars + 2);
  // where this CTA's digit rows and residues go in the CTAs that take them
  const uint32_t recv_there = map_to_rank(shared_u32(recv), rank ^ 1u);
  const uint32_t bar_rows_there = map_to_rank(bar_rows, rank ^ 1u);
  const uint32_t xch_there = map_to_rank(shared_u32(xch), res_peer);
  const uint32_t bar_res_there = map_to_rank(bar_res, res_peer);

  // this CTA's key rows of step j, value and Shoup twin, into buffer j & 1
  auto prefetch = [&](int j) {
    if (STAGED && j < n) {
      const size_t at = ((size_t)j * kPrimes + prime) * KPL * kOut * N;
      uint4* dst = reinterpret_cast<uint4*>(keybuf + (size_t)(j & 1) * 2 * KEYW);
#pragma unroll
      for (int r = 0; r < KPL; ++r) {                // NT threads x 16 bytes = one row of NH polynomials
        const size_t src = at + (size_t)(r * kOut + h) * N + 4 * tid;
        __pipeline_memcpy_async(dst + r * NT + tid, bk + src, 16);
        __pipeline_memcpy_async(dst + KEYW / 4 + r * NT + tid, bksh + src, 16);
      }
    }
    __pipeline_commit();
  };
  prefetch(0);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(shared_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < N; i += NT) {
    twf[i] = make_uint2(__ldg(P.psi + i), __ldg(P.psi_sh + i));
    twi[i] = make_uint2(__ldg(P.ipsi + i), __ldg(P.ipsi_sh + i));
  }
  for (int i = tid; i < NH * N; i += NT) {
    acc[i] = g[(size_t)(h + i / N) * c_stride + (i % N)];
  }
  // every CTA of the cluster runs, with its barriers set up, before any
  // writes into another's shared memory
  cluster.sync();

  int a = __ldg(a_s);
  for (int j = 0; j < n; ++j) {
    const int par = j & 1;
    const uint32_t phase = (uint32_t)(j >> 1) & 1u;
    prefetch(j + 1);
    const int a_next = j + 1 < n ? __ldg(a_s + j + 1) : 0;
    if (tid == 0) {
      if (NH == 1) mbar_arrive_expect_tx(bar_rows + 8 * par, ROW_BYTES);
      mbar_arrive_expect_tx(bar_res + 8 * par, RES_BYTES);
    }

    // forward passes on the digits of X^a * acc[c] - acc[c], row c*GL + d,
    // signed: digit - Bg/2 as a residue. Pass 1 (stages 0-2) takes them
    // straight into registers. With NH == 1 the last pass also sends the
    // rows to the CTA of the other polynomial. A thread does rows row,
    // row + GROUPS, ... < OWN.
    {
      // the digits of row `r` at this thread's 8 elements
      auto digits = [&](int r, uint32_t (&v)[8]) {
        const int c = GL == 2 ? r >> 1 : r / GL, dl = GL == 2 ? r & 1 : r % GL;
        const uint32_t* ac = acc + c * N;
        const int sh = 32 - (dl + 1) * bgbit;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = q + jj * EIGHTH;
          int d = i - a;
          if (d < 0) d += 2 * N;
          const bool neg = d >= N;
          const uint32_t x = ac[neg ? d - N : d];
          const uint32_t u = (neg ? 0u - x : x) - ac[i] + offset;
          const uint32_t dg = (u >> sh) & mask;
          v[jj] = dg >= half_bg ? dg - half_bg : dg + P.p - half_bg;
        }
      };
#pragma unroll
      for (int s0 = 0; s0 < LOGN - TAIL; s0 += 3) {
        const int lu = LOGN - s0 - 3;
        const int hi = q >> lu;
        const int pb = pad((hi << (lu + 3)) + (q & ((1 << lu) - 1)));
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          const int r = row + GROUPS * rr;
          if (rr > 0 && r >= OWN) break;
          uint32_t v[8];
          uint32_t* x = own + r * RS;
          if (s0 > 0) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) v[jj] = x[pb + pad(jj << lu)];
          } else {
            digits(r, v);
          }
          fwd_pass(v, s0, hi, twf, P.p);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) x[pb + pad(jj << lu)] = v[jj];
          if (NH == 1 && s0 + 3 >= LOGN - TAIL) {
            const uint32_t there = recv_there + 4u * (uint32_t)((GL * par + r) * RS + pb);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              st_async(there + 4u * (uint32_t)pad(jj << lu), v[jj], bar_rows_there + 8 * par);
            }
          }
        }
        if (s0 + 3 < LOGN - TAIL) __syncthreads();
      }
    }
    __pipeline_wait_prior(1);                         // this step's key rows have landed
    __syncthreads();

    // the forward stages left over, the MAC against the key rows of output
    // h + pol at the 4 elements 4*iq .. 4*iq+3, then inverse pass 1 (stages
    // 0-1). With NH == 1 the rows made here come first and the wait for the
    // other two after them.
    uint32_t z[4];
    {
      const uint32_t* kb = keybuf + (size_t)par * 2 * KEYW;
      const uint32_t p2 = 2u * P.p;
      const int pb = pad(4 * iq);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) z[jj] = 0u;
#pragma unroll
      for (int k = 0; k < KPL; ++k) {
        // digit row; k < GL: a row made here
        const int r = NH == 2  ? k
                      : GL == 2 ? (k ^ (2 * h))
                      : k < GL  ? GL * h + k
                                : GL * (1 - h) + k - GL;
        if (NH == 1 && k == GL) mbar_wait(bar_rows + 8 * par, phase);
        uint4 w4, s4;
        if (STAGED) {
          const int at = (r * NH + pol) * N + 4 * iq;
          w4 = *reinterpret_cast<const uint4*>(kb + at);
          s4 = *reinterpret_cast<const uint4*>(kb + KEYW + at);
        } else {      // straight from the key: the batch's other CTAs keep it in L2
          const size_t at = ((size_t)j * kPrimes + prime) * KPL * kOut * N +
                            (size_t)(r * kOut + h + pol) * N + 4 * iq;
          w4 = __ldg(reinterpret_cast<const uint4*>(bk + at));
          s4 = __ldg(reinterpret_cast<const uint4*>(bksh + at));
        }
        const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
        const uint32_t sw[4] = {s4.x, s4.y, s4.z, s4.w};
        const uint32_t* src = NH == 2 ? own + r * RS
                              : GL == 2 ? (k < 2 ? own + (r & 1) * RS
                                                 : recv + (2 * par + (r & 1)) * RS)
                              : k < GL ? own + k * RS
                                       : recv + (GL * par + k - GL) * RS;
        uint32_t x[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) x[jj] = src[pb + jj];
        fwd_tail(x, TAIL, iq, N, twf, P.p);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          z[jj] = fold(z[jj] + lazy_mul(x[jj], w[jj], sw[jj], P.p), p2);
        }
      }
      inv_pass(z, 0, 0, iq, N, LOGN, twi, P);
      uint32_t* y = ibuf + pol * RS + pb;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) y[jj] = z[jj];
    }
    __syncthreads();
    // residues mod this prime: slot `prime` of buffer `par`, here and in the
    // CTA of the other prime
    const int slot = ((par * kPrimes + prime) * NH + pol) * N;
#pragma unroll
    for (int l0 = 2; l0 < LOGN; l0 += 2) {
      const bool last = l0 + 2 >= LOGN;
      const int l0e = l0 < LOGN - 2 ? l0 : LOGN - 2;
      const int hi = iq >> l0e;
      const int base = (hi << (l0e + 2)) + (iq & ((1 << l0e) - 1));
      uint32_t* y = ibuf + pol * RS + pad(base);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) z[jj] = y[pad(jj << l0e)];
      inv_pass(z, l0e, l0 - l0e, hi, N, LOGN, twi, P);
      if (last) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int at = slot + base + (jj << l0e);
          xch[at] = z[jj];
          st_async(xch_there + 4u * (uint32_t)at, z[jj], bar_res_there + 8 * par);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) y[pad(jj << l0e)] = z[jj];
      }
      __syncthreads();
    }

    // this CTA now holds both primes' residues of its polynomials: the CRT lift
    mbar_wait(bar_res + 8 * par, phase);
    const uint32_t* res = xch + par * kPrimes * NH * N;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = tid + k * NT;
      const uint32_t r1 = res[i], r2 = res[NH * N + i];
      const uint32_t r1p2 = r1 >= P2 ? r1 - P2 : r1;
      const uint32_t tt = mulm(subm(r2, r1p2, P2), crt_inv, crt_inv_sh, P2);
      const uint32_t rep = r1 + P1 * tt;
      const bool upper = tt > t_half || (tt == t_half && r1 >= r1_half);
      acc[i] += upper ? rep - m_mod : rep;
    }
    a = a_next;
    __syncthreads();
  }

  // no CTA leaves while another may still write into it
  cluster.sync();
  if (prime == 0) {
    for (int i = tid; i < NH * N; i += NT) g[(size_t)(h + i / N) * c_stride + (i % N)] = acc[i];
  }
}

int log2i(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Launch configuration of blind_rotate_small_kernel<LOGN, GL, NH> for B
// samples; raises the kernel's shared-memory limit where it needs more than
// the default, once per form and device (as cmux.cu's allow_smem_once): the
// first, eager call of a circuit does it, and the capture of the circuit as a
// CUDA graph (ops/cmux.py, arith.circuit) meets nothing but launches.
constexpr int kSmallDevices = 64;
template <int LOGN, int GL, int NH>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                      cudaStream_t stream) {
  constexpr int N = 1 << LOGN;
  constexpr int kCluster = kPrimes * kOut / NH;
  // two buffers of key rows with Shoup twins, twiddle pairs, barriers, acc,
  // two buffers of residues, inverse rows, forward rows made and received
  constexpr size_t words =
      (size_t)((NH == 1 ? 4 * kOut * GL : 0) + 4 + NH + 2 * kPrimes * NH) * N + 8 +
      (size_t)(NH + GL * NH + (NH == 1 ? 2 * GL : 0)) * row_words(N);
  constexpr size_t smem = sizeof(uint32_t) * words;
  if (smem > 48 * 1024) {
    static bool allowed[kSmallDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kSmallDevices || !allowed[dev]) {
      err = cudaFuncSetAttribute(blind_rotate_small_kernel<LOGN, GL, NH>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      if (dev < kSmallDevices) allowed[dev] = true;
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster * B);
  cfg->blockDim = dim3(NH * (N >> 2));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Runs the kernel when acc is given; else writes to *in_flight how many
// clusters (samples) the card holds at once.
template <int LOGN, int GL, int NH>
cudaError_t launch_as(int32_t* acc, int s_stride, int c_stride, const int32_t* bara,
                      const uint32_t* bk, const uint32_t* bksh, const uint32_t* tab, int B, int n,
                      int bgbit, uint32_t offset, cudaStream_t stream, int* in_flight) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure<LOGN, GL, NH>(&cfg, &attr, B, stream);
  if (err != cudaSuccess) return err;
  if (in_flight != nullptr) {
    return cudaOccupancyMaxActiveClusters(in_flight,
                                          blind_rotate_small_kernel<LOGN, GL, NH>, &cfg);
  }
  return cudaLaunchKernelEx(&cfg, blind_rotate_small_kernel<LOGN, GL, NH>, acc, s_stride, c_stride,
                            bara, bk, bksh, tab, n, bgbit, offset);
}

template <int GL, int NH>
cudaError_t launch_n(int32_t* acc, int s_stride, int c_stride, const int32_t* bara,
                     const uint32_t* bk, const uint32_t* bksh, const uint32_t* tab, int B, int n,
                     int N, int bgbit, uint32_t offset, cudaStream_t stream, int* in_flight) {
  switch (log2i(N)) {
#define TFHE_CASE(L)                                                                             \
  case L:                                                                                        \
    return launch_as<L, GL, NH>(acc, s_stride, c_stride, bara, bk, bksh, tab, B, n, bgbit, offset, \
                                stream, in_flight);
    TFHE_CASE(6)
    TFHE_CASE(7)
    TFHE_CASE(8)
    TFHE_CASE(9)
    TFHE_CASE(10)
#undef TFHE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int GL>
cudaError_t launch_gl(int32_t* acc, int s_stride, int c_stride, const int32_t* bara,
                      const uint32_t* bk, const uint32_t* bksh, const uint32_t* tab, int B, int n,
                      int N, int bgbit, uint32_t offset, int cluster, cudaStream_t stream,
                      int* in_flight) {
  if (cluster == 4) {
    return launch_n<GL, 1>(acc, s_stride, c_stride, bara, bk, bksh, tab, B, n, N, bgbit, offset,
                           stream, in_flight);
  }
  if (cluster == 2) {
    return launch_n<GL, 2>(acc, s_stride, c_stride, bara, bk, bksh, tab, B, n, N, bgbit, offset,
                           stream, in_flight);
  }
  return cudaErrorInvalidValue;
}

// `cluster` CTAs per sample: 4 (one polynomial of one prime each, key rows
// through shared memory, one CTA per SM at N = 1024) or 2 (one prime each,
// the MAC reads the key itself, two CTAs per SM: slower per sample, more
// samples at once). ops/cmux_packed.py small_cluster chooses by the batch.
// Gadget length l = 2 or 3.
cudaError_t launch_small(int32_t* acc, int s_stride, int c_stride, const int32_t* bara,
                         const uint32_t* bk, const uint32_t* bksh, const uint32_t* tab, int B,
                         int n, int N, int l, int bgbit, uint32_t offset, int cluster,
                         cudaStream_t stream, int* in_flight = nullptr) {
  if (N < 64 || N > 1024 || (N & (N - 1)) || n < 1 || B < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  if (l == 2) {
    err = launch_gl<2>(acc, s_stride, c_stride, bara, bk, bksh, tab, B, n, N, bgbit, offset,
                       cluster, stream, in_flight);
  } else if (l == 3) {
    err = launch_gl<3>(acc, s_stride, c_stride, bara, bk, bksh, tab, B, n, N, bgbit, offset,
                       cluster, stream, in_flight);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// acc_p int32[(k+1)][B][N] (the packed layout: polynomial c of sample s at
// row c*B + s), updated in place.
int tfhe_blind_rotate_small(int32_t* acc_p, const int32_t* bara, const uint32_t* bk,
                            const uint32_t* bksh, const uint32_t* tab, int B, int n, int N, int l,
                            int bgbit, unsigned int offset, int cluster, cudaStream_t stream) {
  return (int)launch_small(acc_p, N, B * N, bara, bk, bksh, tab, B, n, N, l, bgbit, offset,
                           cluster, stream);
}

// How many samples the card works on at once in this form of the kernel
// (cudaOccupancyMaxActiveClusters): a larger batch runs in several waves.
int tfhe_blind_rotate_small_in_flight(int N, int l, int cluster, int* in_flight) {
  return (int)launch_small(nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr, 1, 1, N, l, 0, 0u,
                           cluster, nullptr, in_flight);
}

// The bootstrap of a small batch: the blind rotate on acc int32[B][k+1][N]
// (in place), then sample extract and key switch (cmux.cu tfhe_keyswitch,
// paired where pairs > 0) into r int32[B - pairs][C] and ext int32[2][B - pairs].
int tfhe_blind_rotate_small_ks(int32_t* acc, const int32_t* bara, const uint32_t* bk,
                               const uint32_t* bksh, const uint32_t* tab, const int8_t* tks,
                               int32_t* sums, int32_t* r, int32_t* ext, int B, int n, int N,
                               int l, int bgbit, unsigned int offset, int cluster, int C, int t,
                               int basebit, unsigned int prec_offset, int mma, int split,
                               int pairs, unsigned int b_add, cudaStream_t stream) {
  const cudaError_t err = launch_small(acc, kOut * N, N, bara, bk, bksh, tab, B, n, N, l, bgbit,
                                       offset, cluster, stream);
  if (err != cudaSuccess) return (int)err;
  return tfhe_keyswitch(acc, tks, sums, r, ext, B, N, C, t, basebit, prec_offset, mma, split,
                        pairs, b_add, stream);
}

}  // extern "C"
