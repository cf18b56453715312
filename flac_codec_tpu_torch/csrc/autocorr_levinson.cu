// Autocorrelation + Levinson-Durbin in the host encoder's exact rounding.
//
// Replaces, for float64 analysis, the XLA stages
// flac_codec_tpu/ops/lpc.py:autocorrelate and :levinson (the TPU path has no
// Pallas kernel here).  The float64 mode promises streams byte-identical to
// the host encoder (flac_codec_tpu/models/lpc.py), whose autocorrelation and
// Levinson inner products are numpy's np.dot — OpenBLAS's ddot.  LPC
// analysis of tonal audio is ill-conditioned: a
// one-ulp change in one lag moves the order-12 coefficients by ~1e-4 of a
// quantization step and flips rounded coefficients, so summing in any
// other order (a tree reduction, a sequential loop) changes bytes.  This
// kernel reproduces the host's operations one rounding at a time:
//
// * each lag j is ddot(w[0:n], w[j:j+n]), n = N - j, in the order of
//   OpenBLAS's SkylakeX kernel (kernel/x86_64/ddot.c with
//   ddot_microk_skylakex-2.c): over the first n & ~31 elements, 32 FMA
//   chains (4 accumulators x 8 lanes), chain l on the elements i = l
//   (mod 32) in order of i; each accumulator's upper 4 lanes added onto
//   its lower 4; at most one block of 16 more elements on those 16 chains;
//   the 4 accumulators summed in order, lanes (0+2) + (1+3); then the last
//   n % 16 elements FMAed one by one.  (Valid while n <= 10000: above that
//   OpenBLAS splits the dot over threads.)  numpy multiplies 1-element
//   operands as scalars, which differs from the FMA tail only in the sign
//   of a zero.
// * Levinson-Durbin as models/lpc.py:lp_coefficients.  Its inner product
//   np.dot(autoc[i:0:-1], coeffs) has a reversed operand, which numpy
//   copies to contiguous memory before calling the same ddot: for i < 32
//   that is at most one 16-element block, then the tail.
//
// Every operation is an explicit round-to-nearest intrinsic (__fma_rn,
// __dadd_rn, __dmul_rn, ...), so nvcc cannot contract or reorder them.
// Which thread runs a chain is free; the order inside a chain is not.
//
// What bounds it on the card: bytes.  At preset -8 (1088 rows of N = 4096
// doubles, M = 12) it must read the 35.7 MB windowed panel (11 us at
// 3.35 TB/s) and do 58 M FMAs.  Shared memory is the second bound: a
// thread takes 2 neighbouring chains of 13 lags, so a chain step reads 14
// doubles (112 bytes) for 26 FMAs, ~180 MB in all with the tiles written
// (~5 us at 128 bytes a clock an SM).  What holds it is each warp's serial
// path: 128 chain steps, then the row's fold, combine and recursion.
//
// Design: a block is one warp, for 2 rows at M <= 12 (1 above).  Each
// thread owns FMA chains 2q, 2q+1 of a group of lags (all 13 at M <= 12;
// 2 x 14 or, at M >= 28, 4 groups of 10 with 4 chains a thread) of one
// row, its accumulators in registers, fed at step t from x[32t + 2q ..] in
// shared memory by double2 loads; with one group of lags the next step's
// operands are loaded while a step's FMAs issue.
// * Each row is read from device memory once, through a ring of 3 tiles
//   in shared memory: a tile is 32 * tile_steps doubles of chain steps
//   plus the 32 that the lags reach past them, one TMA bulk copy a row
//   completing on the stage's mbarrier (8-byte cp.async copies where rows
//   are not 16-byte aligned), so a row of any length up to 65535 streams
//   through with the next two tiles in flight while the warp works on one
//   (no block barrier: one warp, __syncwarp).  Lags that take one chain
//   step more than the longest lag (j <= N % 32) do it predicated, after
//   the others.
// * The fixed fold and combine of each lag (and its 16-element block and
//   tail, which lie in the last tile, still in the ring) runs on one lane
//   per (row, lag), from the chain sums left in shared memory.
// * Levinson: one lane per row runs the serial inner products; the
//   row's other lanes update the coefficients (nc[j] independent per j)
//   and zero-pad the order's row, all in shared memory, and the warp
//   stores the block's autocorrelation, coefficient and error rows, which
//   lie contiguous in the outputs, with coalesced stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStages = 3;
constexpr int kHalo = 48;          // doubles of a tile past its chain steps
constexpr int kDefaultTileSteps = 16;
constexpr int kChains = 2;         // chains a thread at M <= 12
constexpr int kAcStride = 34;      // doubles a row of the lag buffer
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// make the initialised barriers visible to the bulk-copy unit
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// order this thread's shared-memory reads before later bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: bytes (a multiple of 16) from src to dst (both 16-byte aligned),
// completing on bar
__device__ __forceinline__ void bulk_copy(double* dst, const double* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for phase `parity` of bar; traps rather than hang if it never
// completes
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  for (int tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1 << 22)) __trap();
  }
}

__device__ __forceinline__ void copy8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

// A thread's operands of one chain step: chains kC q + c (x = x[c]) of
// the lags j0 + jj (y = x[j0 + c + jj]), from x = element 32t + kC q of the
// row's tile.  kOneGroup: j0 == 0, so the y loads hold x.
template <int G, int kC, bool kOneGroup>
struct Step {
  static constexpr int kY = (G + kC) & ~1;  // G + kC - 1 y values, in pairs
  double y[kY];
  double x[kC];

  __device__ __forceinline__ void load(const double* __restrict__ p,
                                       int j0) {
    const double2* yp = reinterpret_cast<const double2*>(p + j0);
#pragma unroll
    for (int i = 0; i < kY / 2; ++i) {
      const double2 v = yp[i];
      y[2 * i] = v.x;
      y[2 * i + 1] = v.y;
    }
    if (kOneGroup) {
#pragma unroll
      for (int c = 0; c < kC; ++c) x[c] = y[c];
    } else {
      const double2* xp = reinterpret_cast<const double2*>(p);
#pragma unroll
      for (int i = 0; i < kC / 2; ++i) {
        const double2 v = xp[i];
        x[2 * i] = v.x;
        x[2 * i + 1] = v.y;
      }
    }
  }

  // kLast: the step only the lags j <= jlast take
  template <bool kLast>
  __device__ __forceinline__ void fma(double (&acc)[kC][G], int j0,
                                      int jlast) const {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (!kLast || j0 + jj <= jlast)
          acc[c][jj] = __fma_rn(x[c], y[c + jj], acc[c][jj]);
      }
    }
  }
};

// n chain steps from x (element 32t + kC q of the tile).  With one group
// of lags the operands of step t + 1 are loaded while step t's FMAs issue
// (with more groups that measured slower: the operands of two steps do
// not fit beside the accumulators as well).
template <int G, int kC, bool kOneGroup>
__device__ __forceinline__ void chain_steps(const double* __restrict__ x,
                                            int n, int j0,
                                            double (&acc)[kC][G]) {
  if (n <= 0) return;
  Step<G, kC, kOneGroup> a, b;
  if (!kOneGroup) {
    for (int t = 0; t < n; ++t) {
      a.load(x + 32 * t, j0);
      a.template fma<false>(acc, j0, 0);
    }
    return;
  }
  a.load(x, j0);
  int t = 0;
  for (; t + 2 <= n; t += 2) {
    b.load(x + 32 * (t + 1), j0);
    a.template fma<false>(acc, j0, 0);
    if (t + 2 < n) a.load(x + 32 * (t + 2), j0);
    b.template fma<false>(acc, j0, 0);
  }
  if (t < n) a.template fma<false>(acc, j0, 0);
}

// The rest of ddot_skylakex for lag j, n = N - j: ch holds the 32 chain
// sums over the first n & ~31 elements, xt the row's last tile (element e
// at xt[e - base]; the elements from n & ~31 on lie in it).
__device__ double ddot_finish(const double* __restrict__ ch,
                              const double* __restrict__ xt, int base, int n,
                              int j) {
  // numpy treats a 1-element operand as a scalar: a plain product
  if (n == 1) return __dmul_rn(xt[-base], xt[j - base]);
  const int n1 = n & -16;
  const int n32 = n1 & ~31;
  // f[4k + l]: accumulator k, vector lane l < 4, after the 512 -> 256-bit
  // fold of lanes 4-7 onto 0-3 (chain 8k + l)
  double f[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int l = 0; l < 4; ++l)
      f[4 * k + l] = __dadd_rn(ch[8 * k + l], ch[8 * k + l + 4]);
  }
  // 16-element block on 4 accumulators x 4 lanes
  if (n1 > n32) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int i = n32 + 4 * k + l;
        f[4 * k + l] =
            __fma_rn(xt[i - base], xt[i + j - base], f[4 * k + l]);
      }
    }
  }
  // ((acc0 + acc1) + acc2) + acc3, lane-wise; then (l0 + l2) + (l1 + l3)
  double a[4];
#pragma unroll
  for (int l = 0; l < 4; ++l)
    a[l] = __dadd_rn(__dadd_rn(__dadd_rn(f[l], f[4 + l]), f[8 + l]),
                     f[12 + l]);
  double dot = __dadd_rn(__dadd_rn(a[0], a[2]), __dadd_rn(a[1], a[3]));
  for (int i = n1; i < n; ++i)
    dot = __fma_rn(xt[i + j - base], xt[i - base], dot);
  return dot;
}

// ddot_skylakex for one thread and n < 32, on x[t] = ac[n - t], y = c:
// np.dot(autoc[i:0:-1], coeffs) with n = i
__device__ double levinson_dot(const double* ac, const double* c, int n) {
  if (n == 1) return __dmul_rn(ac[1], c[0]);  // numpy's scalar case
  const int n1 = n & -16;
  double dot = 0.0;
  if (n1) {
    double a0[4];
    for (int l = 0; l < 4; ++l) {
      double acc[4];
      for (int k = 0; k < 4; ++k)
        acc[k] = __fma_rn(ac[n - (4 * k + l)], c[4 * k + l], 0.0);
      a0[l] = __dadd_rn(__dadd_rn(__dadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
    }
    dot = __dadd_rn(__dadd_rn(a0[0], a0[2]), __dadd_rn(a0[1], a0[3]));
  }
  for (int t = n1; t < n; ++t) dot = __fma_rn(c[t], ac[n - t], dot);
  return dot;
}

// kGroups groups of G lags a row, kC chains a thread (32 / kC threads a
// group), 32 / (32 / kC * kGroups) rows a warp; a block is one warp.
template <int G, int kGroups, int kC>
__global__ void __launch_bounds__(32)
    autocorr_levinson_kernel(const double* __restrict__ windowed,
                             double* __restrict__ autoc_out,
                             double* __restrict__ coeffs_out,
                             double* __restrict__ errs_out, int rows, int N,
                             int M, int tile_steps, bool bulk) {
  constexpr int kQ = 32 / kC;            // threads a group of lags
  constexpr int kTpr = kQ * kGroups;     // threads a row
  constexpr int kRows = 32 / kTpr;       // rows a block
  constexpr int kLags = G * kGroups;     // lag slots a row (>= M + 1)
  extern __shared__ __align__(16) double smem[];
  const int stride = 32 * tile_steps + kHalo;
  double* ring = smem;                                // [stage][row][stride]
  double* sums = ring + kStages * kRows * stride;     // [row][lag][chain]
  double* ac = sums + kRows * kLags * 32;             // [row][kAcStride]
  double* es = ac + kRows * kAcStride;                // [row][32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(es + kRows * 32);  // [stage]
  double* cs = sums;        // [row][order][32], once the sums are combined

  const int lane = threadIdx.x;
  const int rl = lane / kTpr, u = lane % kTpr;
  const int q = u % kQ, j0 = (u / kQ) * G;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, rows - row0);
  const int T0 = N >> 5;             // chain steps of lag 0
  const int TM = (N - M) >> 5;       // ... of lag M, the fewest
  const int tiles = max(1, (T0 + tile_steps - 1) / tile_steps);
  const double* src = windowed + static_cast<size_t>(row0) * N;

  // tile k: elements [32 tile_steps k, min(N, that + 32 tile_steps + 32))
  // of each of the block's rows, into stage k % kStages: one bulk copy a
  // row where rows are 16-byte aligned (bulk), else 8-byte cp.async copies
  auto fetch = [&](int k) {
    const int e0 = 32 * tile_steps * k;
    const int cnt = min(N - e0, 32 * tile_steps + 32);
    const int st = k % kStages;
    double* dst = ring + st * kRows * stride;
    if (bulk) {
      if (lane == 0) {
        fence_async();
        bar_expect(bars + st, nrows * cnt * 8);
        for (int r = 0; r < nrows; ++r)
          bulk_copy(dst + r * stride, src + static_cast<size_t>(r) * N + e0,
                    cnt * 8, bars + st);
      }
      return;
    }
    for (int r = 0; r < nrows; ++r) {
      const double* from = src + static_cast<size_t>(r) * N + e0;
      double* to = dst + r * stride;
      for (int p = lane; p < cnt; p += 32) copy8(to + p, from + p);
    }
    commit_copies();
  };

  if (bulk) {
    if (lane == 0) {
      for (int st = 0; st < kStages; ++st) bar_init(bars + st);
      fence_bar_init();
    }
    __syncwarp();
  }
  double acc[kC][G];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int jj = 0; jj < G; ++jj) acc[c][jj] = 0.0;
  }
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) {
      fetch(k);
    } else if (!bulk) {
      commit_copies();
    }
  }
  const int jlast = N & 31;
  for (int k = 0; k < tiles; ++k) {
    if (k + kStages - 1 < tiles) {
      fetch(k + kStages - 1);
    } else if (!bulk) {
      commit_copies();
    }
    if (bulk) {
      bar_wait(bars + k % kStages, (k / kStages) & 1);
    } else {
      wait_copies();
      __syncwarp();
    }
    const double* x =
        ring + ((k % kStages) * kRows + rl) * stride + kC * q;
    const int t_all = max(0, min(tile_steps, TM - k * tile_steps));
    const int t_end = min(tile_steps, T0 - k * tile_steps);
    chain_steps<G, kC, kGroups == 1>(x, t_all, j0, acc);
    if (t_all < t_end) {  // the lags j <= N % 32 take one step more
      Step<G, kC, kGroups == 1> last;
      last.load(x + 32 * t_all, j0);
      last.template fma<true>(acc, j0, jlast);
    }
    __syncwarp();   // the stage is refilled next iteration
  }

  // chain sums -> shared memory; one lane per (row, lag) finishes the dot
#pragma unroll
  for (int c = 0; c < kC; ++c) {
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      if (j0 + jj <= M)
        sums[(rl * kLags + j0 + jj) * 32 + kC * q + c] = acc[c][jj];
    }
  }
  __syncwarp();
  const int base = 32 * tile_steps * (tiles - 1);   // the last tile's start
  const double* last = ring + ((tiles - 1) % kStages) * kRows * stride;
  for (int i = lane; i < nrows * (M + 1); i += 32) {
    const int r = i / (M + 1), j = i - r * (M + 1);
    ac[r * kAcStride + j] = ddot_finish(sums + (r * kLags + j) * 32,
                                        last + r * stride, base, N - j, j);
  }
  __syncwarp();

  // Levinson-Durbin: lane u == 0 of a row runs the inner products, the
  // row's lanes write each order's coefficient row
  const double* acr = ac + rl * kAcStride;
  double* csr = cs + rl * M * 32;
  const int leader = rl * kTpr;
  double k = 0.0, err = 0.0;
  if (u == 0) {
    k = __ddiv_rn(acr[1], acr[0]);
    err = __dmul_rn(acr[0], __dsub_rn(1.0, __dmul_rn(k, k)));
    es[rl * 32] = err;
  }
  k = __shfl_sync(kFull, k, leader);
  for (int j = u; j < 32; j += kTpr) csr[j] = j == 0 ? k : 0.0;
  __syncwarp();
  for (int i = 1; i < M; ++i) {
    const double* c = csr + (i - 1) * 32;
    if (u == 0) {
      const double qv = __dsub_rn(acr[i + 1], levinson_dot(acr, c, i));
      k = __ddiv_rn(qv, err);
      err = __dmul_rn(err, __dsub_rn(1.0, __dmul_rn(k, k)));
      es[rl * 32 + i] = err;
    }
    k = __shfl_sync(kFull, k, leader);
    double* nc = csr + i * 32;
    for (int j = u; j < 32; j += kTpr)
      nc[j] = j < i ? __dsub_rn(c[j], __dmul_rn(k, c[i - 1 - j]))
                    : (j == i ? k : 0.0);
    __syncwarp();
  }

  // the block's rows lie contiguous in each output
  const size_t r0 = row0;
  for (int i = lane; i < nrows * (M + 1); i += 32) {
    const int r = i / (M + 1);
    autoc_out[r0 * (M + 1) + i] = ac[r * kAcStride + i - r * (M + 1)];
  }
  for (int i = lane; i < nrows * M * 32; i += 32)
    coeffs_out[r0 * M * 32 + i] = cs[i];
  for (int i = lane; i < nrows * M; i += 32) {
    const int r = i / M;
    errs_out[r0 * M + i] = es[r * 32 + i - r * M];
  }
}

template <int G, int kGroups, int kC>
int launch(const double* windowed, double* autoc, double* coeffs,
           double* errs, int rows, int N, int M, int tile_steps,
           cudaStream_t stream) {
  constexpr int kRows = 32 / (32 / kC * kGroups);
  const size_t doubles =
      static_cast<size_t>(kStages) * kRows * (32 * tile_steps + kHalo) +
      kRows * G * kGroups * 32 + kRows * kAcStride + kRows * 32 + kStages;
  const size_t smem = doubles * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        autocorr_levinson_kernel<G, kGroups, kC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool bulk =
      (reinterpret_cast<uintptr_t>(windowed) & 15) == 0 && (N & 1) == 0;
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  autocorr_levinson_kernel<G, kGroups, kC><<<blocks, 32, smem, stream>>>(
      windowed, autoc, coeffs, errs, rows, N, M, tile_steps, bulk);
  return static_cast<int>(cudaGetLastError());
}

int autocorr_levinson(const void* windowed, void* autoc, void* coeffs,
                      void* errs, int rows, int N, int M, int tile_steps,
                      void* stream) {
  const auto* w = static_cast<const double*>(windowed);
  auto* a = static_cast<double*>(autoc);
  auto* c = static_cast<double*>(coeffs);
  auto* e = static_cast<double*>(errs);
  const auto st = static_cast<cudaStream_t>(stream);
  if (M + 1 <= 13)
    return launch<13, 1, kChains>(w, a, c, e, rows, N, M, tile_steps, st);
  if (M + 1 <= 28)
    return launch<14, 2, 4>(w, a, c, e, rows, N, M, tile_steps, st);
  return launch<10, 4, 4>(w, a, c, e, rows, N, M, tile_steps, st);
}

}  // namespace

// windowed (rows, N) f64 -> autoc (rows, M+1), all_coeffs (rows, M, 32),
// all_errs (rows, M), on `stream`.  1 <= M <= 32, M < N.
// Returns cudaGetLastError() after the launch.
extern "C" int flac_autocorr_levinson(const void* windowed, void* autoc,
                                      void* coeffs, void* errs, int rows,
                                      int N, int M, void* stream) {
  return autocorr_levinson(windowed, autoc, coeffs, errs, rows, N, M,
                           kDefaultTileSteps, stream);
}

// The same with tile_steps >= 1 chain steps (32 * tile_steps samples) a
// tile of the ring; the results do not depend on it (tests hold one tile
// size against another).
extern "C" int flac_autocorr_levinson_tiles(const void* windowed, void* autoc,
                                            void* coeffs, void* errs,
                                            int rows, int N, int M,
                                            int tile_steps, void* stream) {
  return autocorr_levinson(windowed, autoc, coeffs, errs, rows, N, M,
                           tile_steps, stream);
}
