// K3: the inverse-LPC recurrence of the decoder.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/predict_pallas.py:_kernel
// (called through predict_batch_pallas).  For each row (one subframe)
//
//     y[n] = x[n] + ((sum_{j<T} q_j * y[n-1-j]) >> shift)   for n >= order
//     y[n] = x[n]                                            for n <  order
//
// exactly as the JAX package's int64 scan (ops/predict.py:predict_batch)
// computes it, on every input: sums wrap modulo 2^64, and a shift outside
// [0, 63] shifts in sign bits only, as XLA's shift_right_arithmetic.  The
// TPU kernel split int32 into 2-4 limbs because Mosaic lowers no int64,
// and gated each batch on their range; nothing of that is needed here.
//
// What bounds it on this card: one row's chain of steps.  Each row is
// 4096 sequential steps at preset -8, and a batch has only R = 512 rows
// (256 frames x 2 channels), so 512 threads, 16 warps, hold the whole
// card, each warp alone on its SM.  The bytes the batch moves (R*N*4 of
// residuals in, R*N*8 of samples out, about 25 MB) would take under 8 us
// at 3.35 TB/s; the batch takes 4096 times one step of one warp, and a
// warp alone on its scheduler hides no latency and issues one
// instruction at a time.  Measured on an H100 (tools/chain_latency.py),
// a step's dependent chain (multiply-add, shift, add) takes ~24 cycles,
// and a wide integer multiply-add (IMAD.WIDE) ~8 cycles of issue, so T
// of them a step would set the step.  The design:
//
// * 32-bit samples.  A valid stream's samples fit int32, so a sample is
//   an int32, and taps 0 and 1 are 32x32+64 multiply-adds.
// * Taps 2..T-1 in the FP64 pipe, one fused multiply-add each (~2 cycles
//   of issue).  They are exact: the row's sum of |q| is below 2^19 and
//   its samples fit int32, so every partial sum stays below 2^50.  The
//   FP64 sum reaches the integer chain through the 2^52 + 2^51 trick (its
//   bits are kMagicBits plus the integer), so no conversion instruction
//   is on the way.
// * The older taps off the chain (transposed direct form).  Each new
//   sample is at once multiplied into the partial sums of the later
//   steps, which are independent of each other, and tap 1's product with
//   the FP64 sum is formed two steps ahead; one step's chain is tap 0's
//   multiply-add, the 64-bit shift and a 32-bit add.  The partial sums
//   rotate through T registers; a chunk of U steps (a multiple of T) is
//   unrolled, so every register index is a constant.
// * Exact on every input.  Beside the chain, each step checks in 64 bits
//   that its sample fits int32 and ORs a flag.  A row whose flag is set
//   after a chunk redoes that chunk, and the rest of the row, in an int64
//   loop from the samples it has stored; so does a whole row whose |q|
//   sum reaches 2^19 or whose shift is past 51.  A valid stream never
//   pays for it, and every input gets the int64 scan's result.
// * Warm-up chunks apart.  The chunks that hold positions below the
//   order, and a last partial chunk, run a version of the step with the
//   select and the row's end; the others have neither.
// * Rows in place.  Each thread reads its row of the (R, N) residuals and
//   writes its row of the (R, N) samples directly, 16 bytes at a time
//   where N and the pointers allow, so the wrapper transposes nothing.
//   The residuals arrive through a ring in shared memory several chunks
//   ahead (fetch_chunk).  Staging the samples through shared memory for
//   coalesced stores, by the warp or by bulk copies, measured slower:
//   each stage adds its latency to the chunk, and one warp hides none.
//
// One warp per block spreads the few warps over as many SMs as possible.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

// steps a chunk unrolls: a multiple of T and of 4 (the fastest of 8-48
// measured for each T)
template <int T>
struct Chunk {
  static constexpr int U = T == 12 ? 12 : (T < 16 ? 16 : T);
};

// c + a * b with a 32x32 -> 64 signed product: one IMAD.WIDE.  (Written
// in C++ as a product of two sign-extended operands, it compiled to a
// 64x64 multiply, IMAD.WIDE.U32 and two IMADs for the high words.)
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b,
                                             uint64_t c) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// The residuals reach a row through a ring of kStages chunks in shared
// memory, filled by cp.async kStages - 1 chunks ahead of the one that
// runs: a chunk of 12-32 steps is shorter than a load from device memory,
// so a ring one chunk deep left every chunk waiting on its load.  Each
// thread copies and reads only its own row's slots, so no barrier is
// needed; a copy past the row's end fills zeros.
constexpr int kStages = 8;

__device__ __forceinline__ void copy_async(int32_t* dst,
                                           const int32_t* src, int bytes,
                                           bool inside) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = inside ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending));
}

// Start copying the U residuals from n (a chunk's first step) into `slot`.
template <int U, bool kVec>
__device__ __forceinline__ void fetch_chunk(int32_t* slot,
                                            const int32_t* __restrict__ xr,
                                            int n, int N) {
#pragma unroll
  for (int u = 0; u < U; u += kVec ? 4 : 1) {
    // N % 4 == 0 on the vector path: a vector that starts inside the
    // row ends inside it
    const bool inside = n + u < N;
    copy_async(slot + u, inside ? xr + n + u : xr, kVec ? 16 : 4, inside);
  }
  commit_copies();
}

// 2^52 + 2^51: an integer of magnitude below 2^51 added to it lands, exact,
// in the low bits of the sum's mantissa, whose bit pattern is then
// kMagicBits plus the integer
constexpr double kMagic = 6755399441055744.0;
constexpr uint64_t kMagicBits = 0x4338000000000000ull;
// 2^52 + 2^31: the double with high word 0x43300000 and low word
// v ^ 0x80000000 is kBias + v for any int32 v
constexpr double kBias = 4503601774854144.0;

__device__ __forceinline__ double to_double(int32_t v) {
  return __hiloint2double(0x43300000, v ^ static_cast<int32_t>(0x80000000u)) -
         kBias;
}

// U steps from n0 (a multiple of T) on the 32-bit path.  Taps 0 and 1 are
// integer multiply-adds; taps 2..T-1 are FP64 fused multiply-adds, exact
// because the row's |q| sum is below 2^19, so every partial sum stays
// below 2^50.  D[m % T] holds the FP64 taps' sum of step m; Pq[m % 2]
// holds tap 1's product plus that sum (as kMagicBits plus the integer)
// for step m, two steps ahead.  Stores the samples and ORs into `bad` a
// nonzero word for a step whose true sample leaves int32.  kEdge: the
// chunk may hold warm-up positions (below `ord`, which take x[n] as it
// is) or positions past N (neither checked nor stored).
template <int T, int U, bool kEdge, bool kVec>
__device__ __forceinline__ void run_chunk(double (&D)[T], const double (&qd)[T],
                                          int32_t q0, int32_t q1,
                                          const int32_t (&x)[U], unsigned s,
                                          uint64_t neg_cm, int32_t& vprev,
                                          uint64_t (&Pq)[2], int n0, int ord,
                                          int N, int64_t* __restrict__ yr,
                                          uint32_t& bad) {
  int32_t prev = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = u % T;
    // the chain: q0 * y[n-1] onto the rest of the sum, a shift, an add;
    // the sum carries kMagicBits, a multiple of 2^s, whose shifted value
    // neg_cm takes back out
    const int64_t tA =
        static_cast<int64_t>(mad_wide(q0, vprev, Pq[u & 1])) >> s;
    int32_t v = static_cast<int32_t>(static_cast<uint32_t>(x[u]) +
                                     static_cast<uint32_t>(neg_cm) +
                                     static_cast<uint32_t>(tA));
    // off the chain: the 64-bit sample's high word against the sign of
    // its low word
    const uint64_t v64 = static_cast<uint64_t>(static_cast<int64_t>(x[u])) +
                         neg_cm + static_cast<uint64_t>(tA);
    uint32_t off = static_cast<uint32_t>(v64 >> 32) ^
                   static_cast<uint32_t>(v >> 31);
    if (kEdge) {
      const bool predicted = n0 + u >= ord;
      v = predicted ? v : x[u];
      off = predicted && n0 + u < N ? off : 0u;
    }
    bad |= off;
    vprev = v;
    // this sample's FP64 taps into the sums of steps n+3..n+T; the slot
    // of this step becomes step n+T's
    const double vd = to_double(v);
#pragma unroll
    for (int j = 2; j < T - 1; ++j)
      D[(u + 1 + j) % T] = fma(qd[j], vd, D[(u + 1 + j) % T]);
    D[i] = qd[T - 1] * vd;
    // step n+2's sum but for tap 0: tap 1 of this sample, and the FP64
    // taps' sum, complete since step n-1
    Pq[u & 1] = mad_wide(q1, v, static_cast<uint64_t>(__double_as_longlong(
                                    D[(u + 2) % T] + kMagic)));
    if (kVec) {
      // N % 4 == 0: a pair that starts inside the row ends inside it
      if (u & 1) {
        if (!kEdge || n0 + u < N)
          *reinterpret_cast<longlong2*>(yr + n0 + u - 1) =
              make_longlong2(prev, v);
      } else {
        prev = v;
      }
    } else if (!kEdge || n0 + u < N) {
      yr[n0 + u] = v;
    }
  }
}

// The int64 loop: the row from position n on, with the history read back
// from the samples stored before n (all exact).  Returns nothing; writes
// yr[n..N).
template <int T>
__device__ __noinline__ void finish_int64(const int32_t* __restrict__ xr,
                                          const int32_t* __restrict__ qr,
                                          unsigned s, int ord, int n, int N,
                                          int64_t* __restrict__ yr) {
  int64_t q[T], h[T];  // h[j] = y[n-1-j]
#pragma unroll
  for (int j = 0; j < T; ++j) {
    q[j] = qr[j];
    h[j] = n - 1 - j >= 0 ? yr[n - 1 - j] : 0;
  }
  for (; n < N; ++n) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j)
      acc += static_cast<uint64_t>(q[j]) * static_cast<uint64_t>(h[j]);
    const int64_t x = xr[n];
    const int64_t v =
        n >= ord ? static_cast<int64_t>(static_cast<uint64_t>(x) +
                                        static_cast<uint64_t>(
                                            static_cast<int64_t>(acc) >> s))
                 : x;
#pragma unroll
    for (int j = T - 1; j > 0; --j) h[j] = h[j - 1];
    h[0] = v;
    yr[n] = v;
  }
}

template <int T, bool kVec>
__global__ void __launch_bounds__(kThreads)
predict_lpc_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ qcoeffs, int q_stride,
                   const int32_t* __restrict__ shift,
                   const int32_t* __restrict__ order,
                   int64_t* __restrict__ out, int R, int N,
                   int* __restrict__ slow_rows) {
  constexpr int U = Chunk<T>::U;
  static_assert(U % T == 0 && U % 4 == 0, "chunk must hold whole tap cycles");
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int32_t* qr = qcoeffs + static_cast<size_t>(r) * q_stride;
  int32_t q[T];
#pragma unroll
  for (int j = 0; j < T; ++j) q[j] = qr[j];
  const int ord = order[r];
  const int sr = shift[r];
  const unsigned s = (sr < 0 || sr > 63) ? 63u : static_cast<unsigned>(sr);
  const int32_t* xr = x + static_cast<size_t>(r) * N;
  int64_t* yr = out + static_cast<size_t>(r) * N;

  // this thread's kStages slots; a pitch of U + 4 words keeps 16-byte
  // reads of 8 neighbouring rows on distinct banks
  constexpr int kPitch = U + 4;
  __shared__ __align__(16) int32_t ring[kStages][kThreads][kPitch];
  const int lane = threadIdx.x;

  double qd[T], D[T];  // D[m % T]: the FP64 taps' sum of step m
  int64_t qsum = 0;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    qd[j] = q[j];
    D[j] = 0.0;
    qsum += q[j] < 0 ? -static_cast<int64_t>(q[j]) : q[j];
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c)
    fetch_chunk<U, kVec>(ring[c][lane], xr, c * U, N);
  // rows whose sums could reach 2^50, or whose shift is past 51, take
  // the int64 loop from the start
  uint32_t bad = qsum >= (1 << 19) || s > 51;
  const uint64_t neg_cm = 0 - (kMagicBits >> s);
  uint64_t Pq[2] = {kMagicBits, kMagicBits};
  int32_t vprev = 0;
  int n0 = 0;
  for (int c = 0; !bad && n0 < N; ++c, n0 += U) {
    fetch_chunk<U, kVec>(ring[(c + kStages - 1) % kStages][lane], xr,
                         n0 + (kStages - 1) * U, N);
    wait_copies<kStages - 1>();
    int32_t cur[U];
    const int32_t* slot = ring[c % kStages][lane];
#pragma unroll
    for (int u = 0; u < U; u += 4) {
      const int4 w = *reinterpret_cast<const int4*>(slot + u);
      cur[u] = w.x;
      cur[u + 1] = w.y;
      cur[u + 2] = w.z;
      cur[u + 3] = w.w;
    }
    // warm-up positions, or the row's end, inside this chunk
    if (n0 < ord || n0 + U > N)
      run_chunk<T, U, true, kVec>(D, qd, q[0], q[1], cur, s, neg_cm, vprev, Pq,
                                  n0, ord, N, yr, bad);
    else
      run_chunk<T, U, false, kVec>(D, qd, q[0], q[1], cur, s, neg_cm, vprev,
                                   Pq, n0, ord, N, yr, bad);
    if (bad) break;
  }
  wait_copies<0>();
  if (bad) {
    finish_int64<T>(xr, qr, s, ord, n0, N, yr);
    if (slow_rows) atomicAdd(slow_rows, 1);
  }
}

template <int T>
cudaError_t launch(const void* x, const void* q, int q_stride,
                   const void* shift, const void* order, void* out, int R,
                   int N, void* slow_rows, cudaStream_t stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? predict_lpc_kernel<T, true> : predict_lpc_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(q),
      q_stride, static_cast<const int32_t*>(shift),
      static_cast<const int32_t*>(order), static_cast<int64_t*>(out), R, N,
      static_cast<int*>(slow_rows));
  return cudaGetLastError();
}

}  // namespace

// x (R, N) i32 residuals with warm-ups, qcoeffs (R, q_stride) i32 (the
// first `taps` are read), shift and order (R,) i32 -> out (R, N) i64, on
// `stream`.  taps is 4, 8, 12, 16 or 32.  slow_rows, if not null, is one
// device int to which each row that took the int64 path adds 1.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another tap count.
extern "C" int flac_predict_lpc(const void* x, const void* qcoeffs,
                                int q_stride, const void* shift,
                                const void* order, void* out, int R, int N,
                                int taps, void* slow_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (taps) {
    case 4: e = launch<4>(x, qcoeffs, q_stride, shift, order, out, R, N, slow_rows, st); break;
    case 8: e = launch<8>(x, qcoeffs, q_stride, shift, order, out, R, N, slow_rows, st); break;
    case 12: e = launch<12>(x, qcoeffs, q_stride, shift, order, out, R, N, slow_rows, st); break;
    case 16: e = launch<16>(x, qcoeffs, q_stride, shift, order, out, R, N, slow_rows, st); break;
    case 32: e = launch<32>(x, qcoeffs, q_stride, shift, order, out, R, N, slow_rows, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
