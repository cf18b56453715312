// K3: the inverse-LPC recurrence of the decoder.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/predict_pallas.py:_kernel
// (called through predict_batch_pallas).  For each row (one subframe)
//
//     y[n] = x[n] + ((sum_{j<T} q_j * y[n-1-j]) >> shift)   for n >= order
//     y[n] = x[n]                                            for n <  order
//
// with an int64 history and accumulator, so it is exact on every input the
// JAX package's int64 scan (ops/predict.py:predict_batch) takes.  The TPU
// kernel split int32 into 2-4 limbs because Mosaic lowers no int64, and
// gated each batch on their range; nothing of that is needed here.  A shift
// outside [0, 63] shifts in sign bits only, as XLA's shift_right_arithmetic.
//
// What bounds it on this card: the dependency chain.  Each row is 4096
// sequential steps at preset -8, and a batch has only R = 512 rows
// (256 frames x 2 channels), so 512 threads, 16 warps, hold the whole
// card.  Every step waits on the previous output (an int64 multiply, an
// add, a shift, an add); the bytes the batch moves (R*N*4 of residuals
// in, R*N*8 of samples out, about 25 MB) would take under 8 us at
// 3.35 TB/s, far less than the chain.
//
// Design: one thread per row, the T taps and the last T samples in
// registers (T is a template bucket: 4, 8, 12, 16 or 32), a sequential
// loop over n.  The wrapper hands the residuals over as an (N, R)
// transpose and takes the output as (N, R), so the 32 threads of a warp
// read and write 32 neighbouring addresses at each step.  Residuals are
// loaded kChunk steps ahead into registers, so a global load's latency is
// not on the chain.  One warp per block spreads the few warps over as
// many SMs as possible.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 16;

template <int T>
__device__ __forceinline__ int64_t step(int64_t (&h)[T], const int32_t (&q)[T],
                                        int64_t x, int n, int ord,
                                        unsigned s) {
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < T; ++j) acc += static_cast<int64_t>(q[j]) * h[j];
  const int64_t y = n >= ord ? x + (acc >> s) : x;
#pragma unroll
  for (int j = T - 1; j > 0; --j) h[j] = h[j - 1];
  h[0] = y;
  return y;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
predict_lpc_kernel(const int32_t* __restrict__ xt,
                   const int32_t* __restrict__ qcoeffs, int q_stride,
                   const int32_t* __restrict__ shift,
                   const int32_t* __restrict__ order,
                   int64_t* __restrict__ out, int R, int N) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  int32_t q[T];
#pragma unroll
  for (int j = 0; j < T; ++j) q[j] = qcoeffs[static_cast<size_t>(r) * q_stride + j];
  const int ord = order[r];
  const int sr = shift[r];
  const unsigned s = (sr < 0 || sr > 63) ? 63u : static_cast<unsigned>(sr);
  int64_t h[T];  // h[j] = y[n-1-j]
#pragma unroll
  for (int j = 0; j < T; ++j) h[j] = 0;

  const size_t stride = static_cast<size_t>(R);
  const int32_t* xr = xt + r;
  int64_t* yr = out + r;
  int32_t cur[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) cur[u] = u < N ? xr[u * stride] : 0;
  int n = 0;
  for (; n + kChunk <= N; n += kChunk) {
    // the next chunk's residuals, in flight while this chunk runs
    int32_t nxt[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int m = n + kChunk + u;
      nxt[u] = m < N ? xr[m * stride] : 0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      yr[(n + u) * stride] = step<T>(h, q, cur[u], n + u, ord, s);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
  // the last N % kChunk steps: their residuals are in cur already
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    if (n + u < N) yr[(n + u) * stride] = step<T>(h, q, cur[u], n + u, ord, s);
}

template <int T>
cudaError_t launch(const void* xt, const void* q, int q_stride,
                   const void* shift, const void* order, void* out, int R,
                   int N, cudaStream_t stream) {
  const int blocks = (R + kThreads - 1) / kThreads;
  predict_lpc_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(xt), static_cast<const int32_t*>(q),
      q_stride, static_cast<const int32_t*>(shift),
      static_cast<const int32_t*>(order), static_cast<int64_t*>(out), R, N);
  return cudaGetLastError();
}

}  // namespace

// xt (N, R) i32 residuals with warm-ups, qcoeffs (R, q_stride) i32 (the
// first `taps` are read), shift and order (R,) i32 -> out (N, R) i64, on
// `stream`.  taps is 4, 8, 12, 16 or 32.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for another tap count.
extern "C" int flac_predict_lpc(const void* xt, const void* qcoeffs,
                                int q_stride, const void* shift,
                                const void* order, void* out, int R, int N,
                                int taps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (taps) {
    case 4: e = launch<4>(xt, qcoeffs, q_stride, shift, order, out, R, N, st); break;
    case 8: e = launch<8>(xt, qcoeffs, q_stride, shift, order, out, R, N, st); break;
    case 12: e = launch<12>(xt, qcoeffs, q_stride, shift, order, out, R, N, st); break;
    case 16: e = launch<16>(xt, qcoeffs, q_stride, shift, order, out, R, N, st); break;
    case 32: e = launch<32>(xt, qcoeffs, q_stride, shift, order, out, R, N, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
