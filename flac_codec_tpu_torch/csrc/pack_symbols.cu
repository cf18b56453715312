// K2: pack Rice/escape symbols and header fields into subframe panels.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/packpanel.py:_merge_kernel
// (called through merge_panels) together with the one-hot XLA stages that
// feed it or stand in for it (chunk_panels, chunkmerge_panels,
// pack_fields_window).  Each symbol (value, width, panel-local end bit) is
// placed MSB-first into its row's u32 panel; bit 0 of the panel is bit 31
// of word 0.  Bit fields of live symbols are disjoint, so OR = add.
//
// What bounds it on the card: bytes.  At preset -8 one launch packs one
// channel slot: 256 rows of M = 4229 symbols (4096 samples, 64 partition
// headers, 69 header fields), reading 13 bytes a symbol (14 MB) and
// writing 256 panels of P = 2688 words (2.75 MB), about 5 us at the
// H100's 3.35 TB/s.
//
// Design: one block per row, its (P,) panel in dynamic shared memory
// (10.5 KB at preset -8).  Threads stride over the row's symbols with
// coalesced loads; each live symbol computes its hi/lo words exactly as
// the JAX package's _symbol_geometry does and atomicOrs them into shared
// memory at w0 and w0 + 1.  The block then stores the panel coalesced.
// Unlike the one-hot form there is no per-chunk span cap: a row overflows
// only when a live symbol would land outside the panel (or is wider than
// 32 bits); that symbol is dropped and the row's flag set.  Shift amounts
// stay in 0..31.
//
// A panel larger than one block's shared memory (227 KB, P > 58112 words:
// 32-bit samples at blocks past ~54k) takes the same body with the panel
// in global memory: the entry point zeroes the output and the threads
// atomicOr straight into it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// largest dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kMaxSharedBytes = 232448;

// kShared: the panel lives in shared memory; else it is the zeroed output
template <bool kShared>
__global__ void pack_symbols_kernel(const uint32_t* __restrict__ values,
                                    const int32_t* __restrict__ widths,
                                    const int32_t* __restrict__ ends,
                                    const uint8_t* __restrict__ mask,
                                    uint32_t* __restrict__ out,
                                    int32_t* __restrict__ overflow, int M,
                                    int P) {
  extern __shared__ uint32_t smem[];
  __shared__ int row_ovf;
  const int r = blockIdx.x;
  uint32_t* o = out + static_cast<size_t>(r) * P;
  uint32_t* panel = kShared ? smem : o;
  if (kShared)
    for (int i = threadIdx.x; i < P; i += blockDim.x) panel[i] = 0u;
  if (threadIdx.x == 0) row_ovf = 0;
  __syncthreads();

  const size_t base = static_cast<size_t>(r) * M;
  const long long limit = static_cast<long long>(P) * 32;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int w = widths[base + m];
    if (!mask[base + m] || w <= 0) continue;
    const long long end = ends[base + m];
    const long long start = end - w;
    if (start < 0 || end > limit || w > 32) {
      atomicOr(&row_ovf, 1);
      continue;
    }
    const uint32_t v = values[base + m];
    const int w0 = static_cast<int>(start >> 5);
    const unsigned e = static_cast<unsigned>(start & 31) + w;  // 1..63
    uint32_t hi, lo;
    if (e <= 32u) {
      hi = v << (32u - e);         // shift 0..31
      lo = 0u;
    } else {
      hi = v >> (e - 32u);         // shift 1..31
      lo = v << (64u - e);         // shift 1..31
    }
    if (hi) atomicOr(&panel[w0], hi);
    if (lo) atomicOr(&panel[w0 + 1], lo);  // e > 32: end > (w0+1)*32
  }
  __syncthreads();

  if (kShared)
    for (int i = threadIdx.x; i < P; i += blockDim.x) o[i] = panel[i];
  if (threadIdx.x == 0) overflow[r] = row_ovf;
}

}  // namespace

// values (rows, M) u32, widths/ends (rows, M) i32, mask (rows, M) bool ->
// out (rows, P) u32, overflow (rows,) i32, on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int flac_pack_symbols(const void* values, const void* widths,
                                 const void* ends, const void* mask,
                                 void* out, void* overflow, int rows, int M,
                                 int P, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const uint32_t*>(values);
  const auto* w = static_cast<const int32_t*>(widths);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<uint32_t*>(out);
  auto* ovf = static_cast<int32_t*>(overflow);
  const size_t smem = static_cast<size_t>(P) * sizeof(uint32_t);
  if (smem > kMaxSharedBytes) {
    cudaError_t err = cudaMemsetAsync(o, 0, smem * rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    pack_symbols_kernel<false><<<rows, kThreads, 0, st>>>(v, w, e, m, o, ovf,
                                                          M, P);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pack_symbols_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pack_symbols_kernel<true><<<rows, kThreads, smem, st>>>(v, w, e, m, o, ovf,
                                                         M, P);
  return static_cast<int>(cudaGetLastError());
}
