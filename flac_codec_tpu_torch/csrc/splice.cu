// K1: splice subframe panels into frame slots.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/packpanel.py:_splice_kernel
// (called through splice_subframes).  A frame body is the bit-concatenation
// of its S subframe panels: panel s is funnel-shifted right by
// off_s % 32 bits and ORed into the frame slot at word off_s / 32; the
// shifted-out low bits of its last word spill into the word after.
//
// What bounds it on the card: bytes.  At preset -8 (B=256 frames, S=2,
// P=2688, W=5248) it reads B*S*P*4 = 5.5 MB of panels and writes
// B*W*4 = 5.4 MB of slots, about 3 us at the H100's 3.35 TB/s; the
// arithmetic is two shifts and an OR per word.
//
// Design: one block per frame, its (W,) slot in dynamic shared memory
// (21 KB at preset -8, 29 KB at 24 bits).  Threads walk each panel's words
// in order, so the reads of p[i] and p[i-1] are coalesced, OR their
// shifted words into the slot with atomicOr (neighbouring panels share one
// boundary word), and the block stores the finished slot with one
// coalesced pass.  Every write is bounds-checked against the slot, so junk
// offsets of fallback frames cannot leave their row.  Shift amounts stay
// in 1..31: sh == 0 takes its own branch.
//
// A slot larger than one block's shared memory (227 KB: 8 channels at
// block 16384 and 24 bits) takes the same body with the slot in global
// memory: the entry point zeroes the output and the threads atomicOr
// straight into it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// largest dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kMaxSharedBytes = 232448;

// kShared: the slot lives in shared memory; else it is the zeroed output
template <bool kShared>
__global__ void splice_kernel(const uint32_t* __restrict__ panels,
                              const int32_t* __restrict__ bit_offs,
                              uint32_t* __restrict__ out, int S, int P,
                              int W) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  uint32_t* o = out + static_cast<size_t>(b) * W;
  uint32_t* slot = kShared ? smem : o;
  if (kShared) {
    for (int i = threadIdx.x; i < W; i += blockDim.x) slot[i] = 0u;
    __syncthreads();
  }

  for (int s = 0; s < S; ++s) {
    const uint32_t* p = panels + (static_cast<size_t>(b) * S + s) * P;
    const int off = bit_offs[b * S + s];
    const int wo = off >> 5;                      // arithmetic: off may be junk
    const unsigned sh = static_cast<unsigned>(off) & 31u;
    // word i of the shifted panel, i in [0, P]; word P is the spill
    for (int i = threadIdx.x; i <= P; i += blockDim.x) {
      const uint32_t cur = i < P ? p[i] : 0u;
      uint32_t v;
      if (sh == 0u) {
        v = cur;
      } else {
        const uint32_t prev = i > 0 ? p[i - 1] : 0u;
        v = (cur >> sh) | (prev << (32u - sh));
      }
      const long long dst = static_cast<long long>(wo) + i;
      if (v != 0u && dst >= 0 && dst < W) atomicOr(&slot[dst], v);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < W; i += blockDim.x) o[i] = slot[i];
  }
}

}  // namespace

// panels (B, S, P) u32, bit_offs (B, S) i32 -> out (B, W) u32, on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int flac_splice_subframes(const void* panels, const void* bit_offs,
                                     void* out, int B, int S, int P, int W,
                                     void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint32_t*>(panels);
  const auto* offs = static_cast<const int32_t*>(bit_offs);
  auto* o = static_cast<uint32_t*>(out);
  const size_t smem = static_cast<size_t>(W) * sizeof(uint32_t);
  if (smem > kMaxSharedBytes) {
    cudaError_t e = cudaMemsetAsync(o, 0, smem * B, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    splice_kernel<false><<<B, kThreads, 0, st>>>(p, offs, o, S, P, W);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        splice_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  splice_kernel<true><<<B, kThreads, smem, st>>>(p, offs, o, S, P, W);
  return static_cast<int>(cudaGetLastError());
}
