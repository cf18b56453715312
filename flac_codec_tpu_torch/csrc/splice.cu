// K1: splice subframe panels into frame slots.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/packpanel.py:_splice_kernel
// (called through splice_subframes).  A frame body is the bit-concatenation
// of its S subframe panels: panel s is funnel-shifted right by
// off_s % 32 bits and added into the frame slot at word off_s / 32; the
// shifted-out low bits of its last word spill into the word after.
//
// What bounds it on the card: bytes.  At preset -8 (B=256 frames, S=2,
// P=2688, W=5248) it reads B*S*P*4 = 5.5 MB of panels and writes
// B*W*4 = 5.4 MB of slots, about 3 us at the H100's 3.35 TB/s; the
// arithmetic is two shifts and an add per panel word.
//
// Design: a gather.  Each thread makes 4 consecutive words of one slot,
// each computed where it lands: for word d and panel s, i = d - (off_s >>
// 5) indexes the shifted panel (0 <= i <= P, with p[-1] = p[P] = 0), whose
// word i is the funnel shift of p[i-1] and p[i]; the slot word is the
// wrapping 32-bit sum of its panels' words, as the Pallas kernel's
// `cur + rolled` and the plain version's index_add_ make it on every input
// (overlapping set bits included).  A thread skips the panels that reach
// none of its words and loads 5 words of each other one, all independent
// (a panel's neighbouring words come from L1); every slot word is written
// once, with a 16-byte store, and words outside the slot are never
// computed, so junk offsets of fallback frames, negative ones included,
// cannot leave their row.  No shared memory, no atomics, no zeroing: one
// path serves every slot size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // slot words a thread

__global__ void splice_kernel(const uint32_t* __restrict__ panels,
                              const int32_t* __restrict__ bit_offs,
                              uint32_t* __restrict__ out, int S, int P,
                              int W, int groups_per_block) {
  // blocks walk the slots row by row: block x of row b is blockIdx.x
  // = b * groups_per_block + x
  const int b = blockIdx.x / groups_per_block;
  const int d0 =
      ((blockIdx.x - b * groups_per_block) * kThreads + threadIdx.x) * kWords;
  if (d0 >= W) return;
  uint32_t acc[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc[k] = 0u;
  for (int s = 0; s < S; ++s) {
    const int off = __ldg(bit_offs + b * S + s);
    // w[k] = p[i0 + k], zero outside the panel (which also zeroes the
    // shifted words past the spill word and before the first); arithmetic
    // shift: off may be junk, negative included
    const long long i0 = static_cast<long long>(d0) - (off >> 5) - 1;
    if (i0 >= P || i0 + kWords < 0) continue;   // no word of this panel
    const uint32_t* p = panels + (static_cast<size_t>(b) * S + s) * P;
    const unsigned sh = static_cast<unsigned>(off) & 31u;
    uint32_t w[kWords + 1];
#pragma unroll
    for (int k = 0; k <= kWords; ++k)
      w[k] = (i0 + k >= 0 && i0 + k < P) ? __ldg(p + i0 + k) : 0u;
    // shifted word = (p[i] >> sh) | (p[i-1] << (32 - sh)), p[i] for sh == 0
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      acc[k] += __funnelshift_r(w[k + 1], w[k], sh);
  }
  uint32_t* o = out + static_cast<size_t>(b) * W + d0;
  if (d0 + kWords <= W && (W % kWords) == 0) {   // 16-byte aligned
    *reinterpret_cast<uint4*>(o) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      if (d0 + k < W) o[k] = acc[k];
  }
}

}  // namespace

// panels (B, S, P) u32, bit_offs (B, S) i32 -> out (B, W) u32, on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int flac_splice_subframes(const void* panels, const void* bit_offs,
                                     void* out, int B, int S, int P, int W,
                                     void* stream) {
  const int groups = (W + kThreads * kWords - 1) / (kThreads * kWords);
  splice_kernel<<<static_cast<unsigned>(B) * groups, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(panels),
      static_cast<const int32_t*>(bit_offs), static_cast<uint32_t*>(out), S,
      P, W, groups);
  return static_cast<int>(cudaGetLastError());
}
