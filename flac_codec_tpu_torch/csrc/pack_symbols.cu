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
// writing 256 panels of P = 2688 words (2.75 MB) and 256 overflow bytes,
// about 5 us at the H100's 3.35 TB/s.
//
// Design: one block of 8 warps per row, its (P,) panel in dynamic shared
// memory (10.5 KB at preset -8).
// * The row's four arrays stream through shared memory in tiles of 1024
//   symbols, a ring of 4 stages filled by 16-byte cp.async copies 3 tiles
//   ahead of the tile in use (~40 KB in flight a row), all four arrays
//   copied whole, whatever the mask says; one barrier a tile.  A tile's
//   copy starts at the 16-byte chunk that holds its first symbol, so rows
//   of any M and any alignment take the same path; the first and last
//   chunk of a row may carry bytes of the neighbouring rows (or, for the
//   last row, up to 15 bytes past the array, inside the same aligned 16
//   bytes and so inside the allocation), which are never used.
// * A lane takes 4 consecutive symbols.  Each live symbol makes a hi word
//   at w0 and a lo word at w0 + 1 with one 64-bit shift (the words the JAX
//   package's _symbol_geometry computes), and the lane ORs its words in
//   registers while they land in the same panel word.  A word between its
//   first and last goes straight to a shared atomicOr.  Its last word
//   joins the next lane's first when they coincide (a shuffle), and lanes
//   whose symbols all land in one word OR runs of equal first words
//   together (a segmented scan over the warp, only as many shuffle steps
//   as the longest run needs: none for 8-12-bit codes, three for 1-bit
//   ones); the last lane of a run does the atomicOr.  For a stream in
//   order that is about one atomic a panel word instead of two a symbol,
//   and the warp-level work is shared by 4 symbols.  OR is commutative
//   and live fields are disjoint, so any grouping is exact: symbols in any
//   order (framepack appends the header fields after the residual
//   section, whose bits come later) pack the same panel, only with more
//   atomics.
// * Zeroing and the store of the finished panel go 16 bytes a thread.
// * A row overflows only when a live symbol would land outside the panel
//   (or is wider than 32 bits); that symbol is dropped, and the block
//   writes its row's flag as one byte (a torch.bool), so a call is one
//   launch.  Shift amounts stay in 0..63.
//
// A panel that does not fit beside the ring in one block's shared memory
// (227 KB; P > ~44,700 words: 32-bit samples at blocks past ~41k) takes the
// same body with the panel in global memory: the block zeroes its own
// output row and atomicOrs straight into it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                   // symbols a stage
constexpr int kStages = 4;
constexpr int kPer = 4;                       // consecutive symbols a lane
// one stage: each array's tile from the 16-byte chunk holding its first
// symbol, so one chunk more than the tile
constexpr int kWordBytes = kTile * 4 + 16;
constexpr int kMaskBytes = kTile + 16;
constexpr int kStageBytes = 3 * kWordBytes + kMaskBytes;
constexpr int kRingBytes = kStages * kStageBytes;
// largest dynamic shared memory one block may use on Hopper (227 KB)
constexpr size_t kMaxSharedBytes = 232448;

__device__ __forceinline__ void copy16(unsigned char* dst,
                                       const unsigned char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 2));
}

// Start copying `n` elements of `size` bytes from `row` (element 0 of the
// tile) into `dst`, from the 16-byte chunk that holds element 0.
__device__ __forceinline__ void fetch(unsigned char* dst,
                                      const unsigned char* row, int n,
                                      int size) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(row);
  const unsigned char* chunk0 = row - (at & 15);
  const int chunks = static_cast<int>(((at & 15) + n * size + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    copy16(dst + 16 * c, chunk0 + 16 * c);
}

struct Row {
  const unsigned char* values;
  const unsigned char* widths;
  const unsigned char* ends;
  const unsigned char* mask;
};

// Start copying tile t of the row into stage buffer `st`; one commit group
// (empty past the row's end, so the group count stays even).
__device__ __forceinline__ void fetch_tile(unsigned char* st, const Row& row,
                                           int t, int tiles, int M) {
  if (t < tiles) {
    const size_t i = static_cast<size_t>(t) * kTile;
    const int n = min(kTile, M - t * kTile);
    fetch(st, row.values + 4 * i, n, 4);
    fetch(st + kWordBytes, row.widths + 4 * i, n, 4);
    fetch(st + 2 * kWordBytes, row.ends + 4 * i, n, 4);
    fetch(st + 3 * kWordBytes, row.mask + i, n, 1);
  }
  commit_copies();
}

// Zero `n` words at `p`, 16 bytes a thread where `p` and `n` allow.
__device__ __forceinline__ void zero_words(uint32_t* p, int n) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && (n & 3) == 0) {
    uint4* p4 = reinterpret_cast<uint4*>(p);
    for (int k = threadIdx.x; k < n / 4; k += kThreads)
      p4[k] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int k = threadIdx.x; k < n; k += kThreads) p[k] = 0u;
  }
}

// kShared: the panel lives in shared memory; else it is the output row
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pack_symbols_kernel(const uint32_t* __restrict__ values,
                    const int32_t* __restrict__ widths,
                    const int32_t* __restrict__ ends,
                    const uint8_t* __restrict__ mask,
                    uint32_t* __restrict__ out,
                    uint8_t* __restrict__ overflow, int M, int P,
                    int limit, int panel_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* o = out + static_cast<size_t>(r) * P;
  uint32_t* panel = kShared ? reinterpret_cast<uint32_t*>(smem) : o;
  unsigned char* ring = smem + (kShared ? panel_bytes : 0);

  const size_t base = static_cast<size_t>(r) * M;
  const Row row = {reinterpret_cast<const unsigned char*>(values + base),
                   reinterpret_cast<const unsigned char*>(widths + base),
                   reinterpret_cast<const unsigned char*>(ends + base),
                   mask + base};
  // each array's byte offset inside its 16-byte chunk; tiles are whole
  // multiples of 16 bytes, so every tile of the row starts at the same one
  const int ph_v = static_cast<int>(reinterpret_cast<uintptr_t>(row.values) & 15);
  const int ph_w = static_cast<int>(reinterpret_cast<uintptr_t>(row.widths) & 15);
  const int ph_e = static_cast<int>(reinterpret_cast<uintptr_t>(row.ends) & 15);
  const int ph_m = static_cast<int>(reinterpret_cast<uintptr_t>(row.mask) & 15);

  const int tiles = (M + kTile - 1) / kTile;
  for (int t = 0; t < kStages - 1; ++t)
    fetch_tile(ring + t * kStageBytes, row, t, tiles, M);
  zero_words(panel, kShared ? panel_bytes / 4 : P);

  const unsigned full = 0xffffffffu;
  int ovf = 0;
  for (int t = 0; t < tiles; ++t) {
    wait_copies();        // tile t's group is complete
    __syncthreads();      // ... for every thread, and tile t - 1 is done
    fetch_tile(ring + ((t + kStages - 1) % kStages) * kStageBytes, row,
               t + kStages - 1, tiles, M);
    const unsigned char* st = ring + (t % kStages) * kStageBytes;
    const int n = min(kTile, M - t * kTile);
    // lane l of warp w takes kPer consecutive symbols; their words are
    // ORed in registers in order: the lane's first word (h) and last (p)
    // may be shared with its neighbours, the words between are its own
#pragma unroll
    for (int s = 0; s < kTile / (kThreads * kPer); ++s) {
      const int j0 = ((s * kWarps + warp) * 32 + lane) * kPer;
      int hk = -1, pk = -1;
      uint32_t hv = 0u, pv = 0u;
      auto add = [&](int k, uint32_t x) {
        if (!x) return;
        if (k == pk) {
          pv |= x;
          return;
        }
        if (pk >= 0) {
          if (hk < 0) {
            hk = pk;
            hv = pv;
          } else {
            atomicOr(&panel[pk], pv);
          }
        }
        pk = k;
        pv = x;
      };
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int j = j0 + q;  // < kTile
        const uint32_t v = *reinterpret_cast<const uint32_t*>(st + ph_v + 4 * j);
        const int w = *reinterpret_cast<const int32_t*>(st + kWordBytes + ph_w + 4 * j);
        const int e = *reinterpret_cast<const int32_t*>(st + 2 * kWordBytes + ph_e + 4 * j);
        const bool live = j < n && st[3 * kWordBytes + ph_m + j] && w > 0;
        const bool fits = w <= 32 && e >= w && e <= limit;
        ovf |= live && !fits;
        const bool use = live && fits;
        const unsigned start = static_cast<unsigned>(e) - static_cast<unsigned>(w);
        const unsigned eb = (start & 31u) + static_cast<unsigned>(w);  // 1..63
        const unsigned long long win =
            static_cast<unsigned long long>(v) << ((64u - eb) & 63u);
        const int key = static_cast<int>(start >> 5);
        add(key, use ? static_cast<uint32_t>(win >> 32) : 0u);
        add(key + 1, use ? static_cast<uint32_t>(win) : 0u);
      }
      int tk = -1;
      uint32_t tv = 0u;
      if (hk < 0) {
        hk = pk;
        hv = pv;
      } else {
        tk = pk;
        tv = pv;
      }
      // a lane's last word joins the next lane's first when they coincide
      const int tk_up = __shfl_up_sync(full, tk, 1);
      const uint32_t tv_up = __shfl_up_sync(full, tv, 1);
      const int hk_up = __shfl_up_sync(full, hk, 1);
      const int hk_down = __shfl_down_sync(full, hk, 1);
      uint32_t x = hv | (lane > 0 && tk_up >= 0 && tk_up == hk ? tv_up : 0u);
      if (tk >= 0 && !(lane < 31 && hk_down == tk)) atomicOr(&panel[tk], tv);
      // lanes whose symbols all land in one word: OR runs of lanes with the
      // same first word (segmented scan, as far as the longest run needs)
      const unsigned heads = __ballot_sync(full, lane == 0 || hk_up != hk);
      const int first = 31 - __clz(heads & (full >> (31 - lane)));
      unsigned stretch = ~heads;
      for (int d = 1; stretch; d <<= 1) {
        const uint32_t y = __shfl_up_sync(full, x, d);
        if (lane - d >= first) x |= y;
        stretch &= stretch >> d;
      }
      const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
      if (last && x) atomicOr(&panel[hk], x);
    }
  }
  const int row_ovf = __syncthreads_or(ovf);

  if (kShared) {
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0 && (P & 3) == 0) {
      const uint4* p4 = reinterpret_cast<const uint4*>(panel);
      uint4* o4 = reinterpret_cast<uint4*>(o);
      for (int k = threadIdx.x; k < P / 4; k += kThreads) o4[k] = p4[k];
    } else {
      for (int k = threadIdx.x; k < P; k += kThreads) o[k] = panel[k];
    }
  }
  if (threadIdx.x == 0) overflow[r] = row_ovf ? 1 : 0;
}

}  // namespace

// values (rows, M) u32, widths/ends (rows, M) i32, mask (rows, M) bool ->
// out (rows, P) u32, overflow (rows,) bool, on `stream`: one launch.
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
  auto* ovf = static_cast<uint8_t*>(overflow);
  // the panel rounded up to whole 16-byte chunks, then the ring
  const size_t panel_bytes = (static_cast<size_t>(P) * 4 + 15) & ~size_t{15};
  const bool shared = panel_bytes + kRingBytes <= kMaxSharedBytes;
  const size_t smem = shared ? panel_bytes + kRingBytes : kRingBytes;
  auto* kernel = shared ? pack_symbols_kernel<true> : pack_symbols_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the panel's last bit + 1; an int32 end never passes a larger one
  const int limit = P > (INT_MAX >> 5) ? INT_MAX : P * 32;
  kernel<<<rows, kThreads, smem, st>>>(v, w, e, m, o, ovf, M, P, limit,
                                       static_cast<int>(shared ? panel_bytes : 0));
  return static_cast<int>(cudaGetLastError());
}
