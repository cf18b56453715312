// K4: parse whole FLAC frame bodies into raw subframes, a warp per body.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/framescan.py:_parse_kernel
// (called through parse_frame_bodies) and the XLA sort that compacts its
// output.  The TPU kernel runs one bit-serial state machine per lane and
// emits each decoded value at its bit row, because Mosaic cannot write a
// per-lane slot; a sort then gathers the emissions into dense arrays.
// Here a warp parses one frame body and writes every sample and parameter
// straight to its slot in the outputs: no emission panel, no compaction.
// The host has found each body (byte offset, bit length) and checked its
// CRCs; the wrapper zeroes the outputs before the launch.
//
// Per frame and channel (reference semantics: src/decode.rs:1635-1856):
// subframe header, wasted-bits unary, constant / verbatim samples or
// warm-ups, LPC precision, shift and coefficients (the fixed rows for
// FIXED), residual method and partition order, then per partition a Rice
// parameter and Rice codes, or an escape width and raw samples.  Outputs:
// buf (B, C, N) i32, order / shift / wasted (B, C) i32, qcoeffs (B, C, 32)
// i32, ok (B,) bool.  A body is not ok on the constructs listed in
// ops/framescan.py; its outputs are then zeroed again.
//
// What bounds it on the card: neither bytes (~8.5 KB a frame) nor
// operations, but each frame's chain of dependent steps.  The position of
// every field and code depends on the length of the one before it, and a
// frame's fields are ~68.5k bits and ~8.3k Rice codes at preset -8 16-bit.
// A one-thread walk costs one refill, count-leading-zeros and store per
// code, and leaves 31 lanes of every warp idle.  This design shortens the
// chain; every phase is warp-uniform, so the warp never diverges:
//
// * Headers (subframe header, wasted-bits unary, LPC precision and shift,
//   residual method, partition parameters) are read serially by all 32
//   lanes at once, the same bits on every lane, so nothing is broadcast
//   and the `ok` checks stay where they were.  A field is two aligned
//   big-endian words funnel-shifted; a unary run is read 1024 bits a step,
//   32 bits a lane, and a ballot finds the first 1.
// * Runs of raw values (verbatim samples, warm-ups, LPC coefficients,
//   escaped partitions) go across the lanes: value j lies at a known bit,
//   lane l reads j = l, l + 32, ...; one comparison with the body's end
//   before the run gives the `ok` of reading them one by one.  A constant
//   subframe's fill and the zeroing of a body that is not ok also go
//   across the lanes.
// * A Rice partition is decoded a 1024-bit window at a time: 32 aligned
//   words from the one holding the next code, one a lane, in shared memory.
//   (a) The first 1 at or after each bit: count-leading-zeros in the
//   lane's word, a suffix min over the lanes past it.  (b) Each lane builds
//   its word's jump table, last offset first: from a code starting at
//   offset e, the first code start past the word and the codes started in
//   the word on the way.  (c) All lanes chase the table from the window's
//   first code, one shared load a word (~17 for a preset -8 partition of
//   64 codes, against 64 dependent decodes); each lane notes where the
//   chain enters its word and how many codes came before.  (d) Each lane
//   decodes its word's codes (quotient, k low bits, zig-zag) into their
//   slots.  Phases (b)-(d) use selects, not branches: a branch that could
//   split the warp cost its reconvergence on every step.
// * The window takes codes up to just before the first one that leaves
//   it, passes the body's end or has a quotient above 2^30 >> k (a unary
//   run of more than MAX_Q zeros cannot lie in a window).  With codes left,
//   the next window opens at that code; when the window took none, the
//   serial step decodes exactly that one code: it flags a code that is
//   not ok, and reads a unary run longer than a window.
//
// What bounds it now: shared-memory latency inside a window.  Building the
// jump table is 32 dependent load-add-store steps a lane, and the chase one
// dependent load a word; together with the window's load and the decode
// they take ~5-6k cycles a window on an H100, one window per partition of
// a preset -8 frame.  Hopping two words a step, pointer doubling inside a
// word, scanning a word's offsets in groups, 2 or 4 frames a block, a
// ballot for phase (a) and prefetching the body into L1 each measured no
// faster.  A body has a warp of its own (one-warp blocks): the frames of a
// batch are few (256) against the card's 132 SMs, and a warp's time is its
// chain's latency, not its share of an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWords = 32;               // words of a Rice window, one a lane
constexpr int kWindow = 32 * kWords;     // its bits
constexpr int kNone = 1 << 20;           // no 1 bit in the window
// unary runs longer than this are not ok (ops/framescan.py MAX_Q)
constexpr uint32_t kMaxQ = 1u << 20;
static_assert(kWindow <= kMaxQ, "a window must not hold a run past MAX_Q");

// jump-table entry: a bit offset in the window (bits 0-15), the codes
// counted on the way to it (bits 16-21), and whether the offset is the
// start of a code that stops the window (bit 31)
constexpr uint32_t kOffset = 0xffffu;
constexpr uint32_t kOneCode = 1u << 16;
constexpr uint32_t kStop = 1u << 31;

// fixed-predictor taps, most recent first (reference: src/stream.rs:1534)
__constant__ int32_t kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

// a warp's Rice window: its words and a guard, and the lanes' jump tables
// (a row of 33 so the lanes' rows fall in different banks)
struct Window {
  uint32_t word[kWords + 1];
  uint32_t jump[kWords][kWords + 1];
};

__device__ __forceinline__ int32_t rice_value(uint32_t u) {
  return static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
}

// MSB-first reader over one body, the same state on every lane of the
// warp.  Positions count bits from `base`, the data's address rounded down
// to 4 bytes; bytes outside the data read as zero, and every read checks
// the body's bit length.
struct Bits {
  const uint8_t* base;
  long long lo, hi;   // the data is base[lo, hi)
  long long start;    // the body's first bit
  long long pos;      // bits of the body consumed
  long long nbits;    // the body's length in bits

  __device__ void init(const uint8_t* data, long long len, long long off,
                       long long nb) {
    const long long mis =
        static_cast<long long>(reinterpret_cast<uintptr_t>(data) & 3u);
    base = data - mis;
    lo = mis;
    hi = mis + len;
    start = (off + mis) * 8;
    pos = 0;
    nbits = nb;
  }
  // big-endian word w (bytes 4w .. 4w + 3 of base)
  __device__ __forceinline__ uint32_t word(long long w) const {
    const long long b = w * 4;
    if (b >= lo && b + 4 <= hi)
      return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(base + b)),
                         0, 0x0123);
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      const long long j = b + i;
      v = (v << 8) | ((j >= lo && j < hi) ? base[j] : 0u);
    }
    return v;
  }
  // the 32 bits from bit `at` of base
  __device__ __forceinline__ uint32_t peek(long long at) const {
    const long long w = at >> 5;
    return __funnelshift_l(word(w + 1), word(w), static_cast<int>(at & 31));
  }
  // n in [1, 32] bits, unsigned
  __device__ __forceinline__ bool get(int n, uint32_t& v) {
    if (pos + n > nbits) return false;
    v = peek(start + pos) >> (32 - n);
    pos += n;
    return true;
  }
  // n in [1, 32] bits, two's complement
  __device__ __forceinline__ bool get_signed(int n, int32_t& v) {
    if (pos + n > nbits) return false;
    v = static_cast<int32_t>(peek(start + pos)) >> (32 - n);
    pos += n;
    return true;
  }
  // zeros before the next 1 bit, which is consumed: 1024 bits a step,
  // 32 a lane, the first 1 found by a ballot
  __device__ bool unary(uint32_t& q, int lane) {
    uint32_t zeros = 0;
    for (;;) {
      const uint32_t v = peek(start + pos + 32 * lane);
      const uint32_t hit = __ballot_sync(kFull, v != 0u);
      if (hit) {
        const int f = __ffs(hit) - 1;
        const int z = 32 * f + __clz(__shfl_sync(kFull, v, f));
        zeros += z;
        if (zeros > kMaxQ || pos + z + 1 > nbits) return false;
        pos += z + 1;
        q = zeros;
        return true;
      }
      zeros += kWindow;
      pos += kWindow;
      if (zeros > kMaxQ || pos > nbits) return false;
    }
  }
  // n values of w in [1, 32] bits, two's complement, into out[0, n) across
  // the lanes
  __device__ bool raw(int n, int w, int32_t* out, int lane) {
    const long long bits = static_cast<long long>(n) * w;
    if (pos + bits > nbits) return false;
    const long long at = start + pos;
    for (int j = lane; j < n; j += 32)
      out[j] = static_cast<int32_t>(peek(at + static_cast<long long>(j) * w))
               >> (32 - w);
    pos += bits;
    return true;
  }
};

// One Rice code, serially (every lane the same).
__device__ bool rice_code(Bits& g, int k, uint32_t qmax, int32_t& v,
                          int lane) {
  uint32_t q, lsb = 0;
  if (!g.unary(q, lane)) return false;
  if (k && !g.get(k, lsb)) return false;
  if (q > qmax) return false;
  v = rice_value((q << k) | lsb);
  return true;
}

// One Rice partition of m codes with parameter k into out[0, m), a window
// at a time (see the note at the top).
__device__ bool rice_partition(Bits& g, int k, int m, int32_t* out,
                               Window& win, int lane) {
  const uint32_t qmax = (1u << 30) >> k;
  const int base = 32 * lane;
  int done = 0;
  while (done < m) {
    // the window: 32 words from the one holding the next code, a guard
    const long long at = g.start + g.pos;
    const int r0 = static_cast<int>(at & 31);
    const uint32_t w = g.word((at >> 5) + lane);
    win.word[lane] = w;
    if (lane == 0) win.word[kWords] = g.word((at >> 5) + kWords);
    // a code must end by the window's end and by the body's
    const long long left = g.nbits - g.pos + r0;
    const int edge = left < kWindow ? static_cast<int>(left) : kWindow;

    // (a) the first 1 past this lane's word: a suffix min over the lanes
    int first = w ? base + __clz(w) : kNone;
    for (int d = 1; d < 32; d <<= 1)
      first = min(first, __shfl_down_sync(kFull, first, d));
    int after = __shfl_down_sync(kFull, first, 1);
    if (lane == 31) after = kNone;

    // (b) this word's jump table, last offset first.  Phases (b)-(d) are
    // written without branches that could split the warp: a lane whose
    // value is not needed computes it all the same and discards it.
    for (int e = 31; e >= 0; --e) {
      const int t = base + e;
      const uint32_t x = w << e;
      const int one = x ? t + __clz(x) : after;
      const int stop = one + 1 + k;
      const uint32_t nxt = win.jump[lane][min(stop - base, 31)];
      uint32_t ent = stop < base + 32 ? nxt + kOneCode
                                      : kOneCode | static_cast<uint32_t>(stop);
      if (stop > edge || static_cast<uint32_t>(one - t) > qmax)
        ent = kStop | static_cast<uint32_t>(t);
      win.jump[lane][e] = ent;
    }
    __syncwarp();

    // (c) chase the table from the window's first code, word by word;
    // each lane notes where the chain enters its word and the codes
    // before it
    const int need = m - done;
    int off = r0, taken = 0, entry = -1, before = 0, last = -1;
    for (bool more = true; more;) {
      const int j = off >> 5;
      const uint32_t ent = win.jump[j][off & 31];
      entry = lane == j ? off & 31 : entry;
      before = lane == j ? taken : before;
      const int c = static_cast<int>((ent >> 16) & 63u);
      const bool full = taken + c >= need;
      const int next = static_cast<int>(ent & kOffset);
      last = full ? j : last;
      taken = full ? need : taken + c;
      more = !full && !(ent & kStop) && next < kWindow;
      off = full ? off : next;
    }

    // (d) each lane decodes the codes that start in its word, the lanes in
    // step (a lane past its last code stores nothing)
    const int codes = static_cast<int>(
        (win.jump[lane][max(entry, 0)] >> 16) & 63u);
    const int n = entry < 0 ? 0 : min(codes, need - before);
    const int steps = __reduce_max_sync(kFull, n);
    int32_t* dst = out + done + before;
    int t = base + max(entry, 0);
    for (int i = 0; i < steps; ++i) {
      const int sh = min(t - base, 31);
      const uint32_t x = w << sh;
      const int one = x ? base + sh + __clz(x) : after;
      const int b = min(one + 1, kWindow - 1);
      const uint32_t lsb = k ? __funnelshift_l(win.word[(b >> 5) + 1],
                                               win.word[b >> 5], b & 31)
                                   >> (32 - k)
                             : 0u;
      if (i < n)
        dst[i] = rice_value((static_cast<uint32_t>(one - t) << k) | lsb);
      t = i < n ? one + 1 + k : t;
    }
    if (last >= 0) off = __shfl_sync(kFull, t, last);
    g.pos += off - r0;
    done += taken;
    __syncwarp();   // the window is read before the next one is loaded

    if (taken == 0) {   // the window's first code stops it: serially
      int32_t v;
      if (!rice_code(g, k, qmax, v, lane)) return false;
      if (lane == 0) out[done] = v;
      ++done;
    }
  }
  return true;
}

// One subframe into row (N,), q (32,) and its parameters.
__device__ bool subframe(Bits& g, int eff_bits, int N, int32_t* row,
                         int32_t* q, int32_t* order_out, int32_t* shift_out,
                         int32_t* wasted_out, Window& win, int lane) {
  uint32_t v;
  if (!g.get(8, v) || (v >> 7)) return false;    // pad bit
  const uint32_t t6 = (v >> 1) & 63u;
  int order;
  if (t6 >= 32) order = (t6 & 31) + 1;
  else if (t6 >= 8 && t6 <= 12) order = t6 - 8;
  else if (t6 <= 1) order = 0;
  else return false;                             // reserved type
  int wasted = 0;
  if (v & 1u) {
    uint32_t w;
    if (!g.unary(w, lane)) return false;
    wasted = static_cast<int>(w) + 1;
  }
  const int eff = eff_bits - wasted;
  if (eff <= 0 || order > N) return false;
  if (lane == 0) {
    *order_out = order;
    *wasted_out = wasted;
  }
  if (t6 == 0) {                                 // constant
    int32_t x;
    if (!g.get_signed(eff, x)) return false;
    for (int i = lane; i < N; i += 32) row[i] = x;
    return true;
  }
  if (t6 == 1) return g.raw(N, eff, row, lane);  // verbatim
  if (!g.raw(order, eff, row, lane)) return false;   // warm-up samples
  if (t6 >= 32) {                                // LPC parameters
    uint32_t p;
    if (!g.get(4, p) || p == 15u) return false;
    int32_t sh;
    if (!g.get_signed(5, sh) || sh < 0) return false;
    if (lane == 0) *shift_out = sh;
    if (!g.raw(order, static_cast<int>(p) + 1, q, lane)) return false;
  } else if (lane < order) {
    q[lane] = kFixed[order][lane];
  }
  if (!g.get(6, v)) return false;                // residual section
  const uint32_t method = v >> 4, po = v & 15u;
  const int plen = N >> po;
  if (method > 1u || (plen << po) != N || plen - order < 1) return false;
  const int rb = 4 + static_cast<int>(method);
  const uint32_t escape = (1u << rb) - 1u;
  int i = order;
  for (int part = 0; part < (1 << po); ++part) {
    const int m = part == 0 ? plen - order : plen;
    uint32_t param;
    if (!g.get(rb, param)) return false;
    if (param == escape) {
      uint32_t width;
      if (!g.get(5, width)) return false;
      // raw samples; width 0: zeros, as the outputs already are
      if (width && !g.raw(m, static_cast<int>(width), row + i, lane))
        return false;
    } else if (!rice_partition(g, static_cast<int>(param), m, row + i, win,
                               lane)) {
      return false;
    }
    i += m;
  }
  return true;
}

__global__ void __launch_bounds__(32) parse_frames_kernel(
    const uint8_t* __restrict__ data, long long len,
    const long long* __restrict__ body_off, const int32_t* __restrict__ nbits,
    const int32_t* __restrict__ assignment, int C, int N, int bps,
    int32_t* __restrict__ buf, int32_t* __restrict__ order,
    int32_t* __restrict__ shift, int32_t* __restrict__ wasted,
    int32_t* __restrict__ qcoeffs, bool* __restrict__ ok) {
  __shared__ Window win;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  Bits g;
  g.init(data, len, body_off[b], nbits[b]);
  const int a = assignment[b];
  bool good = nbits[b] >= 0;
  for (int c = 0; c < C && good; ++c) {
    // the side channel of a stereo decorrelation has one bit more
    const bool side = ((a == 8 || a == 10) && c == 1) || (a == 9 && c == 0);
    const size_t bc = static_cast<size_t>(b) * C + c;
    good = subframe(g, bps + (side ? 1 : 0), N, buf + bc * N,
                    qcoeffs + bc * 32, order + bc, shift + bc, wasted + bc,
                    win, lane);
  }
  if (!good) {
    __syncwarp();   // every lane's writes land before they are zeroed
    const size_t bc = static_cast<size_t>(b) * C;
    for (size_t i = lane; i < static_cast<size_t>(C) * N; i += 32)
      buf[bc * N + i] = 0;
    for (int i = lane; i < C * 32; i += 32) qcoeffs[bc * 32 + i] = 0;
    if (lane < C) order[bc + lane] = shift[bc + lane] = wasted[bc + lane] = 0;
  }
  if (lane == 0) ok[b] = good;
}

}  // namespace

// data (len,) u8; body_off (B,) i64; nbits, assignment (B,) i32 -> buf
// (B, C, N), order / shift / wasted (B, C), qcoeffs (B, C, 32) i32 and
// ok (B,) bool, all zeroed by the caller, on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int flac_parse_frames(const void* data, long long len,
                                 const void* body_off, const void* nbits,
                                 const void* assignment, int B, int C, int N,
                                 int bps, void* buf, void* order, void* shift,
                                 void* wasted, void* qcoeffs, void* ok,
                                 void* stream) {
  parse_frames_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), len,
      static_cast<const long long*>(body_off),
      static_cast<const int32_t*>(nbits),
      static_cast<const int32_t*>(assignment), C, N, bps,
      static_cast<int32_t*>(buf), static_cast<int32_t*>(order),
      static_cast<int32_t*>(shift), static_cast<int32_t*>(wasted),
      static_cast<int32_t*>(qcoeffs), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
