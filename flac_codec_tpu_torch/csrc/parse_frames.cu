// K4: parse whole FLAC frame bodies into raw subframes.
//
// Replaces the Pallas kernel flac_codec_tpu/ops/framescan.py:_parse_kernel
// (called through parse_frame_bodies) and the XLA sort that compacts its
// output.  The TPU kernel runs one bit-serial state machine per lane and
// emits each decoded value at its bit row, because Mosaic cannot write a
// per-lane slot; a sort then gathers the emissions into dense arrays.
// Here a thread parses one frame body and writes every sample and
// parameter straight to its slot in the outputs: no emission panel, no
// compaction.  The host has found each body (byte offset, bit length) and
// checked its CRCs; the wrapper zeroes the outputs before the launch.
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
// Reading: symbol by symbol, not bit by bit.  A 64-bit big-endian window
// holds the next bits, refilled to more than 32 bits with aligned 32-bit
// loads (bytes up to the first aligned word of a body, and at the end of
// the data); a fixed field is one shift, a unary run is __clzll of the
// window, and a Rice code whose unary part and k low bits lie in the
// window (almost all of them) costs one __clzll and two shifts.
//
// What bounds it on the card: neither bytes nor operations but the serial
// chain of each frame.  Every code's position depends on the length of
// the code before it, so a thread walks its body in order: ~68.5k body
// bits, ~8.3k codes per preset -8 16-bit frame, each a window refill, a
// __clzll and a store that waits on the one before.  The time is one
// frame's chain.  Each frame has a warp of its own (one-thread blocks, so
// a 256-frame batch spreads over all SMs): frames sharing a warp diverge
// at every partition and subframe, and 32 of them in a warp ran an order
// of magnitude slower than one.  Splitting a partition's codes over the
// idle lanes once its start is known is the way to shorten the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1;     // one frame per warp (see above)
// unary runs longer than this are not ok (ops/framescan.py MAX_Q)
constexpr uint32_t kMaxQ = 1u << 20;

// fixed-predictor taps, most recent first (reference: src/stream.rs:1534)
__constant__ int32_t kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

__device__ __forceinline__ uint64_t shl64(uint64_t x, int n) {
  return n >= 64 ? 0ull : x << n;
}

// MSB-first reader over one body.  Bytes outside [0, len) of the data
// read as zero; every read checks the body's bit length.
struct Bits {
  const uint8_t* data;
  long long len;     // bytes in data
  long long next;    // next byte of data to load into the window
  long long pos;     // bits of the body consumed
  long long nbits;   // the body's length in bits
  uint64_t win;      // the next bits, MSB-first; zero past `have`
  int have;          // bits of win loaded

  __device__ void init(const uint8_t* d, long long l, long long off,
                       long long nb) {
    data = d; len = l; next = off; pos = 0; nbits = nb; win = 0; have = 0;
  }
  // to more than 32 bits
  __device__ __forceinline__ void refill() {
    while (have <= 32) {
      if ((next & 3) == 0 && next >= 0 && next + 4 <= len) {
        const uint32_t w = __byte_perm(
            *reinterpret_cast<const uint32_t*>(data + next), 0, 0x0123);
        win |= static_cast<uint64_t>(w) << (32 - have);
        have += 32;
        next += 4;
      } else {
        const uint64_t b = (next >= 0 && next < len) ? data[next] : 0u;
        win |= b << (56 - have);
        have += 8;
        ++next;
      }
    }
  }
  __device__ __forceinline__ void skip(int n) {  // n <= have
    win = shl64(win, n);
    have -= n;
    pos += n;
  }
  // n in [1, 32] bits, unsigned
  __device__ __forceinline__ bool get(int n, uint32_t& v) {
    if (pos + n > nbits) return false;
    if (have < n) refill();
    v = static_cast<uint32_t>(win >> (64 - n));
    skip(n);
    return true;
  }
  // n in [1, 32] bits, two's complement
  __device__ __forceinline__ bool get_signed(int n, int32_t& v) {
    uint32_t u;
    if (!get(n, u)) return false;
    v = static_cast<int32_t>(u << (32 - n)) >> (32 - n);
    return true;
  }
  // zeros before the next 1 bit, which is consumed
  __device__ bool unary(uint32_t& q) {
    uint32_t zeros = 0;
    for (;;) {
      refill();
      if (win != 0) {
        const int z = __clzll(static_cast<long long>(win));
        zeros += z;
        if (zeros > kMaxQ || pos + z + 1 > nbits) return false;
        skip(z + 1);
        q = zeros;
        return true;
      }
      zeros += have;
      pos += have;
      win = 0;
      have = 0;
      if (zeros > kMaxQ || pos > nbits) return false;
    }
  }
};

__device__ __forceinline__ int32_t rice_value(uint64_t u) {
  return static_cast<int32_t>((u >> 1) ^ (0ull - (u & 1ull)));
}

// One Rice partition of m codes with parameter k into out[0, m).
__device__ bool rice_partition(Bits& g, int k, int m, int32_t* out) {
  const uint32_t qmax = (1u << 30) >> k;
  for (int i = 0; i < m; ++i) {
    g.refill();
    uint32_t q;
    uint32_t lsb = 0;
    const int z = g.win ? __clzll(static_cast<long long>(g.win)) : 64;
    if (z + 1 + k <= g.have) {       // the whole code is in the window
      if (g.pos + z + 1 + k > g.nbits) return false;
      q = z;
      if (k) lsb = static_cast<uint32_t>(shl64(g.win, z + 1) >> (64 - k));
      g.skip(z + 1 + k);
    } else {
      if (!g.unary(q)) return false;
      if (k && !g.get(k, lsb)) return false;
    }
    if (q > qmax) return false;
    out[i] = rice_value((static_cast<uint64_t>(q) << k) | lsb);
  }
  return true;
}

// One subframe into row (N,), q (32,) and its parameters.
__device__ bool subframe(Bits& g, int eff_bits, int N, int32_t* row,
                         int32_t* q, int32_t* order_out, int32_t* shift_out,
                         int32_t* wasted_out) {
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
    if (!g.unary(w)) return false;
    wasted = static_cast<int>(w) + 1;
  }
  const int eff = eff_bits - wasted;
  if (eff <= 0 || order > N) return false;
  *order_out = order;
  *wasted_out = wasted;
  int32_t x;
  if (t6 == 0) {                                 // constant
    if (!g.get_signed(eff, x)) return false;
    for (int i = 0; i < N; ++i) row[i] = x;
    return true;
  }
  if (t6 == 1) {                                 // verbatim
    for (int i = 0; i < N; ++i) {
      if (!g.get_signed(eff, x)) return false;
      row[i] = x;
    }
    return true;
  }
  for (int i = 0; i < order; ++i) {              // warm-up samples
    if (!g.get_signed(eff, x)) return false;
    row[i] = x;
  }
  if (t6 >= 32) {                                // LPC parameters
    uint32_t p;
    if (!g.get(4, p) || p == 15u) return false;
    int32_t sh;
    if (!g.get_signed(5, sh) || sh < 0) return false;
    *shift_out = sh;
    for (int j = 0; j < order; ++j) {
      if (!g.get_signed(static_cast<int>(p) + 1, x)) return false;
      q[j] = x;
    }
  } else {
    for (int j = 0; j < order; ++j) q[j] = kFixed[order][j];
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
      if (width) {                               // raw samples
        for (int j = 0; j < m; ++j) {
          if (!g.get_signed(static_cast<int>(width), x)) return false;
          row[i + j] = x;
        }
      }                                          // width 0: zeros
    } else if (!rice_partition(g, static_cast<int>(param), m, row + i)) {
      return false;
    }
    i += m;
  }
  return true;
}

__global__ void parse_frames_kernel(
    const uint8_t* __restrict__ data, long long len,
    const long long* __restrict__ body_off, const int32_t* __restrict__ nbits,
    const int32_t* __restrict__ assignment, int B, int C, int N, int bps,
    int32_t* __restrict__ buf, int32_t* __restrict__ order,
    int32_t* __restrict__ shift, int32_t* __restrict__ wasted,
    int32_t* __restrict__ qcoeffs, bool* __restrict__ ok) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Bits g;
  g.init(data, len, body_off[b], nbits[b]);
  const int a = assignment[b];
  bool good = nbits[b] >= 0;
  for (int c = 0; c < C && good; ++c) {
    // the side channel of a stereo decorrelation has one bit more
    const bool side = ((a == 8 || a == 10) && c == 1) || (a == 9 && c == 0);
    const size_t bc = static_cast<size_t>(b) * C + c;
    good = subframe(g, bps + (side ? 1 : 0), N, buf + bc * N,
                    qcoeffs + bc * 32, order + bc, shift + bc, wasted + bc);
  }
  if (!good) {
    const size_t bc = static_cast<size_t>(b) * C;
    for (size_t i = 0; i < static_cast<size_t>(C) * N; ++i) buf[bc * N + i] = 0;
    for (int i = 0; i < C * 32; ++i) qcoeffs[bc * 32 + i] = 0;
    for (int c = 0; c < C; ++c) order[bc + c] = shift[bc + c] = wasted[bc + c] = 0;
  }
  ok[b] = good;
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
  parse_frames_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), len,
      static_cast<const long long*>(body_off),
      static_cast<const int32_t*>(nbits),
      static_cast<const int32_t*>(assignment), B, C, N, bps,
      static_cast<int32_t*>(buf), static_cast<int32_t*>(order),
      static_cast<int32_t*>(shift), static_cast<int32_t*>(wasted),
      static_cast<int32_t*>(qcoeffs), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
