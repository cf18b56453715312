// Native host engine for the TPU FLAC framework.
//
// Plays the role the Rust bit engine plays in the reference
// (reference: external crate bitstream-io + src/crc.rs): the bit-serial
// host loops that cannot ride the TPU's vector units — CRC, Rice
// pack/unpack, bit-blob concatenation, and the sequential inverse-LPC
// recurrence used by the host decode path.  The device plane (JAX/Pallas)
// produces/consumes whole arrays; this file turns them into FLAC bits.
//
// Build: g++ -O3 -shared -fPIC flacnat.cpp -o libflacnat.so
// Exposed via ctypes (see build.py); pure C ABI, no pybind11.
//
// The SIMD fast paths (AVX2 paired predictor, PCLMUL CRC-16, the AVX2 and
// PCLMUL pass of the frame scan) are compiled
// unconditionally via per-function target attributes and selected at
// runtime with __builtin_cpu_supports, so one portable -O3 binary is safe
// to copy between x86-64 hosts (no -march=native in the artifact).

#include <cstdint>
#include <cstddef>
#include <cstdlib>
#include <cstring>

#if (defined(__x86_64__) || defined(__i386__)) && defined(__GNUC__)
#define FLACNAT_X86 1
#include <immintrin.h>
static inline bool cpu_has_avx2() {
    static const bool ok = __builtin_cpu_supports("avx2");
    return ok;
}
static inline bool cpu_has_clmul() {
    static const bool ok = __builtin_cpu_supports("pclmul")
                           && __builtin_cpu_supports("ssse3");
    return ok;
}
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC (reference: src/crc.rs — poly 0x07 / 0x8005, init 0, residue-0 validity)
// ---------------------------------------------------------------------------

static uint8_t CRC8_TABLE[256];
static uint16_t CRC16_TABLE[256];
// slice-by-8: CRC16_T[k][v] = CRC-16 of byte v followed by k zero bytes,
// letting the hot loop fold 8 input bytes per step with independent loads
static uint16_t CRC16_T[8][256];
static bool tables_ready = false;

static void init_tables() {
    for (int i = 0; i < 256; i++) {
        uint32_t c8 = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c8 = (c8 & 0x80) ? ((c8 << 1) ^ 0x07) & 0xFF : (c8 << 1) & 0xFF;
        CRC8_TABLE[i] = (uint8_t)c8;
        uint32_t c16 = (uint32_t)i << 8;
        for (int k = 0; k < 8; k++)
            c16 = (c16 & 0x8000) ? ((c16 << 1) ^ 0x8005) & 0xFFFF : (c16 << 1) & 0xFFFF;
        CRC16_TABLE[i] = (uint16_t)c16;
    }
    for (int v = 0; v < 256; v++) CRC16_T[0][v] = CRC16_TABLE[v];
    for (int k = 1; k < 8; k++)
        for (int v = 0; v < 256; v++)
            CRC16_T[k][v] = (uint16_t)((CRC16_T[k - 1][v] << 8)
                                       ^ CRC16_TABLE[CRC16_T[k - 1][v] >> 8]);
    tables_ready = true;
}

// run table init during (single-threaded) static initialization at library
// load so concurrent first calls from GIL-released ctypes threads never
// race the lazy flag
static const bool tables_ready_static = (init_tables(), true);

uint32_t nat_crc8(const uint8_t* data, size_t n, uint32_t crc) {
    if (!tables_ready) init_tables();
    for (size_t i = 0; i < n; i++) crc = CRC8_TABLE[(crc ^ data[i]) & 0xFF];
    return crc;
}

static uint32_t crc16_table(const uint8_t* data, size_t n, uint32_t crc);

#if defined(FLACNAT_X86)
// Carry-less-multiply CRC-16 (poly 0x8005, non-reflected, init 0).
// Folds the message 128 bits at a time: with the running 128-bit state V
// split as Vh*x^64 + Vl, appending a block B gives
//   V' = Vh*(x^192 mod P) ^ Vl*(x^128 mod P) ^ B
// (both products are 64x16-bit carry-less multiplies, < 2^80).  A long
// message first runs four such chains side by side, 64 bytes a step:
// the message so far is A0*x^384 ^ A1*x^256 ^ A2*x^128 ^ A3 (mod P), and
// each Ai folds by x^512 and takes its own 16 bytes, so no chain waits on
// another; the merge folds A0..A2 down onto A3.  The final 16 state bytes
// plus any tail run through the table path.  Constants are derived at
// static-init time so no magic numbers can rot.
// (reference CRC definition: src/crc.rs:155-180)
static uint64_t xpow_mod_p16(unsigned deg) {
    uint32_t r = 1;  // x^0
    for (unsigned i = 0; i < deg; i++) {
        r <<= 1;
        if (r & 0x10000) r ^= 0x18005;
    }
    return r;
}
static const uint64_t CRC16_K128 = xpow_mod_p16(128);
static const uint64_t CRC16_K192 = xpow_mod_p16(192);
static const uint64_t CRC16_K256 = xpow_mod_p16(256);
static const uint64_t CRC16_K320 = xpow_mod_p16(320);
static const uint64_t CRC16_K384 = xpow_mod_p16(384);
static const uint64_t CRC16_K448 = xpow_mod_p16(448);
static const uint64_t CRC16_K512 = xpow_mod_p16(512);
static const uint64_t CRC16_K576 = xpow_mod_p16(576);
// shortest message that takes the four chains
static const size_t CRC16_FOLD4_MIN = 128;

// 16 message bytes as a 128-bit polynomial, the first byte highest
__attribute__((target("pclmul,ssse3")))
static inline __m128i crc16_load(const uint8_t* p) {
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                     8, 9, 10, 11, 12, 13, 14, 15);
    return _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)p), rev);
}

// A*x^d mod P up to congruence, as Ah*(x^(d+64) mod P) ^ Al*(x^d mod P),
// K holding (x^d mod P, x^(d+64) mod P) as its (high, low) halves
__attribute__((target("pclmul,ssse3")))
static inline __m128i crc16_fold(__m128i A, __m128i K) {
    return _mm_xor_si128(_mm_clmulepi64_si128(A, K, 0x01),
                         _mm_clmulepi64_si128(A, K, 0x10));
}

static inline __m128i crc16_k(uint64_t d, uint64_t d64) {
    return _mm_set_epi64x((long long)d, (long long)d64);
}

// the four chains take 64 more bytes
__attribute__((target("pclmul,ssse3")))
static inline void crc16_fold4(__m128i (&a)[4], const uint8_t* p) {
    const __m128i K = crc16_k(CRC16_K512, CRC16_K576);
    for (int i = 0; i < 4; i++)
        a[i] = _mm_xor_si128(crc16_fold(a[i], K), crc16_load(p + 16 * i));
}

// one 128-bit state congruent to the four chains' message
__attribute__((target("pclmul,ssse3")))
static inline __m128i crc16_merge4(const __m128i (&a)[4]) {
    return _mm_xor_si128(
        _mm_xor_si128(crc16_fold(a[0], crc16_k(CRC16_K384, CRC16_K448)),
                      crc16_fold(a[1], crc16_k(CRC16_K256, CRC16_K320))),
        _mm_xor_si128(crc16_fold(a[2], crc16_k(CRC16_K128, CRC16_K192)),
                      a[3]));
}

// the CRC register after a message congruent to the state A
__attribute__((target("pclmul,ssse3")))
static inline uint32_t crc16_state(__m128i A) {
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                     8, 9, 10, 11, 12, 13, 14, 15);
    uint8_t tmp[16];
    _mm_storeu_si128((__m128i*)tmp, _mm_shuffle_epi8(A, rev));
    return crc16_table(tmp, 16, 0);
}

__attribute__((target("pclmul,ssse3")))
static uint32_t crc16_clmul(const uint8_t* data, size_t n, uint32_t crc) {
    // prior crc rides the top 16 bits of the first block
    const __m128i prior = _mm_set_epi64x((long long)((uint64_t)crc << 48), 0);
    const __m128i K = crc16_k(CRC16_K128, CRC16_K192);
    __m128i A;
    if (n >= CRC16_FOLD4_MIN) {
        __m128i a[4];
        for (int i = 0; i < 4; i++) a[i] = crc16_load(data + 16 * i);
        a[0] = _mm_xor_si128(a[0], prior);
        data += 64;
        n -= 64;
        for (; n >= 64; data += 64, n -= 64) crc16_fold4(a, data);
        A = crc16_merge4(a);
    } else {
        A = _mm_xor_si128(crc16_load(data), prior);
        data += 16;
        n -= 16;
    }
    for (; n >= 16; data += 16, n -= 16)
        A = _mm_xor_si128(crc16_fold(A, K), crc16_load(data));
    return crc16_table(data, n, crc16_state(A));
}
#endif  // FLACNAT_X86

uint32_t nat_crc16(const uint8_t* data, size_t n, uint32_t crc) {
    if (!tables_ready) init_tables();
#if defined(FLACNAT_X86)
    if (n >= 32 && cpu_has_clmul()) return crc16_clmul(data, n, crc);
#endif
    return crc16_table(data, n, crc);
}

static uint32_t crc16_table(const uint8_t* data, size_t n, uint32_t crc) {
    while (n >= 8) {
        crc = (uint32_t)(CRC16_T[7][data[0] ^ ((crc >> 8) & 0xFF)]
                         ^ CRC16_T[6][data[1] ^ (crc & 0xFF)]
                         ^ CRC16_T[5][data[2]] ^ CRC16_T[4][data[3]]
                         ^ CRC16_T[3][data[4]] ^ CRC16_T[2][data[5]]
                         ^ CRC16_T[1][data[6]] ^ CRC16_T[0][data[7]]);
        data += 8;
        n -= 8;
    }
    for (size_t i = 0; i < n; i++)
        crc = (uint32_t)CRC16_TABLE[((crc >> 8) ^ data[i]) & 0xFF] ^ ((crc << 8) & 0xFFFF);
    return crc;
}

// ---------------------------------------------------------------------------
// Bit packing (MSB-first).  Output buffer must be zero-initialised past
// bitpos; writes OR into place so device-packed blobs can be merged.
// ---------------------------------------------------------------------------

static inline void or_bits(uint8_t* out, uint64_t bitpos, uint64_t value, uint32_t nbits) {
    // Write `nbits` low bits of `value` at `bitpos`, MSB-first.
    while (nbits > 0) {
        uint64_t byte = bitpos >> 3;
        uint32_t bit_in_byte = (uint32_t)(bitpos & 7);
        uint32_t room = 8 - bit_in_byte;
        uint32_t take = nbits < room ? nbits : room;
        uint32_t shift = nbits - take;           // bits remaining after this chunk
        uint8_t chunk = (uint8_t)((value >> shift) & ((1u << take) - 1));
        out[byte] |= (uint8_t)(chunk << (room - take));
        bitpos += take;
        nbits -= take;
    }
}

uint64_t nat_pack_symbols(uint8_t* out, uint64_t bitpos,
                          const uint64_t* values, const uint32_t* nbits, size_t n) {
    for (size_t i = 0; i < n; i++) {
        or_bits(out, bitpos, values[i], nbits[i]);
        bitpos += nbits[i];
    }
    return bitpos;
}

// Rice-encode residuals (reference zigzag + unary-of-zeros-then-1 + k LSBs;
// reference: src/stream.rs:3044-3078).
uint64_t nat_pack_rice(uint8_t* out, uint64_t bitpos,
                       const int32_t* res, size_t n, uint32_t k) {
    for (size_t i = 0; i < n; i++) {
        int32_t v = res[i];
        uint32_t u = v < 0 ? ((((uint32_t)(-(int64_t)v)) - 1u) << 1) + 1u
                           : ((uint32_t)v) << 1;
        uint32_t q = u >> k;
        // q zero bits then a 1, then k LSBs
        bitpos += q;                              // zeros are implicit (buffer zeroed)
        or_bits(out, bitpos, ((uint64_t)1 << k) | (u & ((k ? ((1u << k) - 1u) : 0u))), k + 1);
        bitpos += k + 1;
    }
    return bitpos;
}

// Decode n Rice residuals with parameter k from buf starting at bitpos.
// ``limit_bits`` bounds every read; on truncation the remaining residuals
// are zero-filled and limit_bits + 1 is returned (callers treat
// end > limit as an error), so no read ever passes the buffer end.
uint64_t nat_unpack_rice(const uint8_t* buf, uint64_t bitpos,
                         int64_t* res, size_t n, uint32_t k,
                         uint64_t limit_bits) {
    for (size_t i = 0; i < n; i++) {
        if (bitpos + k + 1 > limit_bits) {
            for (size_t j = i; j < n; j++) res[j] = 0;
            return limit_bits + 1;
        }
        // unary: count zero bits until a 1
        uint32_t q = 0;
        for (;;) {
            if (bitpos >= limit_bits) {  // ran off the end mid-unary
                for (size_t j = i; j < n; j++) res[j] = 0;
                return limit_bits + 1;
            }
            uint64_t byte = bitpos >> 3;
            uint32_t bit_in_byte = (uint32_t)(bitpos & 7);
            uint8_t cur = (uint8_t)(buf[byte] << bit_in_byte);   // bits from pos left-aligned
            if (cur == 0) {
                q += 8 - bit_in_byte;
                bitpos += 8 - bit_in_byte;
            } else {
                // leading zeros of cur (cur != 0)
                uint32_t lz = (uint32_t)__builtin_clz((uint32_t)cur) - 24u;
                q += lz;
                bitpos += lz + 1;                 // consume the terminating 1
                break;
            }
        }
        uint32_t lsb = 0;
        if (bitpos + k > limit_bits) {  // LSB field would pass the end
            for (size_t j = i; j < n; j++) res[j] = 0;
            return limit_bits + 1;
        }
        for (uint32_t got = 0; got < k;) {
            uint64_t byte = bitpos >> 3;
            uint32_t bit_in_byte = (uint32_t)(bitpos & 7);
            uint32_t room = 8 - bit_in_byte;
            uint32_t take = (k - got) < room ? (k - got) : room;
            uint8_t chunk = (uint8_t)((buf[byte] >> (room - take)) & ((1u << take) - 1));
            lsb = (lsb << take) | chunk;
            bitpos += take;
            got += take;
        }
        uint64_t u = ((uint64_t)q << k) | lsb;
        res[i] = (u & 1) ? -((int64_t)(u >> 1)) - 1 : (int64_t)(u >> 1);
    }
    return bitpos;
}

// Read n signed two's-complement values of `width` bits (escaped partitions,
// verbatim subframes, warm-up samples).
uint64_t nat_unpack_signed(const uint8_t* buf, uint64_t bitpos,
                           int64_t* res, size_t n, uint32_t width) {
    if (width == 0) { for (size_t i = 0; i < n; i++) res[i] = 0; return bitpos; }
    for (size_t i = 0; i < n; i++) {
        uint64_t v = 0;
        for (uint32_t got = 0; got < width;) {
            uint64_t byte = bitpos >> 3;
            uint32_t bit_in_byte = (uint32_t)(bitpos & 7);
            uint32_t room = 8 - bit_in_byte;
            uint32_t take = (width - got) < room ? (width - got) : room;
            uint8_t chunk = (uint8_t)((buf[byte] >> (room - take)) & ((1u << take) - 1));
            v = (v << take) | chunk;
            bitpos += take;
            got += take;
        }
        // sign-extend
        if (v & ((uint64_t)1 << (width - 1))) v |= ~(((uint64_t)1 << width) - 1);
        res[i] = (int64_t)v;
    }
    return bitpos;
}

uint64_t nat_pack_signed(uint8_t* out, uint64_t bitpos,
                         const int64_t* vals, size_t n, uint32_t width) {
    uint64_t mask = width >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << width) - 1);
    for (size_t i = 0; i < n; i++) {
        or_bits(out, bitpos, (uint64_t)vals[i] & mask, width);
        bitpos += width;
    }
    return bitpos;
}

// Append a bit blob: `nbits` bits of src (starting at src bit 0, MSB-first)
// appended at out:bitpos.  Replaces the reference's BitRecorder playback
// (reference: src/encode.rs:2332-2333).
uint64_t nat_append_bits(uint8_t* out, uint64_t bitpos,
                         const uint8_t* src, uint64_t nbits) {
    uint64_t full = nbits >> 3;
    uint32_t rem = (uint32_t)(nbits & 7);
    if ((bitpos & 7) == 0) {
        memcpy(out + (bitpos >> 3), src, full);
        bitpos += full << 3;
    } else {
        for (uint64_t i = 0; i < full; i++) {
            or_bits(out, bitpos, src[i], 8);
            bitpos += 8;
        }
    }
    if (rem) {
        or_bits(out, bitpos, src[full] >> (8 - rem), rem);
        bitpos += rem;
    }
    return bitpos;
}

// ---------------------------------------------------------------------------
// Inverse LPC recurrence (host decode path).
// x[n] += (sum_j q[j] * x[n-1-j]) >> shift, int64 accumulator
// (reference: src/decode.rs:1738-1752).  Works for fixed predictors too by
// passing the fixed coefficient rows.
// ---------------------------------------------------------------------------

void nat_lpc_predict64(int64_t* x, size_t n, const int32_t* q,
                       uint32_t order, uint32_t shift) {
    for (size_t i = order; i < n; i++) {
        int64_t acc = 0;
        for (uint32_t j = 0; j < order; j++)
            acc += (int64_t)q[j] * x[i - 1 - j];
        x[i] += acc >> shift;
    }
}

void nat_lpc_predict32(int32_t* x, size_t n, const int32_t* q,
                       uint32_t order, uint32_t shift) {
    for (size_t i = order; i < n; i++) {
        int64_t acc = 0;
        for (uint32_t j = 0; j < order; j++)
            acc += (int64_t)q[j] * x[i - 1 - j];
        x[i] += (int32_t)(acc >> shift);
    }
}

// Compute LPC residuals r[n] = x[n] - ((sum q[j]*x[n-1-j]) >> shift)
// (encoder hot loop; reference: src/encode.rs:3174-3203).  Returns 1 on
// i32 overflow of any residual (caller maps to ResidualOverflow).
int32_t nat_lpc_residuals(const int64_t* x, size_t n, const int32_t* q,
                          uint32_t order, uint32_t shift, int32_t* res) {
    for (size_t i = order; i < n; i++) {
        int64_t acc = 0;
        for (uint32_t j = 0; j < order; j++)
            acc += (int64_t)q[j] * x[i - 1 - j];
        int64_t r = x[i] - (acc >> shift);
        if (r < INT32_MIN || r > INT32_MAX) return 1;
        res[i - order] = (int32_t)r;
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-batch frame assembler.
//
// Converts device-produced encoding plans (see ops/encode_batch.py) into
// complete serialized FLAC frames — header, subframes, Rice partitions,
// CRC-8/16 — with one call per batch and a thread pool over frames.  This
// is the host half of the TPU pipeline: the device plans thousands of
// frames at once; this code turns plans into bits at memory speed.
// ---------------------------------------------------------------------------

#include <pthread.h>
#include <sched.h>

#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>
#include <algorithm>
#include <type_traits>

namespace {

struct BitSink {
    uint8_t* buf;      // pre-zeroed
    uint64_t bitpos = 0;

    inline void put(uint64_t value, uint32_t nbits) {
        or_bits(buf, bitpos, value, nbits);
        bitpos += nbits;
    }
    inline void put_signed(int64_t v, uint32_t nbits) {
        put((uint64_t)v & ((nbits >= 64) ? ~0ull : (((uint64_t)1 << nbits) - 1)), nbits);
    }
    inline void put_unary(uint32_t q) {
        bitpos += q;          // zeros implicit
        put(1, 1);
    }
    inline void align() { bitpos = (bitpos + 7) & ~7ull; }
};

// 4-bit block size code (reference: src/stream.rs:437-566); returns code,
// sets extra/extra_bits for the uncommon escapes.
static uint32_t block_size_code(uint32_t n, uint32_t* extra, uint32_t* extra_bits) {
    *extra_bits = 0;
    switch (n) {
        case 192: return 1;
        case 576: return 2;   case 1152: return 3;
        case 2304: return 4;  case 4608: return 5;
        case 256: return 8;   case 512: return 9;
        case 1024: return 10; case 2048: return 11;
        case 4096: return 12; case 8192: return 13;
        case 16384: return 14; case 32768: return 15;
    }
    if (n <= 256) { *extra = n - 1; *extra_bits = 8; return 6; }
    *extra = n - 1; *extra_bits = 16; return 7;
}

static uint32_t sample_rate_code(uint32_t r, uint32_t* extra, uint32_t* extra_bits) {
    *extra_bits = 0;
    switch (r) {
        case 88200: return 1;  case 176400: return 2;
        case 192000: return 3; case 8000: return 4;
        case 16000: return 5;  case 22050: return 6;
        case 24000: return 7;  case 32000: return 8;
        case 44100: return 9;  case 48000: return 10;
        case 96000: return 11;
    }
    if (r % 1000 == 0 && r / 1000 < 255) { *extra = r / 1000; *extra_bits = 8; return 12; }
    if (r % 10 == 0 && r / 10 < 65535)   { *extra = r / 10;   *extra_bits = 16; return 14; }
    if (r < 65535)                        { *extra = r;        *extra_bits = 16; return 13; }
    return 0;  // streaminfo escape
}

static uint32_t bps_code(uint32_t bps) {
    switch (bps) {
        case 8: return 1;  case 12: return 2; case 16: return 4;
        case 20: return 5; case 24: return 6; case 32: return 7;
    }
    return 0;
}

// UTF-8-style frame number varint (reference: src/stream.rs:1266-1326)
static void put_frame_number(BitSink& w, uint64_t num) {
    if (num < 0x80) { w.put(num, 8); return; }
    static const struct { uint64_t limit; uint32_t bytes; } tiers[] = {
        {1ull << 11, 2}, {1ull << 16, 3}, {1ull << 21, 4},
        {1ull << 26, 5}, {1ull << 31, 6}, {1ull << 36, 7},
    };
    for (auto& t : tiers) {
        if (num < t.limit) {
            uint32_t nbytes = t.bytes;
            uint32_t top_bits = 7 - nbytes;
            uint32_t lead = (0xFFu >> (8 - nbytes)) << (8 - nbytes);
            w.put(lead | ((num >> (6 * (nbytes - 1))) & ((1u << top_bits) - 1)), 8);
            for (int i = (int)nbytes - 2; i >= 0; i--)
                w.put(0x80u | ((num >> (6 * i)) & 0x3F), 8);
            return;
        }
    }
}

// Copy nbits from src (starting at srcpos) into dst at dstpos, OR-ing into
// place (dst pre-zeroed past dstpos).  Used to splice device-packed
// residual blobs between host-written subframe headers.
static void copy_bits(uint8_t* dst, uint64_t dstpos,
                      const uint8_t* src, uint64_t srcpos, uint64_t nbits) {
    // fast path: 32 bits per iteration through unaligned 64-bit windows
    // (both buffers have >= 8 bytes of slack past their payload)
    while (nbits >= 32) {
        uint64_t w;
        memcpy(&w, src + (srcpos >> 3), 8);
        w = __builtin_bswap64(w);
        uint32_t soff = (uint32_t)(srcpos & 7);
        uint32_t v = (uint32_t)(w >> (32 - soff));
        uint32_t doff = (uint32_t)(dstpos & 7);
        uint64_t pattern = ((uint64_t)v) << (32 - doff);
        uint64_t cur;
        uint8_t* dp = dst + (dstpos >> 3);
        memcpy(&cur, dp, 8);
        cur |= __builtin_bswap64(pattern);
        memcpy(dp, &cur, 8);
        srcpos += 32;
        dstpos += 32;
        nbits -= 32;
    }
    // byte-at-a-time: read 8 source bits starting at srcpos, emit at dstpos
    while (nbits >= 8) {
        uint64_t sb = srcpos >> 3;
        uint32_t off = (uint32_t)(srcpos & 7);
        uint8_t v = off == 0 ? src[sb]
                             : (uint8_t)((src[sb] << off) | (src[sb + 1] >> (8 - off)));
        or_bits(dst, dstpos, v, 8);
        dstpos += 8;
        srcpos += 8;
        nbits -= 8;
    }
    if (nbits) {
        uint64_t sb = srcpos >> 3;
        uint32_t off = (uint32_t)(srcpos & 7);
        uint16_t win = (uint16_t)((src[sb] << 8) | src[sb + 1]);
        uint8_t v = (uint8_t)((win >> (8 - off)) & 0xFF);
        v >>= (8 - nbits);
        or_bits(dst, dstpos, v, (uint32_t)nbits);
    }
}

struct SlotPlan {
    const uint8_t *sub_type, *wasted, *order, *precision, *po, *rice_bits;
    const int8_t* shift;
    const int32_t *qcoeffs, *params, *residuals, *channels;
    const uint8_t* kinds;
};

}  // namespace

extern "C" {

int64_t nat_assemble_batch(
    uint32_t B, uint32_t N, uint32_t slots, uint32_t bps_base,
    uint32_t sample_rate, uint64_t first_frame_number,
    const uint8_t* assignment,
    const uint8_t* sub_type, const uint8_t* wasted, const uint8_t* order_,
    const uint8_t* precision, const int8_t* shift, const int32_t* qcoeffs,
    const uint8_t* po, const uint8_t* rice_bits_, const uint8_t* kinds,
    const int32_t* params, const int32_t* residuals, const int32_t* channels,
    uint8_t* out, uint32_t max_bytes, uint32_t* lengths, uint32_t nthreads,
    // optional device-packed residual blobs (byte stream, MSB-first);
    // blob (s, b) occupies bits [blob_start_bits[s*B+b],
    // blob_start_bits[..]+blob_bits[..]).  NULL -> pack from residuals.
    const uint8_t* blobs, const uint64_t* blob_start_bits,
    const uint64_t* blob_bits,
    // per-subframe sample stride in `channels`: N for full channel data,
    // or a warm-up-only stride (e.g. 32) when blobs carry the residual
    // sections.  A verbatim subframe needs all N samples; in warm-up-only
    // mode its frame is skipped (lengths[b] = 0) for the caller to
    // assemble through the full host path.
    uint32_t chan_stride) {
    if (!tables_ready) init_tables();

    auto do_frame = [&](uint32_t b) {
        uint8_t* frame_buf = out + (uint64_t)b * max_bytes;
        BitSink w{frame_buf};

        if (first_frame_number + b > 0xFFFFFFFFFull) {
            // beyond the 36-bit varint: skip so the caller's host path
            // raises the precise ExcessiveFrameNumber error
            lengths[b] = 0;
            return;
        }

        uint32_t a = assignment[b];
        // header
        w.put(0b111111111111100, 15);
        w.put(0, 1);  // fixed block size strategy
        uint32_t bs_extra = 0, bs_extra_bits = 0, sr_extra = 0, sr_extra_bits = 0;
        uint32_t bsc = block_size_code(N, &bs_extra, &bs_extra_bits);
        uint32_t src = sample_rate_code(sample_rate, &sr_extra, &sr_extra_bits);
        w.put(bsc, 4);
        w.put(src, 4);
        w.put(a, 4);
        w.put(bps_code(bps_base), 3);
        w.put(0, 1);
        put_frame_number(w, first_frame_number + b);
        if (bs_extra_bits) w.put(bs_extra, bs_extra_bits);
        if (sr_extra_bits) w.put(sr_extra, sr_extra_bits);
        // header CRC-8
        uint64_t hdr_bytes = w.bitpos >> 3;
        w.put(nat_crc8(frame_buf, hdr_bytes, 0), 8);

        int side_slot = (a == 0b1000 || a == 0b1010) ? 1 : (a == 0b1001 ? 0 : -1);

        for (uint32_t s = 0; s < slots; s++) {
            uint64_t sb = (uint64_t)s * B + b;
            uint32_t bps = bps_base + (((int)s == side_slot) ? 1 : 0);
            uint32_t typ = sub_type[sb];
            uint32_t wb = wasted[sb];
            uint32_t eff = bps - wb;
            if (typ == 1 && chan_stride < N) {  // verbatim needs all samples
                lengths[b] = 0;
                return;
            }
            const int32_t* xs = channels + ((uint64_t)s * B + b) * chan_stride;

            // subframe header
            w.put(0, 1);
            if (typ == 0) w.put(0b000000, 6);          // constant
            else if (typ == 1) w.put(0b000001, 6);     // verbatim
            else if (typ == 2) w.put(0b001000 | order_[sb], 6);
            else w.put(0b100000 | (order_[sb] - 1), 6);
            if (typ == 0 || wb == 0) {
                w.put(0, 1);
            } else {
                w.put(1, 1);
                w.put_unary(wb - 1);
            }

            if (typ == 0) {                  // constant (all-zero channels)
                w.put_signed(xs[0], bps);
                continue;
            }
            if (typ == 1) {                  // verbatim
                for (uint32_t i = 0; i < N; i++) w.put_signed(xs[i], eff);
                continue;
            }

            uint32_t ord = order_[sb];
            for (uint32_t i = 0; i < ord; i++) w.put_signed(xs[i], eff);
            if (typ == 3) {                  // LPC params
                w.put(precision[sb] - 1, 4);
                w.put_signed(shift[sb], 5);
                const int32_t* q = qcoeffs + sb * 32;
                for (uint32_t i = 0; i < ord; i++)
                    w.put_signed(q[i], precision[sb]);
            }

            // residual section: splice the device-packed blob if present
            if (blobs != nullptr) {
                copy_bits(frame_buf, w.bitpos, blobs, blob_start_bits[sb],
                          blob_bits[sb]);
                w.bitpos += blob_bits[sb];
                continue;
            }
            uint32_t rb = rice_bits_[sb];
            uint32_t p_order = po[sb];
            uint32_t count = 1u << p_order;
            uint32_t part_len = N / count;
            uint32_t escape_code = (1u << rb) - 1;
            const uint8_t* k_arr = kinds + sb * 64;
            const int32_t* p_arr = params + sb * 64;
            const int32_t* res = residuals + ((uint64_t)s * B + b) * N + ord;

            w.put(rb == 4 ? 0 : 1, 2);
            w.put(p_order, 4);
            uint32_t pos = 0;
            for (uint32_t p = 0; p < count; p++) {
                uint32_t n = (p == 0) ? part_len - ord : part_len;
                uint32_t kind = k_arr[p];
                uint32_t param = (uint32_t)p_arr[p];
                if (kind == 0) {             // rice
                    w.put(param, rb);
                    w.bitpos = nat_pack_rice(frame_buf, w.bitpos, res + pos, n, param);
                } else if (kind == 1) {      // escape
                    w.put(escape_code, rb);
                    w.put(param, 5);
                    for (uint32_t i = 0; i < n; i++)
                        w.put_signed(res[pos + i], param);
                } else {                     // constant
                    w.put(escape_code, rb);
                    w.put(0, 5);
                }
                pos += n;
            }
        }

        w.align();
        uint64_t body = w.bitpos >> 3;
        uint32_t crc = nat_crc16(frame_buf, body, 0);
        w.put(crc, 16);
        lengths[b] = (uint32_t)(w.bitpos >> 3);
    };

    if (nthreads <= 1 || B < 4) {
        for (uint32_t b = 0; b < B; b++) do_frame(b);
    } else {
        uint32_t nt = std::min(nthreads, B);
        std::vector<std::thread> pool;
        for (uint32_t t = 0; t < nt; t++) {
            pool.emplace_back([&, t]() {
                for (uint32_t b = t; b < B; b += nt) do_frame(b);
            });
        }
        for (auto& th : pool) th.join();
    }

    int64_t total = 0;
    for (uint32_t b = 0; b < B; b++) total += lengths[b];
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Packed-frame assembler: the device serialized each frame's complete body
// (subframes + residuals, byte-aligned) into a fixed-size slot and reduced
// its CRC-16 to a position-weighted GF(2) inner product (ops/framepack.py).
// Host work per frame: ~10 header bytes + CRC-8, one memcpy, and an
// O(log L) carry-less multiply to finish the CRC-16.
// ---------------------------------------------------------------------------

// carry-less multiply mod the FLAC CRC-16 polynomial x^16+x^15+x^2+1
static uint32_t gf16_mulmod(uint32_t a, uint32_t b) {
    uint64_t r = 0;
    for (int i = 0; i < 16; i++)
        if ((b >> i) & 1) r ^= (uint64_t)a << i;
    for (int i = 30; i >= 16; i--)
        if ((r >> i) & 1) r ^= (uint64_t)0x18005u << (i - 16);
    return (uint32_t)r;
}

// x^(8*2^k) mod P, filled on first use (k < 40 covers any frame length)
static uint32_t X8POW2[40];
static bool x8pow_ready = false;
static void init_x8pow() {
    uint32_t v = 0x100;  // x^8
    for (int k = 0; k < 40; k++) { X8POW2[k] = v; v = gf16_mulmod(v, v); }
    x8pow_ready = true;
}

static uint32_t gf16_xpow8(uint64_t nbytes) {  // x^(8*nbytes) mod P
    if (!x8pow_ready) init_x8pow();
    uint32_t r = 1;
    for (int k = 0; nbytes; k++, nbytes >>= 1)
        if (nbytes & 1) r = gf16_mulmod(r, X8POW2[k]);
    return r;
}

extern "C" {

// Splice device-packed frame bodies into finished FLAC frames.
// blob: B slots of slot_bytes each (MSB-first byte stream, body at byte 0).
// A frame with fallback[b] set (verbatim subframe / budget overflow) gets
// lengths[b] = 0 for the caller's host re-encode path.
int64_t nat_assemble_packed(
    uint32_t B, uint32_t N, uint32_t bps_base, uint32_t sample_rate,
    uint64_t first_frame_number, const uint8_t* assignment,
    const uint8_t* blob, uint64_t slot_bytes,
    const uint64_t* body_bits, const uint16_t* inner_crc,
    const uint8_t* fallback,
    uint8_t* out, uint32_t max_bytes, uint32_t* lengths, uint32_t nthreads) {
    if (!tables_ready) init_tables();
    if (!x8pow_ready) init_x8pow();

    auto do_frame = [&](uint32_t b) {
        if (fallback[b] || first_frame_number + b > 0xFFFFFFFFFull) {
            lengths[b] = 0;
            return;
        }
        uint8_t* frame_buf = out + (uint64_t)b * max_bytes;
        BitSink w{frame_buf};
        w.put(0b111111111111100, 15);
        w.put(0, 1);
        uint32_t bs_extra = 0, bs_extra_bits = 0, sr_extra = 0, sr_extra_bits = 0;
        uint32_t bsc = block_size_code(N, &bs_extra, &bs_extra_bits);
        uint32_t src = sample_rate_code(sample_rate, &sr_extra, &sr_extra_bits);
        w.put(bsc, 4);
        w.put(src, 4);
        w.put(assignment[b], 4);
        w.put(bps_code(bps_base), 3);
        w.put(0, 1);
        put_frame_number(w, first_frame_number + b);
        if (bs_extra_bits) w.put(bs_extra, bs_extra_bits);
        if (sr_extra_bits) w.put(sr_extra, sr_extra_bits);
        uint64_t hdr_bytes = w.bitpos >> 3;
        w.put(nat_crc8(frame_buf, hdr_bytes, 0), 8);
        hdr_bytes += 1;

        uint64_t body_bytes = (body_bits[b] + 7) >> 3;
        if (hdr_bytes + body_bytes + 2 > max_bytes) { lengths[b] = 0; return; }
        {
            // the device emits native-endian uint32 words; MSB-first bit
            // order means big-endian bytes, so the byte swap is fused
            // into this copy (a separate numpy byteswap pass over the
            // whole blob measured ~25% of packed assembly)
            const uint8_t* src = blob + (uint64_t)b * slot_bytes;
            uint8_t* dst = frame_buf + hdr_bytes;
            uint64_t nwords = body_bytes >> 2;
            for (uint64_t i = 0; i < nwords; i++) {
                uint32_t w32;
                memcpy(&w32, src + i * 4, 4);
                w32 = __builtin_bswap32(w32);
                memcpy(dst + i * 4, &w32, 4);
            }
            if (body_bytes & 3) {
                uint32_t w32;
                memcpy(&w32, src + nwords * 4, 4);  // slot is padded
                w32 = __builtin_bswap32(w32);
                uint8_t tail[4];
                memcpy(tail, &w32, 4);
                memcpy(dst + nwords * 4, tail, body_bytes & 3);
            }
        }

        // CRC-16(header || body) = CRC(header)*x^(8*Lb) + inner*x^(8*Lb+15)
        uint32_t xl = gf16_xpow8(body_bytes);
        uint32_t crc_h = crc16_table(frame_buf, hdr_bytes, 0);
        uint32_t crc = gf16_mulmod(crc_h, xl)
                     ^ gf16_mulmod(inner_crc[b], gf16_mulmod(xl, 0x8000));
        uint64_t end = hdr_bytes + body_bytes;
        frame_buf[end] = (uint8_t)(crc >> 8);
        frame_buf[end + 1] = (uint8_t)(crc & 0xFF);
        lengths[b] = (uint32_t)(end + 2);
    };

    if (nthreads <= 1 || B < 4) {
        for (uint32_t b = 0; b < B; b++) do_frame(b);
    } else {
        uint32_t nt = std::min(nthreads, B);
        std::vector<std::thread> pool;
        for (uint32_t t = 0; t < nt; t++) {
            pool.emplace_back([&, t]() {
                for (uint32_t b = t; b < B; b += nt) do_frame(b);
            });
        }
        for (auto& th : pool) th.join();
    }

    int64_t total = 0;
    for (uint32_t b = 0; b < B; b++) total += lengths[b];
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native frame decoder.
//
// Full FLAC frame decode loop in C++ (reference decode path:
// src/decode.rs:1311-1856): header parse + CRC-8, subframe decode (Rice
// runs, LPC/fixed recurrence), inverse stereo decorrelation, CRC-16, and
// interleave.  The Python Decoder delegates whole batches of frames here
// when the stream is buffered in memory; device-side decode
// (ops/predict.py) covers the batched TPU path.
// ---------------------------------------------------------------------------

namespace {

// Cached-window bit reader for the frame-decode hot path.  Keeps up to 64
// unconsumed bits left-aligned in `window` (bits below `avail` are zero),
// so field extraction is a shift instead of a per-byte loop; the whole
// Rice unary+LSB code usually rides a single window
// (reference hot loops: src/decode.rs:1800-1856).
struct FastBits {
    const uint8_t* buf;
    uint64_t nbytes;
    uint64_t limit;      // total bits
    uint64_t next_byte;  // next byte index to feed into the window
    uint64_t window;     // unconsumed bits, MSB-first, left-aligned
    uint32_t avail;      // number of valid bits in window

    void init(const uint8_t* b, uint64_t nb, uint64_t bitpos) {
        buf = b;
        nbytes = nb;
        limit = nb * 8;
        set_pos(bitpos);
    }
    inline uint64_t pos() const { return next_byte * 8 - avail; }
    void set_pos(uint64_t bitpos) {
        next_byte = bitpos >> 3;
        window = 0;
        avail = 0;
        uint32_t sub = (uint32_t)(bitpos & 7);
        if (sub) {
            refill();
            consume(sub <= avail ? sub : avail);
        }
    }
    inline bool fits(uint64_t n) const { return pos() + n <= limit; }
    inline void consume(uint32_t n) {
        // n can reach 64 when get_unary eats a whole window (a zero run
        // of >= 64 bits); `window <<= 64` is UB and on x86 leaves window
        // UNCHANGED, planting stale bits below `avail` that the next
        // refill ORs into fresh data (found by randomized fuzzing: one
        // corrupted Rice LSB per ~2^17 symbols on quotient-123 streams)
        window = n >= 64 ? 0 : window << n;
        avail -= n;
    }
    inline void refill() {
        if (avail > 56) return;
        if (next_byte + 8 <= nbytes) {
            uint64_t w;
            memcpy(&w, buf + next_byte, 8);
            w = __builtin_bswap64(w);
            uint32_t addbytes = (64 - avail) >> 3;
            uint32_t newavail = avail + addbytes * 8;
            window |= w >> avail;
            if (newavail < 64)  // zero the partial-byte pollution below
                window &= ~((~0ull) >> newavail);
            next_byte += addbytes;
            avail = newavail;
        } else {
            while (avail <= 56 && next_byte < nbytes) {
                window |= (uint64_t)buf[next_byte++] << (56 - avail);
                avail += 8;
            }
        }
    }
    inline uint32_t get(uint32_t nbits) {  // 1..32; caller checked fits()
        refill();
        uint32_t v = (uint32_t)(window >> (64 - nbits));
        consume(nbits);
        return v;
    }
    inline int64_t get_signed(uint32_t nbits) {  // 1..57
        refill();
        int64_t v = ((int64_t)window) >> (64 - nbits);  // arithmetic: sign-extends
        consume(nbits);
        return v;
    }
    inline uint32_t get_unary() {
        uint32_t q = 0;
        for (;;) {
            refill();
            if (avail == 0) return q;  // EOF; callers check fits()
            uint32_t lz = window ? (uint32_t)__builtin_clzll(window) : 64;
            if (lz < avail) {
                consume(lz + 1);
                return q + lz;
            }
            q += avail;
            consume(avail);
        }
    }
    inline void align() {
        uint32_t r = (uint32_t)(pos() & 7);
        if (r) consume((8 - r) <= avail ? (8 - r) : avail);
    }
};

// Bulk Rice decode with the bit window held in a register across symbols:
// the per-symbol dependency chain is shift+clz+add, with one 8-byte reload
// every ~3 codes.  Decodes up to m residuals; returns the count actually
// decoded (stops near the buffer end or on a >56-bit code — the caller
// finishes with the checked slow path).  `bitpos` is advanced in place.
// KT >= 0 bakes the Rice parameter into the instantiation so the
// per-symbol shifts and masks fold to constants (~18% measured); KT < 0
// is the runtime-k fallback for rare large parameters.
template <typename ST, int KT = -1>
static inline uint32_t rice_bulk(const uint8_t* buf, uint64_t nbytes,
                                 uint64_t& bitpos, ST* out, uint32_t m,
                                 uint32_t k_rt) {
    const uint32_t k = KT >= 0 ? (uint32_t)KT : k_rt;
    if (nbytes < 8) return 0;
    const uint8_t* const endp = buf + nbytes - 8;   // last valid 8-byte load
    const uint8_t* ptr = buf + (bitpos >> 3);
    uint32_t off = (uint32_t)(bitpos & 7);          // consumed bits in window
    const uint64_t mask = ((uint64_t)1 << k) - 1;
    uint64_t w;
    uint32_t i = 0;
    if (ptr > endp) return 0;
    memcpy(&w, ptr, 8);
    w = __builtin_bswap64(w);
    while (i < m) {
        uint64_t cur = w << off;                    // valid bits: 64 - off
        uint32_t lz = cur ? (uint32_t)__builtin_clzll(cur) : 64;
        uint32_t len = lz + 1 + k;
        if (len + off >= 64) {
            ptr += off >> 3;
            off &= 7;
            if (ptr > endp) break;
            memcpy(&w, ptr, 8);
            w = __builtin_bswap64(w);
            cur = w << off;
            lz = cur ? (uint32_t)__builtin_clzll(cur) : 64;
            len = lz + 1 + k;
            if (len + off >= 64) break;             // over-long: slow path
        }
        uint64_t u = ((uint64_t)lz << k) | ((cur >> (63 - lz - k)) & mask);
        // branchless zigzag: (u>>1) ^ -(u&1)
        out[i++] = (ST)((int64_t)(u >> 1) ^ -(int64_t)(u & 1));
        off += len;
    }
    bitpos = (((uint64_t)(ptr - buf)) << 3) + off;
    return i;
}

// constant-k dispatch for the common Rice parameters (4-bit method 0-14,
// 5-bit rice2 up to 17 in practice); larger parameters take runtime k
template <typename ST>
static inline uint32_t rice_bulk_k(const uint8_t* buf, uint64_t nbytes,
                                   uint64_t& bitpos, ST* out, uint32_t m,
                                   uint32_t k) {
    switch (k) {
        case 0: return rice_bulk<ST, 0>(buf, nbytes, bitpos, out, m, k);
        case 1: return rice_bulk<ST, 1>(buf, nbytes, bitpos, out, m, k);
        case 2: return rice_bulk<ST, 2>(buf, nbytes, bitpos, out, m, k);
        case 3: return rice_bulk<ST, 3>(buf, nbytes, bitpos, out, m, k);
        case 4: return rice_bulk<ST, 4>(buf, nbytes, bitpos, out, m, k);
        case 5: return rice_bulk<ST, 5>(buf, nbytes, bitpos, out, m, k);
        case 6: return rice_bulk<ST, 6>(buf, nbytes, bitpos, out, m, k);
        case 7: return rice_bulk<ST, 7>(buf, nbytes, bitpos, out, m, k);
        case 8: return rice_bulk<ST, 8>(buf, nbytes, bitpos, out, m, k);
        case 9: return rice_bulk<ST, 9>(buf, nbytes, bitpos, out, m, k);
        case 10: return rice_bulk<ST, 10>(buf, nbytes, bitpos, out, m, k);
        case 11: return rice_bulk<ST, 11>(buf, nbytes, bitpos, out, m, k);
        case 12: return rice_bulk<ST, 12>(buf, nbytes, bitpos, out, m, k);
        case 13: return rice_bulk<ST, 13>(buf, nbytes, bitpos, out, m, k);
        case 14: return rice_bulk<ST, 14>(buf, nbytes, bitpos, out, m, k);
        case 15: return rice_bulk<ST, 15>(buf, nbytes, bitpos, out, m, k);
        case 16: return rice_bulk<ST, 16>(buf, nbytes, bitpos, out, m, k);
        case 17: return rice_bulk<ST, 17>(buf, nbytes, bitpos, out, m, k);
        default: return rice_bulk<ST>(buf, nbytes, bitpos, out, m, k);
    }
}

// Four Rice partitions from four INDEPENDENT bit cursors decoded in
// lockstep by one thread.  The single-cursor loop is bound by its
// ~13-cycle per-symbol dependency chain (advance bitpos -> reload the
// 64-bit window -> clz); four cursors give the out-of-order core four
// overlapping chains (measured ~1.5x over four sequential passes).  Each
// lane always reloads its window at the current bit position — one
// unaligned 8-byte load per symbol — which keeps the loop body branch-
// free except for a single expect-false guard per lane.  (Fusing a
// deferred stereo-predict strand into this loop was built and measured
// at BOTH per-symbol granularity — register spill, 0.90x — and as
// alternating ~190/280-uop sub-blocks — the ~200-entry reservation
// station never holds both, 1.06x vs the unfused 1.08x — so the pump
// keeps prediction inline at frame completion.)  Returns when
// ANY lane completes its m[] symbols or hits an over-long/EOF window;
// ndone[] counts symbols decoded and flags[] marks lanes that need the
// caller's checked re-entry path (over-long/EOF), exactly mirroring
// rice_bulk's stop contract.  Codes longer than 57 bits always stop a
// lane (window validity), like the single-cursor kernel.
template <typename ST>
static void rice_bulk_4w(const uint8_t* buf, uint64_t nbytes,
                         uint64_t* bp, ST** out, const uint32_t* m,
                         const uint32_t* k, uint32_t* ndone,
                         uint8_t* flags) {
    flags[0] = flags[1] = flags[2] = flags[3] = 0;
    ndone[0] = ndone[1] = ndone[2] = ndone[3] = 0;
    if (nbytes < 8) {
        flags[0] = flags[1] = flags[2] = flags[3] = 1;
        return;
    }
    const uint64_t limit = ((nbytes - 8) << 3) | 7;  // max valid load bitpos
    uint64_t p0 = bp[0], p1 = bp[1], p2 = bp[2], p3 = bp[3];
    if (p0 > limit || p1 > limit || p2 > limit || p3 > limit) {
        flags[0] = p0 > limit; flags[1] = p1 > limit;
        flags[2] = p2 > limit; flags[3] = p3 > limit;
        return;
    }
    const uint32_t k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3];
    const uint64_t M0 = ((uint64_t)1 << k0) - 1, M1 = ((uint64_t)1 << k1) - 1,
                   M2 = ((uint64_t)1 << k2) - 1, M3 = ((uint64_t)1 << k3) - 1;
    ST *o0 = out[0], *o1 = out[1], *o2 = out[2], *o3 = out[3];
    const uint32_t m0 = m[0], m1 = m[1], m2 = m[2], m3 = m[3];
    uint32_t i0 = 0, i1 = 0, i2 = 0, i3 = 0;
    // Every lane runs to ITS OWN end (partition complete or over-long):
    // exiting when the first lane finishes was measured to shrink rounds
    // to min-of-four-phases (~13 symbols) and the per-round pump overhead
    // ate the kernel's gain.  Structure: an unguarded lockstep loop over
    // chunk = min(remaining) symbols (after the first pump round the four
    // lanes start partitions together, so the chunk is nearly the whole
    // partition), then a guarded loop for the stragglers.
    uint32_t live = (uint32_t(m0 > 0)) | (uint32_t(m1 > 0) << 1)
                  | (uint32_t(m2 > 0) << 2) | (uint32_t(m3 > 0) << 3);
#define FLACNAT_4W_STEP(p, kq, Mq, oq, iq, mq, lane)                       \
        {                                                                  \
            uint64_t w;                                                    \
            memcpy(&w, buf + (p >> 3), 8);                                 \
            w = __builtin_bswap64(w) << (p & 7);                           \
            uint32_t lz = (uint32_t)__builtin_clzll(w | 1);                \
            uint32_t len = lz + 1 + kq;                                    \
            uint64_t np = p + len;                                         \
            if (__builtin_expect((len + (p & 7) > 64) | (np > limit), 0)) {\
                flags[lane] = 1;                                           \
                live &= ~(1u << lane);                                     \
                break;                                                     \
            }                                                              \
            uint64_t u = ((uint64_t)lz << kq) | ((w >> (64 - len)) & Mq);  \
            oq[iq] = (ST)((int64_t)(u >> 1) ^ -(int64_t)(u & 1));          \
            iq++;                                                          \
            p = np;                                                        \
        }
    while (live == 0xF) {
        uint32_t chunk = m0 - i0;
        if (m1 - i1 < chunk) chunk = m1 - i1;
        if (m2 - i2 < chunk) chunk = m2 - i2;
        if (m3 - i3 < chunk) chunk = m3 - i3;
        if (!chunk) break;
        for (uint32_t t = 0; t < chunk; t++) {
            FLACNAT_4W_STEP(p0, k0, M0, o0, i0, m0, 0)
            FLACNAT_4W_STEP(p1, k1, M1, o1, i1, m1, 1)
            FLACNAT_4W_STEP(p2, k2, M2, o2, i2, m2, 2)
            FLACNAT_4W_STEP(p3, k3, M3, o3, i3, m3, 3)
        }
        live &= ~((uint32_t(i0 >= m0)) | (uint32_t(i1 >= m1) << 1)
                  | (uint32_t(i2 >= m2) << 2) | (uint32_t(i3 >= m3) << 3));
    }
#undef FLACNAT_4W_STEP
    // stragglers: lanes still live after the lockstep phase finish on the
    // single-cursor bulk loop (same stop contract)
    uint64_t ps[4] = {p0, p1, p2, p3};
    uint32_t is[4] = {i0, i1, i2, i3};
    for (int s = 0; s < 4; s++) {
        if ((live >> s) & 1 && is[s] < m[s]) {
            uint32_t got = rice_bulk_k(buf, nbytes, ps[s], out[s] + is[s],
                                       m[s] - is[s], k[s]);
            is[s] += got;
            if (is[s] < m[s]) flags[s] = 1;
        }
        bp[s] = ps[s];
        ndone[s] = is[s];
    }
}

// Order-specialized inverse predictor: x[i] += (sum q[j]*x[i-1-j]) >> shift
// (reference: src/decode.rs:1738-1752).  The recent-history window rides a
// register shift-chain so the loop-carried dependency is mul+add+shift, not
// a store-to-load round trip; ST is int32 for bps <= 24 streams (half the
// L1 traffic) and int64 for the wide paths.
template <int ORDER, typename ST>
static void predict_fix(ST* __restrict x, uint32_t n,
                        const int64_t* __restrict qc, uint32_t shift) {
    // software-pipelined: the j>=1 tap sum for step i+1 only needs
    // x[i-1..], so it overlaps the critical q0*x[i-1] chain of step i
    int64_t q0 = qc[0];
    int64_t q[ORDER > 1 ? ORDER : 2];
    for (int j = 1; j < ORDER; j++) q[j] = qc[j];
    int64_t rest = 0;
    for (int j = 1; j < ORDER; j++) rest += q[j] * (int64_t)x[ORDER - 1 - j];
    for (uint32_t i = ORDER; i < n; i++) {
        int64_t xm1 = x[i - 1];
        int64_t v = (int64_t)x[i] + ((q0 * xm1 + rest) >> shift);
        int64_t r = ORDER > 1 ? q[1] * xm1 : 0;
        for (int j = 2; j < ORDER; j++) r += q[j] * (int64_t)x[i - j];
        rest = r;
        x[i] = (ST)v;
    }
}

template <typename ST>
static void predict_any(ST* x, uint32_t n, const int64_t* q,
                        uint32_t order, uint32_t shift) {
    switch (order) {
        case 0: return;
        case 1: return predict_fix<1>(x, n, q, shift);
        case 2: return predict_fix<2>(x, n, q, shift);
        case 3: return predict_fix<3>(x, n, q, shift);
        case 4: return predict_fix<4>(x, n, q, shift);
        case 5: return predict_fix<5>(x, n, q, shift);
        case 6: return predict_fix<6>(x, n, q, shift);
        case 7: return predict_fix<7>(x, n, q, shift);
        case 8: return predict_fix<8>(x, n, q, shift);
        case 9: return predict_fix<9>(x, n, q, shift);
        case 10: return predict_fix<10>(x, n, q, shift);
        case 11: return predict_fix<11>(x, n, q, shift);
        case 12: return predict_fix<12>(x, n, q, shift);
        case 13: return predict_fix<13>(x, n, q, shift);
        case 14: return predict_fix<14>(x, n, q, shift);
        case 15: return predict_fix<15>(x, n, q, shift);
        case 16: return predict_fix<16>(x, n, q, shift);
        default:
            for (uint32_t i = order; i < n; i++) {
                int64_t acc = 0;
                for (uint32_t j = 0; j < order; j++)
                    acc += q[j] * (int64_t)x[i - 1 - j];
                x[i] = (ST)((int64_t)x[i] + (acc >> shift));
            }
    }
}

static const int64_t FIXED_Q[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

#ifdef FLACNAT_X86
__attribute__((target("avx2")))
static inline int64_t hsum4_epi64(__m256i v) {
    __m128i s = _mm_add_epi64(_mm256_castsi256_si128(v),
                              _mm256_extracti128_si256(v, 1));
    return _mm_cvtsi128_si64(s) + _mm_extract_epi64(s, 1);
}

__attribute__((target("avx2")))
static inline __m256i mul_taps(const int32_t* p, __m256i q) {
    // lanes: sign-extended x[p[0..3]] * q, exact (|x| < 2^31, |q| < 2^15)
    return _mm256_mul_epi32(_mm256_cvtepi32_epi64(
        _mm_loadu_si128((const __m128i*)p)), q);
}

// Paired inverse predictor for the stereo hot path: the two channels'
// recurrences are independent, so interleaving them fills the multiply
// ports the single-channel chain leaves idle.  Taps j=0..3 stay scalar on
// the latency chain; taps j>=4 ride vpmuldq (signed 32x32->64 on the low
// lanes of sign-extended int64 vectors — exact, since |x| < 2^31 and
// |q| < 2^15) with a 4-iteration dependency slack that hides the
// multiply+reduce latency.  256-bit vectors on purpose: zmm multiplies
// trip the AVX-512 frequency license on Skylake-class Xeons, which
// throttles the scalar Rice loops running between frames.
//
// This shape was re-derived empirically on a Sapphire-Rapids-class core
// against five alternatives, all of which measured SLOWER: (1) register-
// carrying x[i-1..i-4] to skip the store-to-load forward (the forward is
// NOT on the chain gcc emits: imul from a memory operand fuses, and the
// extra rolling moves cost more than the forward); (2) 8 scalar taps
// (16 imuls/pair serialize on the ~1-imul/cycle port and spill GPRs);
// (3) group-of-4 vector partials with one 4x4 transpose-add (the 128-bit
// loads overlap the previous group's 32-bit stores; the store-forward
// stall lands on the inter-group chain); (4) a j>=2 vector boundary
// (the extra chunk's port pressure eats the imul savings); (5) zmm
// vpmuldq + reduce_add (the reduction sequence is longer than two ymm
// hsums).  Only the omax <= 4 all-scalar pair (predict_pair_scalar4)
// beat it, by ~25%.  (Reference hot loop: src/decode.rs:1738-1752.)
template <int NV>  // NV = ceil((omax - 4) / 4) vector chunks, 1..7
__attribute__((target("avx2")))
static void predict_pair_main(int32_t* __restrict a, int32_t* __restrict b,
                              uint32_t start, uint32_t n,
                              const int64_t* qsa, const int64_t* qsb,
                              uint32_t oa, uint32_t ob,
                              uint32_t sa, uint32_t sb) {
    constexpr int S = 4;  // scalar taps j=0..3
    alignas(32) int64_t qva[NV][4], qvb[NV][4];
    for (int v = 0; v < NV; v++)
        for (int kk = 0; kk < 4; kk++) {
            uint32_t j = S + 4 * v + (3 - kk);  // lane kk holds x[i-1-j]
            qva[v][kk] = j < oa ? qsa[j] : 0;
            qvb[v][kk] = j < ob ? qsb[j] : 0;
        }
    __m256i QA[NV], QB[NV];
    for (int v = 0; v < NV; v++) {
        QA[v] = _mm256_load_si256((const __m256i*)qva[v]);
        QB[v] = _mm256_load_si256((const __m256i*)qvb[v]);
    }
    const int64_t A0 = qsa[0], A1 = qsa[1], A2 = qsa[2], A3 = qsa[3];
    const int64_t B0 = qsb[0], B1 = qsb[1], B2 = qsb[2], B3 = qsb[3];
    for (uint32_t i = start; i < n; i++) {
        __m256i pa = mul_taps(&a[i - 4 - S], QA[0]);
        __m256i pb = mul_taps(&b[i - 4 - S], QB[0]);
        for (int v = 1; v < NV; v++) {
            pa = _mm256_add_epi64(pa, mul_taps(&a[i - 4 - S - 4 * v], QA[v]));
            pb = _mm256_add_epi64(pb, mul_taps(&b[i - 4 - S - 4 * v], QB[v]));
        }
        int64_t ra = hsum4_epi64(pa)
            + A1 * (int64_t)a[i - 2] + A2 * (int64_t)a[i - 3]
            + A3 * (int64_t)a[i - 4];
        int64_t rb = hsum4_epi64(pb)
            + B1 * (int64_t)b[i - 2] + B2 * (int64_t)b[i - 3]
            + B3 * (int64_t)b[i - 4];
        a[i] = (int32_t)((int64_t)a[i]
                         + ((A0 * (int64_t)a[i - 1] + ra) >> sa));
        b[i] = (int32_t)((int64_t)b[i]
                         + ((B0 * (int64_t)b[i - 1] + rb) >> sb));
    }
}

// Orders <= 4 need only half the register chain; plain C++ (also used
// on non-AVX2 hosts).
static void predict_pair_scalar4(int32_t* __restrict a,
                                 int32_t* __restrict b,
                                 uint32_t start, uint32_t n,
                                 const int64_t* qsa, const int64_t* qsb,
                                 uint32_t sa, uint32_t sb) {
    const int64_t A0 = qsa[0], A1 = qsa[1], A2 = qsa[2], A3 = qsa[3];
    const int64_t B0 = qsb[0], B1 = qsb[1], B2 = qsb[2], B3 = qsb[3];
    int64_t pa1 = a[start - 1], pa2 = a[start - 2],
            pa3 = a[start - 3], pa4 = a[start - 4];
    int64_t pb1 = b[start - 1], pb2 = b[start - 2],
            pb3 = b[start - 3], pb4 = b[start - 4];
    for (uint32_t i = start; i < n; i++) {
        int64_t va = (int64_t)a[i]
            + ((A0 * pa1 + A1 * pa2 + A2 * pa3 + A3 * pa4) >> sa);
        int64_t vb = (int64_t)b[i]
            + ((B0 * pb1 + B1 * pb2 + B2 * pb3 + B3 * pb4) >> sb);
        a[i] = (int32_t)va;
        b[i] = (int32_t)vb;
        pa4 = pa3; pa3 = pa2; pa2 = pa1; pa1 = va;
        pb4 = pb3; pb3 = pb2; pb2 = pb1; pb1 = vb;
    }
}
#endif  // FLACNAT_X86

// Run both channels' predictors for a stereo frame decoded in raw mode,
// then apply the wasted-bits shifts.  int32 storage gets the paired
// AVX-512 path when available; the int64 wide path and non-AVX512 builds
// fall back to the order-specialized scalar chains.
static void predict_two(int32_t* c0, int32_t* c1, uint32_t n,
                        const int64_t* q0, uint32_t o0, uint32_t s0,
                        const int64_t* q1, uint32_t o1, uint32_t s1) {
#ifdef FLACNAT_X86
    uint32_t omax = o0 > o1 ? o0 : o1;
    if ((cpu_has_avx2() || omax <= 4) && omax > 0) {
        int64_t qsa[40] = {0}, qsb[40] = {0};
        for (uint32_t j = 0; j < o0; j++) qsa[j] = q0[j];
        for (uint32_t j = 0; j < o1; j++) qsb[j] = q1[j];
        // vector taps cover j = 4 .. 4+4*NV-1
        uint32_t NV = omax <= 8 ? 1 : (omax - 4 + 3) / 4;
        uint32_t PAD = omax <= 4 ? 4 : 4 + 4 * NV;
        uint32_t head_end = PAD + 1 < n ? PAD + 1 : n;
        // scalar head up to the paired loop's history requirement
        for (uint32_t i = o0; o0 && i < head_end; i++) {
            int64_t acc = 0;
            for (uint32_t j = 0; j < o0; j++)
                acc += qsa[j] * (int64_t)c0[i - 1 - j];
            c0[i] = (int32_t)((int64_t)c0[i] + (acc >> s0));
        }
        for (uint32_t i = o1; o1 && i < head_end; i++) {
            int64_t acc = 0;
            for (uint32_t j = 0; j < o1; j++)
                acc += qsb[j] * (int64_t)c1[i - 1 - j];
            c1[i] = (int32_t)((int64_t)c1[i] + (acc >> s1));
        }
        if (n > head_end) {
            if (omax <= 4) {
                predict_pair_scalar4(c0, c1, head_end, n, qsa, qsb, s0, s1);
                return;
            }
            switch (NV) {
                case 1: predict_pair_main<1>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                case 2: predict_pair_main<2>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                case 3: predict_pair_main<3>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                case 4: predict_pair_main<4>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                case 5: predict_pair_main<5>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                case 6: predict_pair_main<6>(c0, c1, head_end, n, qsa, qsb,
                                             o0, o1, s0, s1); break;
                default: predict_pair_main<7>(c0, c1, head_end, n, qsa, qsb,
                                              o0, o1, s0, s1); break;
            }
        }
        return;
    }
#endif
    predict_any(c0, n, q0, o0, s0);
    predict_any(c1, n, q1, o1, s1);
}

static void predict_two(int64_t* c0, int64_t* c1, uint32_t n,
                        const int64_t* q0, uint32_t o0, uint32_t s0,
                        const int64_t* q1, uint32_t o1, uint32_t s1) {
    predict_any(c0, n, q0, o0, s0);
    predict_any(c1, n, q1, o1, s1);
}

// error codes
enum {
    DEC_OK = 0, DEC_EOF = 1, DEC_SYNC = 2, DEC_CRC8 = 3, DEC_CRC16 = 4,
    DEC_HDR = 5, DEC_SUBHDR = 6, DEC_RESID = 7, DEC_PARAMS = 8,
    DEC_SHORT_BLOCK = 9,
};

struct RawSubframe {
    int64_t q[32];
    uint32_t order = 0;     // predictor taps to run (0 = none)
    uint32_t shift = 0;
    uint32_t wasted = 0;
};

// step()/resume protocol code: a Rice partition is pending — the caller
// runs a bulk kernel over [rice_out(), rice_remaining()) at the cursor's
// bit position, then calls resume_rice(ndone, overlong) and step()s again.
// Distinct from every DEC_* value.
enum { SFM_NEED_RICE = -1 };

// The subframe parser expressed as a resumable machine: all header /
// warm-up / parameter / escape work happens inside step(), which yields
// only at Rice partitions so that SEVERAL independent cursors can feed
// one interleaved bulk kernel (the lockstep frame pump below).  The
// classic sequential decode_subframe() is a thin wrapper over this, so
// there is exactly one transcription of the subframe format
// (reference: src/stream.rs:2390-2550, src/decode.rs:1630-1760).
template <typename ST>
struct SubframeMachine {
    FastBits* gp;
    ST* ch;
    RawSubframe* raw;
    uint32_t bps, n;
    int64_t q[32];
    uint32_t order, qorder, shift, wasted;
    bool has_res;
    uint32_t rb, escape, count, part_len, p0, pos, part;
    uint32_t rice_k, rice_m, rice_i;
    bool rice_overlong;  // last bulk stop needs the checked re-entry path
    int phase;           // 0 = header pending, 1 = partitions, 2 = in-rice

    void init(FastBits* g_, uint32_t bps_, uint32_t n_, ST* ch_,
              RawSubframe* raw_) {
        gp = g_; bps = bps_; n = n_; ch = ch_; raw = raw_;
        phase = 0;
    }
    inline ST* rice_out() { return ch + pos + rice_i; }
    inline uint32_t rice_remaining() const { return rice_m - rice_i; }
    inline void resume_rice(uint32_t got, bool overlong) {
        rice_i += got;
        rice_overlong = overlong;
    }

    int finish() {
        if (has_res) {
            if (raw) {
                raw->order = qorder;
                raw->shift = shift;
                for (uint32_t j = 0; j < qorder && j < 32; j++)
                    raw->q[j] = q[j];
            } else {
                predict_any(ch, n, q, qorder, shift);
            }
        }
        if (raw) {
            raw->wasted = wasted;
        } else if (wasted) {
            typedef typename std::make_unsigned<ST>::type UST;
            for (uint32_t i = 0; i < n; i++)
                ch[i] = (ST)((UST)ch[i] << wasted);
        }
        return DEC_OK;
    }

    int step() {
        FastBits& g = *gp;
        if (phase == 0) {
            // --- subframe header, warm-up, predictor params (no yields) ---
            if (!g.fits(8)) return DEC_EOF;
            if (g.get(1) != 0) return DEC_SUBHDR;
            uint32_t code = g.get(6);
            wasted = 0;
            if (g.get(1)) {
                wasted = g.get_unary() + 1;
                if (!g.fits(1)) return DEC_EOF;
            }
            if (wasted >= bps) return DEC_SUBHDR;
            uint32_t eff = bps - wasted;

            if (code == 0) {                   // constant
                if (!g.fits(eff)) return DEC_EOF;
                ST v = (ST)g.get_signed(eff);
                for (uint32_t i = 0; i < n; i++) ch[i] = v;
                has_res = false;
                return finish();
            } else if (code == 1) {            // verbatim
                if (!g.fits((uint64_t)eff * n)) return DEC_EOF;
                for (uint32_t i = 0; i < n; i++) ch[i] = (ST)g.get_signed(eff);
                has_res = false;
                return finish();
            } else if (code >= 8 && code <= 12) {
                order = code - 8;
            } else if (code >= 32) {
                order = (code & 31) + 1;
            } else {
                return DEC_SUBHDR;
            }
            has_res = true;

            if (order > n) return DEC_SUBHDR;
            if (!g.fits((uint64_t)eff * order)) return DEC_EOF;
            for (uint32_t i = 0; i < order; i++) ch[i] = (ST)g.get_signed(eff);

            qorder = order;
            shift = 0;
            if (code >= 32) {                  // LPC params
                if (!g.fits(9)) return DEC_EOF;
                uint32_t pcode = g.get(4);
                if (pcode == 0xF) return DEC_PARAMS;
                uint32_t precision = pcode + 1;
                int64_t sh = g.get_signed(5);
                if (sh < 0) return DEC_PARAMS;
                shift = (uint32_t)sh;
                if (!g.fits((uint64_t)precision * order)) return DEC_EOF;
                for (uint32_t i = 0; i < order; i++)
                    q[i] = g.get_signed(precision);
            } else {
                for (uint32_t i = 0; i < 4; i++) q[i] = FIXED_Q[order][i];
            }

            // residual partition header
            if (!g.fits(6)) return DEC_EOF;
            uint32_t method = g.get(2);
            if (method > 1) return DEC_RESID;
            rb = method == 0 ? 4 : 5;
            escape = (1u << rb) - 1;
            uint32_t po = g.get(4);
            count = 1u << po;
            part_len = n / count;
            if (part_len == 0) return DEC_RESID;
            uint32_t n_res = n - order;
            p0 = (uint32_t)((int64_t)n_res - (int64_t)(count - 1) * part_len);
            if ((int64_t)n_res - (int64_t)(count - 1) * part_len < 1
                || p0 > part_len)
                return DEC_RESID;
            pos = order;
            part = 0;
            phase = 1;
        }
        for (;;) {
            if (phase == 2) {
                // back from a bulk pass over the active Rice partition
                if (rice_i < rice_m) {
                    if (!rice_overlong)     // lockstep chunk ended early:
                        return SFM_NEED_RICE;  // plain bulk re-entry
                    // over-long code (unary run past the 64-bit window):
                    // ONE checked symbol, then immediate bulk re-entry,
                    // so a pathological code only costs itself
                    uint64_t before = g.pos();
                    uint32_t qq = g.get_unary();
                    // terminating 1 consumed iff pos advanced qq+1
                    if (g.pos() != before + qq + 1) return DEC_EOF;
                    if (!g.fits(rice_k)) return DEC_EOF;
                    uint32_t lsb = rice_k ? g.get(rice_k) : 0;
                    uint64_t u64 = ((uint64_t)qq << rice_k) | lsb;
                    ch[pos + rice_i] =
                        (ST)((u64 & 1) ? -((int64_t)(u64 >> 1)) - 1
                                       : (int64_t)(u64 >> 1));
                    rice_i++;
                    if (rice_i < rice_m) return SFM_NEED_RICE;
                }
                pos += rice_m;
                part++;
                phase = 1;
            }
            if (part >= count) return finish();
            uint32_t m = part == 0 ? p0 : part_len;
            if (!g.fits(rb)) return DEC_EOF;
            uint32_t param = g.get(rb);
            if (param == escape) {
                if (!g.fits(5)) return DEC_EOF;
                uint32_t width = g.get(5);
                if (width == 0) {
                    for (uint32_t i = 0; i < m; i++) ch[pos + i] = 0;
                } else {
                    if (!g.fits((uint64_t)width * m)) return DEC_EOF;
                    for (uint32_t i = 0; i < m; i++)
                        ch[pos + i] = (ST)g.get_signed(width);
                }
                pos += m;
                part++;
            } else {
                rice_k = param;
                rice_m = m;
                rice_i = 0;
                rice_overlong = false;
                phase = 2;
                return SFM_NEED_RICE;
            }
        }
    }
};

template <typename ST>
static int decode_subframe(FastBits& g, uint32_t bps, uint32_t n, ST* ch,
                           RawSubframe* raw = nullptr) {
    SubframeMachine<ST> sm;
    sm.init(&g, bps, n, ch, raw);
    for (;;) {
        int r = sm.step();
        if (r != SFM_NEED_RICE) return r;
        uint64_t bitpos = g.pos();
        uint32_t got = rice_bulk_k(g.buf, g.nbytes, bitpos, sm.rice_out(),
                                   sm.rice_remaining(), sm.rice_k);
        g.set_pos(bitpos);
        // rice_bulk stops only on completion or an over-long/EOF window
        sm.resume_rice(got, true);
    }
}

struct FrameHdr {
    uint32_t block_size, rate, bps, ch_count, ca;
};

// Parse + validate one frame header (sync code, codes, frame-number varint,
// size/rate escapes, CRC-8) shared by the bulk decoder and the raw parser
// (reference: src/stream.rs:151-240).  ``frame_start_byte`` is the
// byte-aligned position the caller recorded before calling.  streaminfo
// context supplies the escape values.  Returns DEC_OK or a DEC_* code; the
// caller decides whether to rewind.
static int parse_frame_header(FastBits& g, const uint8_t* buf,
                              uint64_t frame_start_byte,
                              uint32_t streaminfo_rate,
                              uint32_t streaminfo_bps, FrameHdr* hdr) {
    if (!g.fits(40)) return DEC_EOF;
    if (g.get(15) != 0b111111111111100) return DEC_SYNC;
    g.get(1);  // blocking strategy
    uint32_t bsc = g.get(4), src = g.get(4), ca = g.get(4), bpc = g.get(3);
    g.get(1);
    // frame number varint
    if (!g.fits(8)) return DEC_EOF;
    uint32_t b0 = g.get(8);
    if (b0 >= 0x80) {
        uint32_t cont = 0, lead = b0;
        while (lead & 0x80) { cont++; lead <<= 1; }
        if (cont == 1 || cont > 7) return DEC_HDR;
        cont -= 1;
        if (!g.fits(8ull * cont)) return DEC_EOF;
        for (uint32_t i = 0; i < cont; i++)
            if ((g.get(8) >> 6) != 0b10) return DEC_HDR;
    }
    {
        static const uint32_t BS[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                                        256, 512, 1024, 2048, 4096, 8192,
                                        16384, 32768};
        if (bsc == 0) return DEC_HDR;
        else if (bsc == 6) { if (!g.fits(8)) return DEC_EOF; hdr->block_size = g.get(8) + 1; }
        else if (bsc == 7) { if (!g.fits(16)) return DEC_EOF; hdr->block_size = g.get(16) + 1; }
        else hdr->block_size = BS[bsc];
    }
    {
        static const uint32_t SR[16] = {0, 88200, 176400, 192000, 8000,
                                        16000, 22050, 24000, 32000, 44100,
                                        48000, 96000, 0, 0, 0, 0};
        if (src == 0) hdr->rate = streaminfo_rate;
        else if (src == 12) { if (!g.fits(8)) return DEC_EOF; hdr->rate = g.get(8) * 1000; }
        else if (src == 13) { if (!g.fits(16)) return DEC_EOF; hdr->rate = g.get(16); }
        else if (src == 14) { if (!g.fits(16)) return DEC_EOF; hdr->rate = g.get(16) * 10; }
        else if (src == 15) return DEC_HDR;
        else hdr->rate = SR[src];
    }
    {
        static const uint32_t BP[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        if (bpc == 0) hdr->bps = streaminfo_bps;
        else if (bpc == 3) return DEC_HDR;
        else hdr->bps = BP[bpc];
    }
    hdr->ca = ca;
    hdr->ch_count = ca <= 7 ? ca + 1 : 2;
    if (ca > 10) return DEC_HDR;
    // CRC-8 over the header bytes
    uint64_t crc_byte = g.pos() >> 3;
    if (!g.fits(8)) return DEC_EOF;
    uint32_t expected = g.get(8);
    if (nat_crc8(buf + frame_start_byte, crc_byte - frame_start_byte, 0)
        != expected)
        return DEC_CRC8;
    return DEC_OK;
}

// Frame epilogue once every subframe is parsed: byte alignment, CRC-16
// gate, the deferred stereo prediction + wasted-bit shifts, and the
// inverse decorrelation fused with the interleave.  Shared by the
// sequential decoder (decode_frame_body) and the lockstep frame pump.
template <typename ST>
static int finish_frame_body(FastBits& g, const uint8_t* buf,
                             uint64_t frame_start_byte, uint32_t block_size,
                             uint32_t ch_count, uint32_t ca, ST* chdata,
                             bool defer2, RawSubframe* raw2,
                             int32_t* out_ptr) {
    g.align();
    {
        uint64_t crc_byte = g.pos() >> 3;
        if (!g.fits(16)) return DEC_EOF;
        uint32_t expected = g.get(16);
        uint32_t actual = nat_crc16(buf + frame_start_byte,
                                    crc_byte - frame_start_byte, 0);
        if (actual != expected) return DEC_CRC16;
    }

    if (defer2) {
        // paired prediction after the CRC gate (skips work on bad frames)
        ST* p0 = chdata;
        ST* p1 = chdata + block_size;
        predict_two(p0, p1, block_size,
                    raw2[0].q, raw2[0].order, raw2[0].shift,
                    raw2[1].q, raw2[1].order, raw2[1].shift);
        typedef typename std::make_unsigned<ST>::type UST;
        if (raw2[0].wasted)
            for (uint32_t i = 0; i < block_size; i++)
                p0[i] = (ST)((UST)p0[i] << raw2[0].wasted);
        if (raw2[1].wasted)
            for (uint32_t i = 0; i < block_size; i++)
                p1[i] = (ST)((UST)p1[i] << raw2[1].wasted);
    }

    // inverse decorrelation fused with the interleave into one pass
    // (reference decorrelation: src/decode.rs:1512-1625)
    ST* __restrict c0 = chdata;
    ST* __restrict c1 = chdata + block_size;
    if (ca == 8) {          // left-side
        for (uint32_t i = 0; i < block_size; i++) {
            out_ptr[2 * i] = (int32_t)c0[i];
            out_ptr[2 * i + 1] = (int32_t)(c0[i] - c1[i]);
        }
    } else if (ca == 9) {   // side-right
        for (uint32_t i = 0; i < block_size; i++) {
            out_ptr[2 * i] = (int32_t)(c0[i] + c1[i]);
            out_ptr[2 * i + 1] = (int32_t)c1[i];
        }
    } else if (ca == 10) {  // mid-side
        for (uint32_t i = 0; i < block_size; i++) {
            ST side = c1[i];
            ST sum = (ST)(c0[i] * 2 + (side & 1));
            out_ptr[2 * i] = (int32_t)((sum + side) >> 1);
            out_ptr[2 * i + 1] = (int32_t)((sum - side) >> 1);
        }
    } else if (ch_count == 2) {
        for (uint32_t i = 0; i < block_size; i++) {
            out_ptr[2 * i] = (int32_t)c0[i];
            out_ptr[2 * i + 1] = (int32_t)c1[i];
        }
    } else {
        for (uint32_t i = 0; i < block_size; i++)
            for (uint32_t c = 0; c < ch_count; c++)
                *out_ptr++ = (int32_t)chdata[(size_t)c * block_size + i];
    }
    return DEC_OK;
}

// Subframes + CRC-16 + inverse decorrelation + interleave for one frame.
// ST = int32 covers bps <= 24 (mid/side headroom included); the int64
// instantiation handles the wide paths (reference wide-side handling:
// src/decode.rs:1586-1625).
template <typename ST>
static int decode_frame_body(FastBits& g, const uint8_t* buf,
                             uint64_t frame_start_byte, uint32_t block_size,
                             uint32_t fbps, uint32_t ch_count, uint32_t ca,
                             int32_t* out_ptr) {
    static thread_local std::vector<ST> chbuf;
    if (chbuf.size() < (size_t)ch_count * block_size)
        chbuf.resize((size_t)ch_count * block_size);
    int rc = DEC_OK;
    RawSubframe raw2[2];
    bool defer2 = ch_count == 2;  // stereo: defer predict to the paired path
    for (uint32_t c = 0; c < ch_count && rc == DEC_OK; c++) {
        uint32_t sub_bps = fbps;
        if ((ca == 8 && c == 1) || (ca == 9 && c == 0) || (ca == 10 && c == 1))
            sub_bps += 1;
        rc = decode_subframe(g, sub_bps, block_size,
                             chbuf.data() + (size_t)c * block_size,
                             defer2 ? &raw2[c] : nullptr);
    }
    if (rc != DEC_OK) return rc;
    return finish_frame_body<ST>(g, buf, frame_start_byte, block_size,
                                 ch_count, ca, chbuf.data(), defer2, raw2,
                                 out_ptr);
}

// A whole frame as a resumable machine (header + per-channel subframe
// machines + epilogue), yielding at Rice partitions: four of these feed
// the interleaved bulk kernel in the lockstep pump.  In raw mode the
// machine skips prediction/decorrelation and only validates the CRC-16 —
// the channel buffers then hold warm-ups + residuals and raws[] the
// predictor parameters (the device decode pipeline's feed format).
template <typename ST>
struct FrameMachine {
    FastBits g;
    const uint8_t* buf;
    uint64_t buf_bytes, frame_start_byte;
    FrameHdr hdr;
    ST* chbuf;
    size_t ch_stride;
    int32_t* out_ptr;
    RawSubframe raws[8];
    bool defer2, raw_mode;
    uint32_t c;
    SubframeMachine<ST> sf;
    bool sf_active;

    // Returns SFM_NEED_RICE, DEC_OK (frame complete, g at its end), or a
    // DEC_* error.  The streaminfo cross-checks mirror nat_decode_frames.
    int start(const uint8_t* b, uint64_t nb, uint64_t pos_byte,
              uint32_t sample_rate, uint32_t bps, uint32_t channels,
              uint32_t max_block, ST* chb, size_t stride, int32_t* dst,
              bool raw) {
        buf = b; buf_bytes = nb; frame_start_byte = pos_byte;
        chbuf = chb; out_ptr = dst;
        raw_mode = raw; c = 0; sf_active = false;
        g.init(b, nb, pos_byte * 8);
        int hrc = parse_frame_header(g, buf, pos_byte, sample_rate, bps,
                                     &hdr);
        if (hrc != DEC_OK) return hrc;
        if (hdr.block_size > max_block || hdr.rate != sample_rate
            || hdr.ch_count != channels || hdr.bps != bps) return DEC_HDR;
        // stride 0 = pack channels at the frame's own block size (the
        // decode epilogue assumes that layout); raw mode passes the
        // device panel row stride explicitly
        ch_stride = stride ? stride : hdr.block_size;
        defer2 = !raw_mode && hdr.ch_count == 2;
        for (uint32_t j = 0; j < hdr.ch_count && j < 8; j++)
            raws[j] = RawSubframe();
        return step();
    }
    int step() {
        for (;;) {
            if (!sf_active) {
                if (c >= hdr.ch_count) {
                    if (!raw_mode)
                        return finish_frame_body<ST>(
                            g, buf, frame_start_byte, hdr.block_size,
                            hdr.ch_count, hdr.ca, chbuf, defer2, raws,
                            out_ptr);
                    // raw mode: CRC-16 gate only
                    g.align();
                    uint64_t crc_byte = g.pos() >> 3;
                    if (!g.fits(16)) return DEC_EOF;
                    uint32_t expected = g.get(16);
                    if (nat_crc16(buf + frame_start_byte,
                                  crc_byte - frame_start_byte, 0)
                        != expected)
                        return DEC_CRC16;
                    return DEC_OK;
                }
                uint32_t sub_bps = hdr.bps;
                if ((hdr.ca == 8 && c == 1) || (hdr.ca == 9 && c == 0)
                    || (hdr.ca == 10 && c == 1))
                    sub_bps += 1;
                sf.init(&g, sub_bps, hdr.block_size,
                        chbuf + (size_t)c * ch_stride,
                        (raw_mode || defer2) ? &raws[c] : nullptr);
                sf_active = true;
            }
            int r = sf.step();
            if (r == SFM_NEED_RICE) return r;
            if (r != DEC_OK) return r;
            sf_active = false;
            c++;
        }
    }
};

// A speculative frame-start candidate: every byte position that parses as
// a valid frame header (15-bit sync + field validation + streaminfo
// cross-check + CRC-8).  Every true frame start qualifies; a false
// positive needs a ~2^-30 coincidence, and both speculative decoders
// (the thread pool and the lockstep pump) verify that decoded frames
// tile the candidate list exactly, falling back to the sequential path
// otherwise.
struct Cand { uint64_t pos; uint32_t block; };

// Bytes from start_byte to the buffer's end; 0 for a start at or past it
// (an unsigned difference would wrap to a huge span).
static inline uint64_t bytes_left(uint64_t buf_bytes, uint64_t start_byte) {
    return start_byte < buf_bytes ? buf_bytes - start_byte : 0;
}

// Split candidates [0, K) into nt contiguous spans of about equal bytes,
// measured over the call's own frames: from cands[0].pos to the end of
// frame K - 1 (cands[K].pos where the scan found it, else one mean frame
// past cands[K - 1].pos).  Returns nt + 1 candidate indices; a span may
// be empty where frame sizes are very uneven.
static std::vector<size_t> split_spans(const std::vector<Cand>& cands,
                                       size_t K, uint32_t nt) {
    uint64_t first = cands[0].pos;
    uint64_t end = K < cands.size() ? cands[K].pos
        : cands[K - 1].pos + (K > 1 ? (cands[K - 1].pos - first) / (K - 1)
                                    : 0);
    std::vector<size_t> split(nt + 1);
    split[0] = 0;
    for (uint32_t t = 1; t < nt; t++) {
        uint64_t target = first + (end - first) * t / nt;
        size_t j = split[t - 1];
        while (j < K && cands[j].pos < target) j++;
        split[t] = j;
    }
    split[nt] = K;
    return split;
}

// Worker threads kept for the spans of one call at a time: on the 8-core
// host of an H100 machine, starting and joining one to seven threads cost
// 0.5-1.5 ms a call, against ~1.2 ms of raw parse in a span of 32 CD
// frames.  The workers start at first use and
// wait on a condition variable between calls; a forked child starts a pool
// of its own.
class SpanPool {
  public:
    // fn(t) for every t < nt, the spans claimed in order by the calling
    // thread and up to nt - 1 workers (by the calling thread alone where
    // no worker can start); a second call waits for the first to end.
    void run(uint32_t nt, const std::function<void(uint32_t)>& fn) {
        std::lock_guard<std::mutex> call(call_mu_);
        std::unique_lock<std::mutex> lk(mu_);
        done_.wait(lk, [&] { return active_ == 0; });  // late wakers gone
        while (workers_ < std::min(nt - 1, MAX_WORKERS)) {
            try {
                std::thread([this, g = gen_] { loop(g); }).detach();
            } catch (const std::system_error&) {
                break;
            }
            workers_++;
        }
        fn_ = &fn;
        nt_ = nt;
        next_.store(0);
        gen_++;
        lk.unlock();
        work_.notify_all();
        claim();
        lk.lock();
        done_.wait(lk, [&] { return active_ == 0; });
    }

  private:
    static constexpr uint32_t MAX_WORKERS = 63;

    void claim() {
        for (uint32_t t; (t = next_.fetch_add(1)) < nt_;) (*fn_)(t);
    }
    void loop(uint64_t seen) {
        std::unique_lock<std::mutex> lk(mu_);
        for (;;) {
            work_.wait(lk, [&] { return gen_ != seen; });
            seen = gen_;
            active_++;
            lk.unlock();
            claim();
            lk.lock();
            if (--active_ == 0) done_.notify_all();
        }
    }

    std::mutex call_mu_, mu_;
    std::condition_variable work_, done_;
    uint32_t workers_ = 0, active_ = 0, nt_ = 0;
    uint64_t gen_ = 0;
    std::atomic<uint32_t> next_{0};
    const std::function<void(uint32_t)>* fn_ = nullptr;
};

static std::atomic<SpanPool*> span_pool_ptr{nullptr};

// The process's pool, made at first use and never freed (its workers wait
// for the process's end); a forked child, which holds none of the
// parent's workers, makes its own.
static SpanPool& span_pool() {
    SpanPool* p = span_pool_ptr.load();
    if (p) return *p;
    static std::once_flag registered;
    std::call_once(registered, [] {
        pthread_atfork(nullptr, nullptr, [] { span_pool_ptr.store(nullptr); });
    });
    SpanPool* fresh = new SpanPool;
    if (span_pool_ptr.compare_exchange_strong(p, fresh)) return *fresh;
    delete fresh;
    return *p;
}

static void scan_frame_candidates(const uint8_t* buf, uint64_t buf_bytes,
                                  uint64_t start_byte, uint32_t n_frames,
                                  uint32_t sample_rate, uint32_t channels,
                                  uint32_t bps, uint32_t max_block,
                                  std::vector<Cand>& cands) {
    cands.reserve(bytes_left(buf_bytes, start_byte) / 1024 + 16);
    const uint8_t* p = buf + start_byte;
    if (buf_bytes < 16) return;
    const uint8_t* const end = buf + buf_bytes - 16;
    while (p <= end && cands.size() < n_frames) {
        p = (const uint8_t*)memchr(p, 0xFF, end - p + 1);
        if (!p) break;
        if ((p[1] & 0xFE) == 0xF8) {
            FastBits g;
            g.init(buf, buf_bytes, (uint64_t)(p - buf) * 8);
            FrameHdr hdr;
            if (parse_frame_header(g, buf, p - buf, sample_rate, bps,
                                   &hdr) == DEC_OK
                && hdr.block_size <= max_block
                && hdr.rate == sample_rate && hdr.ch_count == channels
                && hdr.bps == bps)
                cands.push_back({(uint64_t)(p - buf), hdr.block_size});
        }
        p++;
    }
}

// Shared pump main loop: while frames are in flight, gather their
// pending Rice partitions, run the interleaved kernel (or single-cursor
// bulk when fewer than four are pending), resume the machines, and hand
// completed frames to on_done (retire + refeed; returns false to abort).
template <typename ST, typename OnDone>
static bool pump_loop(FrameMachine<ST> (&fm)[4], bool (&active)[4],
                      const uint8_t* buf, uint64_t buf_bytes,
                      OnDone&& on_done) {
    constexpr int W = 4;
    for (;;) {
        int nact = active[0] + active[1] + active[2] + active[3];
        if (nact == 0) return true;
        if (nact == W) {
            uint64_t bp[W]; ST* op[W]; uint32_t m[W], kk[W], nd[W];
            uint8_t fl[W];
            for (int s = 0; s < W; s++) {
                bp[s] = fm[s].g.pos();
                op[s] = fm[s].sf.rice_out();
                m[s] = fm[s].sf.rice_remaining();
                kk[s] = fm[s].sf.rice_k;
            }
            rice_bulk_4w<ST>(buf, buf_bytes, bp, op, m, kk, nd, fl);
            for (int s = 0; s < W; s++) {
                fm[s].g.set_pos(bp[s]);
                fm[s].sf.resume_rice(nd[s], fl[s] != 0);
            }
        } else {
            // stream tail: fewer than four pending partitions
            for (int s = 0; s < W; s++) {
                if (!active[s]) continue;
                uint64_t bitpos = fm[s].g.pos();
                uint32_t got = rice_bulk_k(
                    buf, buf_bytes, bitpos, fm[s].sf.rice_out(),
                    fm[s].sf.rice_remaining(), fm[s].sf.rice_k);
                fm[s].g.set_pos(bitpos);
                fm[s].sf.resume_rice(got, true);
            }
        }
        for (int s = 0; s < W; s++) {
            if (!active[s]) continue;
            int r = fm[s].step();
            if (r == SFM_NEED_RICE) continue;
            if (r != DEC_OK || !on_done(s)) return false;
        }
    }
}

// The lockstep frame pump: up to four frames (from the candidate scan)
// decode concurrently ON ONE THREAD, their pending Rice partitions fed
// to the interleaved 4-way kernel.  Writes are disjoint (per-candidate
// sample offsets); every completed frame must end exactly at the next
// candidate and passes its own CRC-16, so acceptance implies the
// sequential path would have produced the same bytes.  Returns the
// candidate count on success or -1 (caller reruns the exact sequential
// decoder — identical error surface, the pump only ever accepts).
template <typename ST>
static int64_t pump_decode(const uint8_t* buf, uint64_t buf_bytes,
                           const std::vector<Cand>& cands,
                           size_t j0, size_t j1,
                           const std::vector<uint64_t>& sample_off,
                           uint32_t sample_rate, uint32_t channels,
                           uint32_t bps, uint32_t max_block,
                           int32_t* out, uint32_t* block_sizes,
                           uint64_t* last_end_byte) {
    constexpr int W = 4;
    size_t cap = (size_t)channels * max_block;
    static thread_local std::vector<ST> chbufs;
    if (chbufs.size() < cap * W) chbufs.resize(cap * W);
    FrameMachine<ST> fm[W];
    size_t idx[W];
    bool active[W] = {false, false, false, false};
    size_t next = j0;

    auto retire = [&](int s) -> bool {
        uint64_t endb = fm[s].g.pos() >> 3;
        size_t j = idx[s];
        if (j + 1 < cands.size()) {
            // the decoded frame must end exactly at the next candidate:
            // a false sync inside frame data fails here -> fallback
            if (endb != cands[j + 1].pos) return false;
        }
        if (j + 1 == j1) *last_end_byte = endb;
        block_sizes[j] = cands[j].block;
        return true;
    };
    auto feed = [&](int s) -> bool {  // false -> abort the pump
        active[s] = false;
        while (next < j1) {
            size_t j = next++;
            idx[s] = j;
            int r = fm[s].start(buf, buf_bytes, cands[j].pos, sample_rate,
                                bps, channels, max_block,
                                chbufs.data() + cap * s, 0,
                                out + sample_off[j] * channels, false);
            if (r == SFM_NEED_RICE) { active[s] = true; return true; }
            if (r == DEC_OK && retire(s)) continue;  // no-Rice frame
            return false;
        }
        return true;
    };
    for (int s = 0; s < W; s++)
        if (!feed(s)) return -1;
    if (!pump_loop<ST>(fm, active, buf, buf_bytes,
                       [&](int s) { return retire(s) && feed(s); }))
        return -1;
    return (int64_t)(j1 - j0);
}

// Raw-mode lockstep pump for the device decode pipeline's feed: four
// frames parse in lockstep on one thread, their warm-ups + residuals
// written DIRECTLY into the int32 device panels — no intermediate int64
// channel buffer and no copy pass, unlike the sequential raw parser.
// Engaged for bps < 26 only (the sequential path keeps the int64
// fit-check for wider streams); residuals of hostile >int32 streams wrap
// exactly as the sequential int32 cast does.  Parses candidates [j0, j1),
// writing only their rows; every frame must end at the next candidate
// (the span's last too, against the next span's first), and
// *last_end_byte is where frame j1 - 1 ends.  Returns candidates parsed
// or -1 (caller falls back to the sequential raw parser).
static int64_t pump_parse_raw(const uint8_t* buf, uint64_t buf_bytes,
                              const std::vector<Cand>& cands,
                              size_t j0, size_t j1,
                              uint32_t sample_rate, uint32_t channels,
                              uint32_t bps, uint32_t block_size,
                              int32_t* out_buf, uint8_t* out_order,
                              int8_t* out_shift, uint8_t* out_wasted,
                              int32_t* out_qcoeffs, uint8_t* out_assignment,
                              uint32_t* out_block, uint64_t* last_end_byte) {
    constexpr int W = 4;
    FrameMachine<int32_t> fm[W];
    size_t idx[W];
    bool active[W] = {false, false, false, false};
    size_t next = j0;

    auto retire = [&](int s) -> bool {
        uint64_t endb = fm[s].g.pos() >> 3;
        size_t j = idx[s];
        if (j + 1 < cands.size() && endb != cands[j + 1].pos) return false;
        if (j + 1 == j1) *last_end_byte = endb;
        for (uint32_t c = 0; c < channels; c++) {
            size_t fc = j * channels + c;
            const RawSubframe& r = fm[s].raws[c];
            out_order[fc] = (uint8_t)r.order;
            out_shift[fc] = (int8_t)r.shift;
            out_wasted[fc] = (uint8_t)r.wasted;
            for (uint32_t t = 0; t < 32; t++)
                out_qcoeffs[fc * 32 + t] =
                    t < r.order ? (int32_t)r.q[t] : 0;
        }
        out_assignment[j] = (uint8_t)fm[s].hdr.ca;
        out_block[j] = cands[j].block;
        return true;
    };
    auto feed = [&](int s) -> bool {
        active[s] = false;
        while (next < j1) {
            size_t j = next++;
            idx[s] = j;
            int32_t* panel = out_buf + (size_t)j * channels * block_size;
            int r = fm[s].start(buf, buf_bytes, cands[j].pos, sample_rate,
                                bps, channels, block_size, panel,
                                block_size, nullptr, true);
            if (r == SFM_NEED_RICE) { active[s] = true; return true; }
            if (r == DEC_OK && retire(s)) continue;
            return false;
        }
        return true;
    };
    for (int s = 0; s < W; s++)
        if (!feed(s)) return -1;
    if (!pump_loop<int32_t>(fm, active, buf, buf_bytes,
                            [&](int s) { return retire(s) && feed(s); }))
        return -1;
    return (int64_t)(j1 - j0);
}

}  // namespace

extern "C" {

// Decode up to n_frames frames starting at start_bitpos (byte-aligned).
// Returns frames decoded; *error = DEC_* for the stop reason.
// out receives interleaved int32; block_sizes[f] the per-frame sample count.
int64_t nat_decode_frames(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t max_block, uint64_t remaining_samples /* ~0ull = unknown */,
    int32_t* out, uint32_t* block_sizes, uint64_t* end_bitpos,
    uint32_t* error) {
    if (!tables_ready) init_tables();
    FastBits g;
    g.init(buf, buf_bytes, start_bitpos);
    *error = DEC_OK;

    int64_t decoded = 0;
    int32_t* out_ptr = out;
    uint64_t frame_start_byte = g.pos() >> 3;
    for (uint32_t f = 0; f < n_frames; f++) {
        g.align();
        frame_start_byte = g.pos() >> 3;
        if (remaining_samples != ~0ull && remaining_samples == 0) {
            *error = DEC_EOF;
            break;
        }
        // --- header (shared parser) ---
        FrameHdr hdr;
        int hrc = parse_frame_header(g, buf, frame_start_byte, sample_rate,
                                     bps, &hdr);
        if (hrc != DEC_OK) { *error = (uint32_t)hrc; break; }
        uint32_t block_size = hdr.block_size, rate = hdr.rate,
                 fbps = hdr.bps, ch_count = hdr.ch_count, ca = hdr.ca;

        // streaminfo cross-validation (reference: src/stream.rs:279-313)
        if (block_size > max_block || rate != sample_rate
            || ch_count != channels || fbps != bps) {
            *error = DEC_HDR; break;
        }
        if (remaining_samples != ~0ull
            && (block_size > remaining_samples
                || !(block_size == remaining_samples || block_size > 14))) {
            *error = DEC_SHORT_BLOCK;
            g.set_pos(frame_start_byte * 8);
            break;
        }

        // --- subframes + CRC + decorrelation + interleave ---
        int rc = (fbps <= 24)
            ? decode_frame_body<int32_t>(g, buf, frame_start_byte, block_size,
                                         fbps, ch_count, ca, out_ptr)
            : decode_frame_body<int64_t>(g, buf, frame_start_byte, block_size,
                                         fbps, ch_count, ca, out_ptr);
        if (rc != DEC_OK) { *error = (uint32_t)rc; break; }
        out_ptr += (size_t)block_size * ch_count;

        block_sizes[f] = block_size;
        if (remaining_samples != ~0ull) remaining_samples -= block_size;
        decoded++;
    }
    // on ANY stop reason, report the failed frame's start so the caller's
    // scalar reparse raises the precise error for THAT frame instead of
    // silently skipping it (CRC-16 failures used to leave the position
    // past the bad frame)
    if (*error != DEC_OK) g.set_pos(frame_start_byte * 8);
    *end_bitpos = g.pos();
    return decoded;
}

int64_t nat_decode_frames_ilv(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t max_block, uint64_t remaining_samples,
    int32_t* out, uint32_t* block_sizes, uint64_t* end_bitpos,
    uint32_t* error);

// Multithreaded whole-buffer decode via speculative frame-boundary scan.
//
// FLAC frames carry no length field, so frame starts are only known by
// decoding — sequential by construction.  This decoder breaks the chain
// speculatively: a serial pre-scan finds every byte position that parses
// as a valid frame header (15-bit sync + field validation + streaminfo
// cross-check + CRC-8 — every true frame start qualifies; false positives
// need a ~2^-30 coincidence), threads then decode candidate spans in
// parallel, and a reconciliation pass verifies the spans tile the stream
// exactly.  Any inconsistency (false candidate, short block mid-stream,
// decode error) falls back to the exact sequential path, so semantics are
// identical to nat_decode_frames.  This is the TPU-host counterpart of
// the reference's rayon file parallelism (reference: src/encode.rs:11-17,
// examples/flac2wav.rs:31-38) applied *within* one stream.
int64_t nat_decode_frames_mt(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t max_block, uint64_t remaining_samples,
    int32_t* out, uint32_t* block_sizes, uint64_t* end_bitpos,
    uint32_t* error, uint32_t nthreads) {
    if (!tables_ready) init_tables();
    uint64_t start_byte = start_bitpos >> 3;
    if (nthreads <= 1 || bytes_left(buf_bytes, start_byte) < (1u << 18))
        return nat_decode_frames_ilv(buf, buf_bytes, start_bitpos, n_frames,
                                 sample_rate, channels, bps, max_block,
                                 remaining_samples, out, block_sizes,
                                 end_bitpos, error);

    // --- phase A: candidate scan (serial, memchr-driven) ---
    std::vector<Cand> cands;
    scan_frame_candidates(buf, buf_bytes, start_byte, n_frames, sample_rate,
                          channels, bps, max_block, cands);
    bool fallback = cands.empty() || cands[0].pos != start_byte;

    uint64_t total_span_samples = 0;
    std::vector<uint64_t> sample_off, frame_off;
    if (!fallback) {
        // short-block / remaining-samples rules need the sequential path's
        // exact error surface; screen cheaply here, fall back on any hit
        sample_off.resize(cands.size());
        for (size_t j = 0; j < cands.size(); j++) {
            sample_off[j] = total_span_samples;
            total_span_samples += cands[j].block;
            if (cands[j].block <= 14 && j + 1 < cands.size()) fallback = true;
        }
        if (remaining_samples != ~0ull) {
            if (total_span_samples > remaining_samples) fallback = true;
            // a short (<=14) last block is only legal when it lands
            // exactly on the declared total (reference ShortBlock rule,
            // src/decode.rs:1405-1410)
            if (!cands.empty() && cands.back().block <= 14
                && total_span_samples != remaining_samples)
                fallback = true;
        }
    }

    if (!fallback && cands.size() >= 4) {
        uint32_t nt = std::min<uint32_t>(nthreads, (uint32_t)cands.size() / 2);
        // span boundaries: candidate indices at ~equal bytes of the call's
        // own frames
        std::vector<size_t> split = split_spans(cands, cands.size(), nt);

        std::vector<uint8_t> ok(nt, 0);
        std::vector<uint64_t> span_end(nt, 0);
        span_pool().run(nt, [&](uint32_t t) {
            size_t j0 = split[t], j1 = split[t + 1];
            if (j0 >= j1) { ok[t] = 2; return; }  // empty span: skip
            // each worker pumps its span: four frames in lockstep per
            // thread (the pump's retire step enforces that every decoded
            // frame ends exactly at the next candidate, which subsumes
            // the old run-past / offset checks)
            uint64_t span_last = 0;
            int64_t got = bps <= 24
                ? pump_decode<int32_t>(buf, buf_bytes, cands, j0, j1,
                                       sample_off, sample_rate, channels,
                                       bps, max_block, out, block_sizes,
                                       &span_last)
                : pump_decode<int64_t>(buf, buf_bytes, cands, j0, j1,
                                       sample_off, sample_rate, channels,
                                       bps, max_block, out, block_sizes,
                                       &span_last);
            span_end[t] = span_last;
            ok[t] = got >= 0 ? 1 : 0;
        });
        bool all_ok = true;
        uint64_t last_end = 0;
        for (uint32_t t = 0; t < nt; t++) {
            if (ok[t] == 0) all_ok = false;
            if (ok[t] == 1 && span_end[t] > last_end) last_end = span_end[t];
        }
        if (all_ok) {
            uint64_t tail_rem = remaining_samples == ~0ull
                ? ~0ull : remaining_samples - total_span_samples;
            uint32_t tail_frames = n_frames - (uint32_t)cands.size();
            if (tail_frames == 0) {
                // frame budget exhausted: sequential loop ends cleanly
                *error = DEC_OK;
                *end_bitpos = last_end * 8;
                return (int64_t)cands.size();
            }
            // trailing bytes / remaining-samples bookkeeping: run the
            // sequential path from the verified end so sync garbage vs
            // clean EOF is classified exactly like nat_decode_frames
            int32_t* dst = out + total_span_samples * channels;
            uint64_t tail_end = 0;
            uint32_t tail_err = DEC_OK;
            int64_t extra = nat_decode_frames(
                buf, buf_bytes, last_end * 8, tail_frames,
                sample_rate, channels, bps, max_block, tail_rem,
                dst, block_sizes + cands.size(), &tail_end, &tail_err);
            *end_bitpos = tail_end;
            *error = tail_err;
            return (int64_t)cands.size() + extra;
        }
        // fall through: the single-thread pump re-validates and, failing
        // that, runs the exact sequential path
    }

    return nat_decode_frames_ilv(buf, buf_bytes, start_bitpos, n_frames,
                                 sample_rate, channels, bps, max_block,
                                 remaining_samples, out, block_sizes,
                                 end_bitpos, error);
}

// Single-thread interleaved decode: the candidate scan breaks the frame
// chain speculatively (exactly like nat_decode_frames_mt), but instead of
// a thread pool, up to four frames decode in lockstep on THIS thread,
// their Rice partitions interleaved through rice_bulk_4w so the
// out-of-order core overlaps four per-symbol dependency chains.  Any
// screen failure, decode error, or tiling mismatch falls back to the
// exact sequential path, so semantics are identical to
// nat_decode_frames.  This recovers most of the Rice decode's chain
// stalls without needing a second core.
int64_t nat_decode_frames_ilv(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t max_block, uint64_t remaining_samples,
    int32_t* out, uint32_t* block_sizes, uint64_t* end_bitpos,
    uint32_t* error) {
    if (!tables_ready) init_tables();
    uint64_t start_byte = start_bitpos >> 3;
    if ((start_bitpos & 7) || buf_bytes < (1u << 14)
        || bytes_left(buf_bytes, start_byte) < (1u << 14))
        return nat_decode_frames(buf, buf_bytes, start_bitpos, n_frames,
                                 sample_rate, channels, bps, max_block,
                                 remaining_samples, out, block_sizes,
                                 end_bitpos, error);

    std::vector<Cand> cands;
    scan_frame_candidates(buf, buf_bytes, start_byte, n_frames, sample_rate,
                          channels, bps, max_block, cands);
    bool fallback = cands.size() < 2 || cands[0].pos != start_byte;

    uint64_t total_span_samples = 0;
    std::vector<uint64_t> sample_off;
    if (!fallback) {
        // short-block / remaining-samples rules need the sequential
        // path's exact error surface; screen cheaply, fall back on any hit
        sample_off.resize(cands.size());
        for (size_t j = 0; j < cands.size(); j++) {
            sample_off[j] = total_span_samples;
            total_span_samples += cands[j].block;
            if (cands[j].block <= 14 && j + 1 < cands.size()) fallback = true;
        }
        if (remaining_samples != ~0ull) {
            if (total_span_samples > remaining_samples) fallback = true;
            if (!cands.empty() && cands.back().block <= 14
                && total_span_samples != remaining_samples)
                fallback = true;
        }
    }

    if (!fallback) {
        uint64_t last_end = 0;
        int64_t got = bps <= 24
            ? pump_decode<int32_t>(buf, buf_bytes, cands, 0, cands.size(),
                                   sample_off, sample_rate, channels, bps,
                                   max_block, out, block_sizes, &last_end)
            : pump_decode<int64_t>(buf, buf_bytes, cands, 0, cands.size(),
                                   sample_off, sample_rate, channels, bps,
                                   max_block, out, block_sizes, &last_end);
        if (got >= 0) {
            uint64_t tail_rem = remaining_samples == ~0ull
                ? ~0ull : remaining_samples - total_span_samples;
            uint32_t tail_frames = n_frames - (uint32_t)cands.size();
            if (tail_frames == 0) {
                *error = DEC_OK;
                *end_bitpos = last_end * 8;
                return (int64_t)cands.size();
            }
            // trailing bytes / remaining-samples bookkeeping: run the
            // sequential path from the verified end so sync garbage vs
            // clean EOF is classified exactly like nat_decode_frames
            int32_t* dst = out + total_span_samples * channels;
            uint64_t tail_end = 0;
            uint32_t tail_err = DEC_OK;
            int64_t extra = nat_decode_frames(
                buf, buf_bytes, last_end * 8, tail_frames,
                sample_rate, channels, bps, max_block, tail_rem,
                dst, block_sizes + cands.size(), &tail_end, &tail_err);
            *end_bitpos = tail_end;
            *error = tail_err;
            return (int64_t)cands.size() + extra;
        }
    }
    return nat_decode_frames(buf, buf_bytes, start_bitpos, n_frames,
                             sample_rate, channels, bps, max_block,
                             remaining_samples, out, block_sizes,
                             end_bitpos, error);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Raw frame parser for the device decode pipeline: validates CRCs and
// extracts warm-up + residual buffers plus predictor parameters WITHOUT
// running the recurrence — the device plane (ops/predict.py) evaluates the
// inverse-LPC scan, wasted-bits shift and stereo decorrelation batched.
// Fixed block size streams only (equal-shape batching); anything else
// falls back to nat_decode_frames / the Python decoder.
// ---------------------------------------------------------------------------

extern "C" {

// Frame-boundary scan for the full-device decode pipeline: finds each
// frame's byte range WITHOUT decoding residuals, so the host's role
// shrinks to sync detection + CRC validation (the device parses frame
// bodies bit-serially in ops/framescan.py).  A frame's end is located
// speculatively: scan for the next byte position that parses as a valid
// frame header (15-bit sync + field validation + streaminfo cross-check +
// CRC-8), then confirm with the current frame's CRC-16 residue over
// [start, end) — a false candidate needs a ~2^-30 coincidence AND a
// passing CRC-16, and any miss falls back to the exact sequential path.
// Per frame outputs: body byte offset (after the header), body length
// excluding the 2 CRC-16 bytes, channel assignment, block size.

// The stream's format, which a candidate's header must match.
struct ScanFmt { uint32_t sample_rate, channels, bps, block_size; };

// True iff byte c starts a frame header that parses and matches fmt.
static inline bool scan_header_at(const uint8_t* buf, uint64_t buf_bytes,
                                  uint64_t c, const ScanFmt& fmt) {
    FastBits h;
    h.init(buf, buf_bytes, c * 8);
    FrameHdr nh;
    return parse_frame_header(h, buf, c, fmt.sample_rate, fmt.bps, &nh)
               == DEC_OK
           && nh.rate == fmt.sample_rate && nh.ch_count == fmt.channels
           && nh.bps == fmt.bps && nh.block_size <= fmt.block_size;
}

// The end of the frame at pos, whose header ends at hdr_end: the first
// sync after the header that starts a matching header and closes a span
// [pos, end) of CRC-16 residue 0.  0 when no candidate does, or after 17
// that fail the CRC (a corrupt region: the host path).  The portable
// loop: a memchr for every 0xFF, each CRC from the frame's start.
static uint64_t frame_end_portable(const uint8_t* buf, uint64_t buf_bytes,
                                   uint64_t pos, uint64_t hdr_end,
                                   const ScanFmt& fmt) {
    uint32_t tries = 0;
    const uint8_t* p = buf + hdr_end;
    const uint8_t* const scan_end = buf + buf_bytes - 1;
    while (p < scan_end) {
        p = (const uint8_t*)memchr(p, 0xFF, scan_end - p);
        if (!p) break;
        uint64_t cand = (uint64_t)(p - buf);
        if ((p[1] & 0xFE) == 0xF8 && scan_header_at(buf, buf_bytes, cand,
                                                    fmt)) {
            if (nat_crc16(buf + pos, cand - pos, 0) == 0) return cand;
            if (++tries > 16) return 0;
        }
        p++;
    }
    return 0;
}

#if defined(FLACNAT_X86)
// Bit i set iff p[i] == 0xFF and p[i + 1] & 0xFE == 0xF8 (a 15-bit
// sync), for i < 32; reads p[0..32].
__attribute__((target("avx2")))
static inline uint32_t sync_mask32(const uint8_t* p) {
    const __m256i x = _mm256_loadu_si256((const __m256i*)p);
    const __m256i y = _mm256_loadu_si256((const __m256i*)(p + 1));
    const __m256i hit = _mm256_and_si256(
        _mm256_cmpeq_epi8(x, _mm256_set1_epi8((char)0xFF)),
        _mm256_cmpeq_epi8(_mm256_and_si256(y, _mm256_set1_epi8((char)0xFE)),
                          _mm256_set1_epi8((char)0xF8)));
    return (uint32_t)_mm256_movemask_epi8(hit);
}

// frame_end_portable's result in one pass over the frame: 64 bytes a
// step, the syncs tested in registers and the bytes folded into four
// CRC chains.  A candidate's residue is the CRC of the folded prefix
// [pos, b) carried over [b, cand) by the table, never re-read from pos.
// The pass asks for the bytes SCAN_PREFETCH ahead of it, across the
// 4 KiB pages where the hardware's stream prefetch stops.
static const uint64_t SCAN_PREFETCH = 2048;

__attribute__((target("avx2,pclmul,ssse3")))
static uint64_t frame_end_simd(const uint8_t* buf, uint64_t buf_bytes,
                               uint64_t pos, uint64_t hdr_end,
                               const ScanFmt& fmt) {
    __m128i a[4];
    for (int i = 0; i < 4; i++) a[i] = _mm_setzero_si128();
    uint32_t tries = 0;
    uint64_t b = pos;
    // whole blocks: a block's last position reads the byte after it
    while (b + 65 <= buf_bytes) {
        // fold the blocks that hold no sync (a tight loop: no calls)
        uint64_t m = 0;
        for (; b + 65 <= buf_bytes; b += 64) {
            if (b + SCAN_PREFETCH < buf_bytes)
                _mm_prefetch((const char*)(buf + b + SCAN_PREFETCH),
                             _MM_HINT_T0);
            m = sync_mask32(buf + b)
                | (uint64_t)sync_mask32(buf + b + 32) << 32;
            if (b < hdr_end)
                m &= hdr_end - b < 64 ? ~0ull << (hdr_end - b) : 0;
            if (m) break;
            crc16_fold4(a, buf + b);
        }
        if (!m) break;
        const uint32_t prefix = crc16_state(crc16_merge4(a));
        for (; m; m &= m - 1) {
            uint64_t cand = b + (uint64_t)__builtin_ctzll(m);
            if (!scan_header_at(buf, buf_bytes, cand, fmt)) continue;
            if (crc16_table(buf + b, cand - b, prefix) == 0) return cand;
            if (++tries > 16) return 0;
        }
        crc16_fold4(a, buf + b);
        b += 64;
    }
    // the last 0-64 bytes, a position at a time
    const uint32_t prefix = crc16_state(crc16_merge4(a));
    for (uint64_t cand = b > hdr_end ? b : hdr_end; cand + 1 < buf_bytes;
         cand++) {
        if (buf[cand] != 0xFF || (buf[cand + 1] & 0xFE) != 0xF8
            || !scan_header_at(buf, buf_bytes, cand, fmt))
            continue;
        if (crc16_table(buf + b, cand - b, prefix) == 0) return cand;
        if (++tries > 16) return 0;
    }
    return 0;
}
#endif  // FLACNAT_X86

// Whether this host takes frame_end_simd (AVX2 and PCLMUL).
static bool scan_simd_host() {
#if defined(FLACNAT_X86)
    return cpu_has_avx2() && cpu_has_clmul();
#else
    return false;
#endif
}

static int64_t scan_frames(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t block_size, uint64_t remaining_samples,
    uint64_t* body_off, uint32_t* body_bytes,
    uint8_t* out_assignment, uint32_t* out_block,
    uint64_t* end_bitpos, uint32_t* error, bool simd) {
    if (!tables_ready) init_tables();
    const ScanFmt fmt = {sample_rate, channels, bps, block_size};
    uint64_t pos = start_bitpos >> 3;
    *error = DEC_OK;
    int64_t found = 0;
    for (uint32_t f = 0; f < n_frames; f++) {
        if (remaining_samples != ~0ull && remaining_samples == 0) {
            *error = DEC_EOF;
            break;
        }
        if (pos >= buf_bytes) { *error = DEC_EOF; break; }
        FastBits g;
        g.init(buf, buf_bytes, pos * 8);
        FrameHdr hdr;
        int hrc = parse_frame_header(g, buf, pos, sample_rate, bps, &hdr);
        if (hrc != DEC_OK) { *error = (uint32_t)hrc; break; }
        if (hdr.rate != sample_rate || hdr.ch_count != channels
            || hdr.bps != bps || hdr.block_size > block_size) {
            *error = DEC_HDR;
            break;
        }
        if (hdr.block_size != block_size) {
            *error = DEC_SHORT_BLOCK;  // short (last) frame: host path
            break;
        }
        if (remaining_samples != ~0ull
            && (hdr.block_size > remaining_samples
                || !(hdr.block_size == remaining_samples
                     || hdr.block_size > 14))) {
            *error = DEC_SHORT_BLOCK;
            break;
        }
        uint64_t hdr_end = g.pos() >> 3;  // headers are whole bytes

        // locate the frame end: next validated header candidate whose
        // span passes the CRC-16 residue check, else the buffer end
#if defined(FLACNAT_X86)
        uint64_t end = simd
            ? frame_end_simd(buf, buf_bytes, pos, hdr_end, fmt)
            : frame_end_portable(buf, buf_bytes, pos, hdr_end, fmt);
#else
        (void)simd;
        uint64_t end = frame_end_portable(buf, buf_bytes, pos, hdr_end, fmt);
#endif
        if (end == 0) {
            // stream-end candidate (last frame in the buffer)
            if (buf_bytes - pos >= 12
                && nat_crc16(buf + pos, buf_bytes - pos, 0) == 0)
                end = buf_bytes;
            else {
                *error = DEC_CRC16;  // or mid-stream corruption: host path
                break;
            }
        }
        body_off[f] = hdr_end;
        body_bytes[f] = (uint32_t)(end - hdr_end - 2);
        out_assignment[f] = (uint8_t)hdr.ca;
        out_block[f] = hdr.block_size;
        pos = end;
        if (remaining_samples != ~0ull) remaining_samples -= hdr.block_size;
        found++;
    }
    *end_bitpos = pos * 8;
    return found;
}

// The scan, in one SIMD pass a frame where the host has AVX2 and PCLMUL
// (nat_scan_simd), else in the portable loop.
int64_t nat_scan_frames(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t block_size, uint64_t remaining_samples,
    uint64_t* body_off, uint32_t* body_bytes,
    uint8_t* out_assignment, uint32_t* out_block,
    uint64_t* end_bitpos, uint32_t* error) {
    return scan_frames(buf, buf_bytes, start_bitpos, n_frames, sample_rate,
                       channels, bps, block_size, remaining_samples,
                       body_off, body_bytes, out_assignment, out_block,
                       end_bitpos, error, scan_simd_host());
}

// The same scan in the portable loop on every host, to hold the SIMD
// pass against.
int64_t nat_scan_frames_portable(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t block_size, uint64_t remaining_samples,
    uint64_t* body_off, uint32_t* body_bytes,
    uint8_t* out_assignment, uint32_t* out_block,
    uint64_t* end_bitpos, uint32_t* error) {
    return scan_frames(buf, buf_bytes, start_bitpos, n_frames, sample_rate,
                       channels, bps, block_size, remaining_samples,
                       body_off, body_bytes, out_assignment, out_block,
                       end_bitpos, error, false);
}

// 1 iff nat_scan_frames takes the SIMD pass on this host.
int32_t nat_scan_simd() { return scan_simd_host() ? 1 : 0; }

static int64_t parse_frames_raw_seq(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t block_size /* expected fixed size; last frame may be short */,
    uint64_t remaining_samples,
    int32_t* out_buf,        // (n_frames, channels, block_size)
    uint8_t* out_order,      // (n_frames, channels)
    int8_t* out_shift,       // (n_frames, channels)
    uint8_t* out_wasted,     // (n_frames, channels)
    int32_t* out_qcoeffs,    // (n_frames, channels, 32)
    uint8_t* out_assignment, // (n_frames,)
    uint32_t* out_block,     // (n_frames,)
    uint64_t* end_bitpos, uint32_t* error) {
    if (!tables_ready) init_tables();
    FastBits g;
    g.init(buf, buf_bytes, start_bitpos);
    static thread_local std::vector<int64_t> chbuf;
    *error = DEC_OK;

    int64_t decoded = 0;
    uint64_t frame_start_byte = g.pos() >> 3;
    for (uint32_t f = 0; f < n_frames; f++) {
        g.align();
        frame_start_byte = g.pos() >> 3;
        if (remaining_samples != ~0ull && remaining_samples == 0) {
            *error = DEC_EOF; break;
        }
        // --- header (shared parser) ---
        FrameHdr hdr;
        int hrc = parse_frame_header(g, buf, frame_start_byte, sample_rate,
                                     bps, &hdr);
        if (hrc != DEC_OK) { *error = (uint32_t)hrc; break; }
        uint32_t fr_block = hdr.block_size, rate = hdr.rate,
                 fbps = hdr.bps, ch_count = hdr.ch_count, ca = hdr.ca;
        // batched device path needs equal shapes + params matching stream
        if (rate != sample_rate || ch_count != channels || fbps != bps
            || fr_block > block_size) { *error = DEC_HDR; break; }
        if (fr_block != block_size) {
            // short (last) frame: leave it to the caller's scalar path
            *error = DEC_SHORT_BLOCK;
            g.set_pos(frame_start_byte * 8);
            break;
        }
        if (fbps >= 32 && ca >= 8) {
            // 33-bit side channels exceed the int32 device buffers: leave
            // the whole frame to the caller's scalar path (rewind!)
            *error = DEC_PARAMS;
            g.set_pos(frame_start_byte * 8);
            break;
        }
        if (remaining_samples != ~0ull
            && (fr_block > remaining_samples   // would underflow the count
                || !(fr_block == remaining_samples || fr_block > 14))) {
            *error = DEC_SHORT_BLOCK;
            g.set_pos(frame_start_byte * 8);
            break;
        }

        if (chbuf.size() < (size_t)ch_count * fr_block)
            chbuf.resize((size_t)ch_count * fr_block);
        int rc = DEC_OK;
        RawSubframe raws[8];
        for (uint32_t c = 0; c < ch_count && rc == DEC_OK; c++) {
            uint32_t sub_bps = fbps;
            if ((ca == 8 && c == 1) || (ca == 9 && c == 0)
                || (ca == 10 && c == 1))
                sub_bps += 1;
            rc = decode_subframe(g, sub_bps, fr_block,
                                 chbuf.data() + (size_t)c * fr_block,
                                 &raws[c]);
        }
        if (rc != DEC_OK) { *error = (uint32_t)rc; break; }
        g.align();
        {
            uint64_t crc_byte = g.pos() >> 3;
            if (!g.fits(16)) { *error = DEC_EOF; break; }
            uint32_t expected = g.get(16);
            if (nat_crc16(buf + frame_start_byte, crc_byte - frame_start_byte,
                          0) != expected) { *error = DEC_CRC16; break; }
        }

        if (fbps >= 26) {
            // the device buffers are int32; residuals of wide streams
            // are int32 for any stream our/the reference encoder emits
            // (their encoders abort on i32 residual overflow), but a
            // hostile valid stream can exceed it — leave such frames to
            // the caller's int64 scalar path instead of wrapping
            bool fits = true;
            for (uint32_t c = 0; c < ch_count && fits; c++) {
                const int64_t* src_ch = chbuf.data() + (size_t)c * fr_block;
                for (uint32_t i = 0; i < fr_block; i++)
                    if (src_ch[i] < INT32_MIN || src_ch[i] > INT32_MAX) {
                        fits = false;
                        break;
                    }
            }
            if (!fits) {
                *error = DEC_PARAMS;
                g.set_pos(frame_start_byte * 8);
                break;
            }
        }
        for (uint32_t c = 0; c < ch_count; c++) {
            size_t fc = (size_t)f * channels + c;
            out_order[fc] = (uint8_t)raws[c].order;
            out_shift[fc] = (int8_t)raws[c].shift;
            out_wasted[fc] = (uint8_t)raws[c].wasted;
            for (uint32_t j = 0; j < 32; j++)
                out_qcoeffs[fc * 32 + j] =
                    j < raws[c].order ? (int32_t)raws[c].q[j] : 0;
            int32_t* dst = out_buf + fc * block_size;
            const int64_t* src_ch = chbuf.data() + (size_t)c * fr_block;
            for (uint32_t i = 0; i < fr_block; i++)
                dst[i] = (int32_t)src_ch[i];
        }
        out_assignment[f] = (uint8_t)ca;
        out_block[f] = fr_block;
        if (remaining_samples != ~0ull) remaining_samples -= fr_block;
        decoded++;
    }
    // on any stop reason, report the failed frame's start (as
    // nat_decode_frames does), so that the caller's host decoder raises
    // that frame's error instead of stepping past it (a CRC-16 failure
    // used to leave the position after the bad frame)
    if (*error != DEC_OK) g.set_pos(frame_start_byte * 8);
    *end_bitpos = g.pos();
    return decoded;
}

// Frames a span must hold for a thread of its own to pay for its start
// and join: the auto thread count is min(usable CPUs, K / this).
static const size_t RAW_SPAN_FRAMES = 16;

// The CPUs this process may run on (its affinity mask), at least 1.
static uint32_t usable_cpus() {
#ifdef __linux__
    cpu_set_t set;
    if (sched_getaffinity(0, sizeof(set), &set) == 0)
        return std::max(1, CPU_COUNT(&set));
#endif
    return std::max(1u, std::thread::hardware_concurrency());
}

// Dispatcher: the lockstep raw pump handles the uniform-block prefix of
// the stream (four frames in flight, residuals written straight into the
// int32 device panels), then the sequential raw parser classifies
// whatever follows — a short last frame, garbage, EOF — with exactly the
// error surface the pure sequential run would produce.  The prefix is cut
// into contiguous spans of about equal bytes, each pumped on a thread of
// its own (nthreads: 0 = min(usable CPUs, K / RAW_SPAN_FRAMES), else at
// most that many spans).  Where a span fails, the rows it may have written
// are zeroed and the one-thread pump runs the whole prefix, so zeroed
// outputs come back exactly as the one-thread call leaves them; any
// screen failure or speculation mismatch there falls back to the
// sequential parser for the whole range.  *spans is the spans that parsed
// the prefix: 0 for the sequential parser, 1 for the one-thread pump.
int64_t nat_parse_frames_raw(
    const uint8_t* buf, uint64_t buf_bytes, uint64_t start_bitpos,
    uint32_t n_frames, uint32_t sample_rate, uint32_t channels, uint32_t bps,
    uint32_t block_size, uint64_t remaining_samples,
    int32_t* out_buf, uint8_t* out_order, int8_t* out_shift,
    uint8_t* out_wasted, int32_t* out_qcoeffs, uint8_t* out_assignment,
    uint32_t* out_block, uint64_t* end_bitpos, uint32_t* error,
    uint32_t nthreads, uint32_t* spans) {
    if (!tables_ready) init_tables();
    *spans = 0;
    uint64_t start_byte = start_bitpos >> 3;
    // int32 panels need bps + the mid/side extra bit < 26 wide warm-ups;
    // wider streams keep the sequential parser's int64 fit-check.
    // channels > 2 streams are rare enough to skip the pump's 8-channel
    // raws bookkeeping... they are supported (raws[8]); gate only width.
    if (!(start_bitpos & 7) && bps < 26 && channels <= 8
        && block_size > 14 && buf_bytes >= (1u << 14)
        && bytes_left(buf_bytes, start_byte) >= (1u << 14)
        && !getenv("FLAC_TPU_NO_ILV")) {
        std::vector<Cand> cands;
        scan_frame_candidates(buf, buf_bytes, start_byte, n_frames,
                              sample_rate, channels, bps, block_size, cands);
        size_t K = 0;  // uniform-block prefix is the pumpable span
        while (K < cands.size() && cands[K].block == block_size) K++;
        if (remaining_samples != ~0ull
            && K > remaining_samples / block_size)
            K = remaining_samples / block_size;
        if (K >= 2 && cands[0].pos == start_byte) {
            uint32_t nt = nthreads ? nthreads
                : (uint32_t)std::min<size_t>(usable_cpus(),
                                             K / RAW_SPAN_FRAMES);
            nt = (uint32_t)std::min<size_t>(nt, K);
            std::vector<size_t> split;
            if (nt >= 2) split = split_spans(cands, K, nt);
            cands.resize(K);
            auto pump = [&](size_t j0, size_t j1, uint64_t* end) {
                return pump_parse_raw(
                    buf, buf_bytes, cands, j0, j1, sample_rate, channels,
                    bps, block_size, out_buf, out_order, out_shift,
                    out_wasted, out_qcoeffs, out_assignment, out_block,
                    end) >= 0;
            };
            uint64_t last_end = 0;
            bool ok = false;
            if (nt >= 2) {
                std::vector<uint8_t> span_ok(nt, 1);
                std::vector<uint64_t> span_end(nt, 0);
                span_pool().run(nt, [&](uint32_t t) {
                    if (split[t] < split[t + 1])
                        span_ok[t] = pump(split[t], split[t + 1],
                                          &span_end[t]);
                });
                ok = true;
                for (uint32_t t = 0; t < nt; t++) {
                    ok = ok && span_ok[t];
                    if (split[t] < split[t + 1]) {
                        last_end = span_end[t];
                        ++*spans;
                    }
                }
                if (!ok) {
                    *spans = 0;
                    size_t fc = K * channels;
                    memset(out_buf, 0, fc * block_size * sizeof(int32_t));
                    memset(out_order, 0, fc);
                    memset(out_shift, 0, fc);
                    memset(out_wasted, 0, fc);
                    memset(out_qcoeffs, 0, fc * 32 * sizeof(int32_t));
                    memset(out_assignment, 0, K);
                    memset(out_block, 0, K * sizeof(uint32_t));
                }
            }
            if (!ok && pump(0, K, &last_end)) {
                ok = true;
                *spans = 1;
            }
            if (ok) {
                uint64_t done_samples = (uint64_t)K * block_size;
                uint64_t tail_rem = remaining_samples == ~0ull
                    ? ~0ull : remaining_samples - done_samples;
                uint32_t tail_frames = n_frames - (uint32_t)K;
                if (tail_frames == 0) {
                    *error = DEC_OK;
                    *end_bitpos = last_end * 8;
                    return (int64_t)K;
                }
                uint64_t tail_end = 0;
                uint32_t tail_err = DEC_OK;
                int64_t extra = parse_frames_raw_seq(
                    buf, buf_bytes, last_end * 8, tail_frames, sample_rate,
                    channels, bps, block_size, tail_rem,
                    out_buf + (size_t)K * channels * block_size,
                    out_order + (size_t)K * channels,
                    out_shift + (size_t)K * channels,
                    out_wasted + (size_t)K * channels,
                    out_qcoeffs + (size_t)K * channels * 32,
                    out_assignment + K, out_block + K,
                    &tail_end, &tail_err);
                *end_bitpos = tail_end;
                *error = tail_err;
                return (int64_t)K + extra;
            }
        }
    }
    return parse_frames_raw_seq(buf, buf_bytes, start_bitpos, n_frames,
                                sample_rate, channels, bps, block_size,
                                remaining_samples, out_buf, out_order,
                                out_shift, out_wasted, out_qcoeffs,
                                out_assignment, out_block, end_bitpos,
                                error);
}

}  // extern "C"
