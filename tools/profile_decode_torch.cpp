// Standalone profiling harness for the port's native decoder hot path:
// tools/profile_decode.cpp built on flac_codec_tpu_torch's own copy of
// the engine (the one whose nat_decode_frames_mt checks the bytes left
// before it scans, flacnat.cpp's bytes_left).
//
//   g++ -O3 -g -o flac_codec_tpu_torch/build/profile_decode_torch \
//       tools/profile_decode_torch.cpp -lpthread
//   flac_codec_tpu_torch/build/profile_decode_torch stream.flac 40
//   (gprofng collect app -o prof.er <binary> stream.flac 40;
//    gprofng display text -functions prof.er | head -40)
//
// Includes flacnat.cpp directly so the anonymous-namespace internals are
// visible; decodes the stream's frame section repeatedly on one thread
// and prints MB/s of PCM of the best pass.  Used to find where the
// host-decode time goes (Rice vs predict vs CRC vs header walk).  The
// benchmark's 24 s stream (bench_torch.bench_stream, cached under
// flac_codec_tpu_torch/build/bench_cache/) is the one
// decode_host_mbps_per_core reads.

#include "../flac_codec_tpu_torch/native/flacnat.cpp"

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char** argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s stream.flac [reps]\n", argv[0]);
        return 2;
    }
    FILE* f = fopen(argv[1], "rb");
    if (!f) { perror("open"); return 2; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(sz);
    if (fread(buf.data(), 1, sz, f) != (size_t)sz) return 2;
    fclose(f);
    int reps = argc > 2 ? atoi(argv[2]) : 20;

    // walk metadata blocks: fLaC + blocks until last-flag
    if (memcmp(buf.data(), "fLaC", 4) != 0) { fprintf(stderr, "not flac\n"); return 2; }
    size_t pos = 4;
    uint32_t srate = 0, chans = 0, bps = 0, bsize = 0;
    uint64_t total = 0;
    for (;;) {
        uint8_t hdr = buf[pos];
        uint32_t len = (buf[pos+1] << 16) | (buf[pos+2] << 8) | buf[pos+3];
        if ((hdr & 0x7f) == 0) {  // STREAMINFO
            const uint8_t* p = buf.data() + pos + 4;
            bsize = (p[0] << 8) | p[1];
            srate = (p[10] << 12) | (p[11] << 4) | (p[12] >> 4);
            chans = ((p[12] >> 1) & 7) + 1;
            bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
            total = ((uint64_t)(p[13] & 0x0f) << 32) | ((uint64_t)p[14] << 24)
                  | (p[15] << 16) | (p[16] << 8) | p[17];
        }
        pos += 4 + len;
        if (hdr & 0x80) break;
    }
    fprintf(stderr, "rate=%u ch=%u bps=%u block=%u total=%llu frames@%zu\n",
            srate, chans, bps, bsize, (unsigned long long)total, pos);

    std::vector<int32_t> out(total * chans);
    std::vector<uint32_t> sizes(total / bsize + 2);
    uint32_t error = 0;
    double mb = total * chans * (bps > 16 ? 4.0 : 2.0) / 1e6;
    double best = 1e30;
    for (int r = 0; r < reps; r++) {
        uint64_t end_bitpos = 0;
        error = 0;
        auto t0 = std::chrono::steady_clock::now();
        // the production entry (native/__init__.py decode_frames); with
        // nthreads=1 it takes the same sequential path the bench measures
        int64_t n = nat_decode_frames_mt(
            buf.data(), sz, pos * 8, 1000000, srate, chans, bps, bsize,
            (int64_t)total, out.data(), sizes.data(), &end_bitpos, &error, 1);
        auto t1 = std::chrono::steady_clock::now();
        double dt = std::chrono::duration<double>(t1 - t0).count();
        if (r == 0)
            fprintf(stderr, "decoded %lld frames err=%d\n", (long long)n,
                    error);
        if (dt < best) best = dt;
    }
    printf("host decode: %.1f MB/s PCM (best of %d)\n", mb / best, reps);
    return 0;
}
