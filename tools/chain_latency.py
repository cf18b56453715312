"""Latency of the integer instructions on K3's critical path, on one GPU.

    python tools/chain_latency.py

Builds a few one-warp kernels with ``nvcc`` (``sm_90a``), each a loop of
dependent operations timed with ``clock64()``, and prints the cycles one
operation of each chain takes, beside the SASS opcodes the chain compiled
to (``cuobjdump``).  The chains are the pieces of one step of
``flac_codec_tpu_torch/csrc/predict_lpc.cu``: a 32-bit add, a 32x32+64
multiply-add (``mad.wide.s32``), the low word of a 64-bit arithmetic
shift, and whole steps of the recurrence.  K3's latency bound is the
cycles of one step's dependent chain times 4096 steps, at the SM clock.
Exits non-zero without a GPU or ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

SRC = r"""
#include <cstdint>
__device__ __forceinline__ uint64_t mad_wide(int32_t a, int32_t b,
                                             uint64_t c) {
  uint64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}
#define STEPS 4096
#define TIMED(name, init, body, result)                                   \
  extern "C" __global__ void name(const int32_t* in, long long* cycles,   \
                                  int64_t* sink) {                        \
    int32_t r[8];                                                         \
    for (int i = 0; i < 8; ++i) r[i] = in[threadIdx.x * 8 + i];           \
    const unsigned s = static_cast<unsigned>(in[256]) & 15u;              \
    init;                                                                 \
    const long long t0 = clock64();                                       \
    _Pragma("unroll 1") for (int n = 0; n < STEPS; n += 32) {           \
      _Pragma("unroll") for (int i = 0; i < 32; ++i) { body; }            \
    }                                                                     \
    const long long t1 = clock64();                                       \
    sink[threadIdx.x] = (result);                                         \
    if (threadIdx.x == 0) cycles[0] = t1 - t0;                            \
  }
// two 32-bit ALU operations a step, a logic op then an add, which no
// instruction fuses (LOP3, IADD3)
TIMED(chain_alu, int32_t v = r[0], v = (v ^ r[i & 7]) + r[(i + 3) & 7], v)
// a 32x32+64 multiply-add, fed back through its low word
TIMED(chain_imad_wide, uint64_t a = r[1],
      a = mad_wide(r[i & 7], static_cast<int32_t>(a), a), a)
// the low word of a 64-bit arithmetic shift, fed back into the low word
TIMED(chain_shf64, int32_t v = r[2],
      v = static_cast<int32_t>(
          static_cast<int64_t>((static_cast<uint64_t>(r[i & 7]) << 32) |
                               static_cast<uint32_t>(v)) >> s), v)
// one step of the recurrence as K3 writes it: the sum of the step,
// shifted, plus the residual; the older taps' partial sums come from
// registers (off the chain)
TIMED(chain_step, int32_t v = r[3],
      v = r[i & 7] + static_cast<int32_t>(
          static_cast<int64_t>(mad_wide(r[(i + 3) & 7], v,
                                        static_cast<uint64_t>(r[(i + 5) & 7])
                                            << 7)) >> s), v)
// issue, not latency: eight independent multiply-adds a step, as the
// taps of one step are, in the integer pipe and in the FP64 pipe
TIMED(issue_imad_wide,
      uint64_t a[8];
      for (int k = 0; k < 8; ++k) a[k] = r[k],
      for (int k = 0; k < 8; ++k)
          a[k] = mad_wide(r[(i + k) & 7], n + i, a[k]),
      a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4] ^ a[5] ^ a[6] ^ a[7])
TIMED(issue_dfma,
      double a[8];
      double w = r[4];
      for (int k = 0; k < 8; ++k) a[k] = r[k],
      w += 1.0;
      for (int k = 0; k < 8; ++k) a[k] = fma(a[k], 0.5, w),
      static_cast<int64_t>(a[0] + a[1] + a[2] + a[3] + a[4] + a[5] + a[6] +
                           a[7]))
"""

# (kernel, what one step of its chain is, the opcode whose latency it
# measures, or None for a whole step)
KERNELS = (("chain_alu", "32-bit xor then add", None),
           ("chain_imad_wide", "mad.wide.s32 fed back through its low word",
            "IMAD.WIDE"),
           ("chain_shf64", "low word of a 64-bit arithmetic shift",
            "SHF.R.S64"),
           ("chain_step", "K3 step: mad.wide.s32, shift, add", None),
           ("issue_imad_wide", "8 independent mad.wide.s32 (issue, not "
            "latency)", "IMAD.WIDE"),
           ("issue_dfma", "8 independent FP64 fma (issue, not latency)",
            "DFMA"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_latency.py needs a CUDA GPU", file=sys.stderr)
        return 1
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
    if nvcc is None:
        print("chain_latency.py needs nvcc", file=sys.stderr)
        return 1
    tmp = tempfile.mkdtemp(prefix="chain_latency_")
    try:
        src = os.path.join(tmp, "chains.cu")
        cubin = os.path.join(tmp, "chains.cubin")
        with open(src, "w") as f:
            f.write(SRC)
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o", cubin,
                        src], check=True)
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
             cubin], capture_output=True, text=True, check=True).stdout
        ops = {}
        for fn in re.split(r"\n\s+Function : ", sass)[1:]:
            name = fn.split()[0]
            ops[name] = collections.Counter(re.findall(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                fn)).most_common(8)
        # torch makes the device's primary context current; the driver
        # API loads the cubin into it
        torch.zeros(1, device="cuda")
        cuda = ctypes.CDLL("libcuda.so.1")
        module = ctypes.c_void_p()
        if cuda.cuModuleLoad(ctypes.byref(module), cubin.encode()) != 0:
            raise RuntimeError("cuModuleLoad failed")
        gen = torch.Generator().manual_seed(3)
        data = torch.randint(-1000, 1000, (264,), generator=gen,
                             dtype=torch.int32).cuda()
        data[256] = 5
        cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
        sink = torch.zeros(32, dtype=torch.int64, device="cuda")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        for name, what, opcode in KERNELS:
            fn = ctypes.c_void_p()
            if cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                        name.encode()) != 0:
                raise RuntimeError(f"no kernel {name}")
            args = [ctypes.c_void_p(t.data_ptr())
                    for t in (data, cycles, sink)]
            argv = (ctypes.c_void_p * 3)(
                *[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p)
                  for a in args])
            best = None
            for _ in range(5):
                rc = cuda.cuLaunchKernel(fn, 1, 1, 1, 32, 1, 1, 0, None,
                                         argv, None)
                if rc != 0:
                    raise RuntimeError(f"cuLaunchKernel {name}: {rc}")
                torch.cuda.synchronize()
                c = int(cycles.item()) / 4096
                best = c if best is None else min(best, c)
            hist = dict(ops.get(name, ()))
            # the loop body is unrolled 32 steps: an opcode's count in the
            # function, over 32, is its count a step (the prologue holds
            # next to none of these)
            per_op = (best * 32 / hist[opcode]
                      if opcode and hist.get(opcode) else None)
            print(json.dumps({"chain": name, "what": what,
                              "cycles_per_step": best, "opcode": opcode,
                              "cycles_per_opcode": per_op,
                              "sass": ops.get(name), "card": card}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
