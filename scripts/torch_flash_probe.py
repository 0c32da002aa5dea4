#!/usr/bin/env python3
"""Where the tensor-core flash kernels (B5, B6 and B7 in the bf16 operand
mode) spend the card's time.

    python3 scripts/torch_flash_probe.py

On the GPU, prints the card's name and power limit, then:

- sweep: device microseconds a launch (torch.profiler over 20 calls) of
  ``flash_fwd`` (B5), ``flash_bwd_dq`` (B6) and ``flash_bwd_dkv`` (B7) in
  the bf16 operand mode, and of SDPA's bf16 forward and backward (every
  kernel of the call) as yardsticks, at mup-gpt's train shape (8,
  512, 16 heads of 64, causal, f32) and beside it: bf16 storage, no causal
  mask (all tiles full), B = 1 (one wave of blocks: the longest block's
  time), B = 64 (many waves), d_head 32 and 128, S = 2048;
- phases: B5's clock64 cycles a 128-key tile by phase (q k^T, the softmax,
  p v, and the barriers with the rounding of the next staged tile), and
  each block's cycles in all (its items' q loads and epilogues included),
  read by thread 0 of every block from a copy of csrc/flash_attention.cu
  with clock64 reads put in (built under build/flash_probe/ with nvcc; the
  times are when instructions start, so a phase's wait for an earlier
  phase's products lands in the later phase), at the train shape in f32
  and bf16 storage and at B = 1.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

# (anchor in flash_fwd_tc_kernel, text put before or after it)
PROBES = [
    ("  uint64_t* staged = cv.take<uint64_t>(2);   // k and v; q\n",
     "  long long ph[7] = {0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n", "after"),
    ("    const FwdItem f = fwd_item(i, p);\n    const int q0 = f.q0;\n",
     "    const long long ti0 = clock64();\n", "after"),
    ("    for (int kt = f.kr.x; kt < f.kr.y; ++kt) {   // Kb and Vb hold (i, kt)\n",
     "    const long long ti1 = clock64();\n    ph[5] += ti1 - ti0;\n", "before"),
    ("    // o = acc / max(l, 1e-30) in o's type, lse = m + log(max(l, 1e-30))\n",
     "    const long long te0 = clock64();\n", "before"),
    ("      const int k0 = kt * kFwdBK;\n\n      float s[NT][4];",
     None, None),
    ("      // the online softmax of each row over its four lanes",
     "      const long long t1 = clock64();\n", "before"),
    ("      // acc += p v, keys 16 kk.. of p's accumulator layout packed as A",
     "      const long long t2 = clock64();\n", "before"),
    ("      if (ni < items) {   // the stream goes on",
     "      const long long t3 = clock64();\n", "before"),
    ("        if (ni < items) stage_kv(ni, nkt);\n      }\n",
     "      const long long t4 = clock64();\n      ph[0] += t1 - t0; ph[1] += t2 - t1;"
     " ph[2] += t3 - t2; ph[3] += t4 - t3; ph[4] += 1;\n", "after"),
    ("      if (tq == 0) lse[((size_t)f.b * p.H + f.h) * p.S + row] = m[r] + logf(lc);\n"
     "    }\n",
     "    ph[6] += clock64() - te0;\n", "after"),
    ("    ph[6] += clock64() - te0;\n  }\n",
     "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 7; ++i) g_phases[blockIdx.x][i] = ph[i];\n"
     "    g_phases[blockIdx.x][7] = clock64() - tk0;\n  }\n", "after"),
]
PHASES = ("q k^T", "softmax", "p v", "barriers, rounding")


def log(*a):
    print(*a, flush=True)


def dev_us(fn, key, n=20, tries=3, per_call=False):
    """Device microseconds a launch of the kernels whose name holds ``key``
    (torch.profiler over ``n`` calls; a profile that caught none of them is
    taken again); with ``per_call``, a call's sum over them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
        if hits:
            return sum(e.self_device_time_total for e in hits) / (
                n if per_call else sum(e.count for e in hits))
    raise SystemExit(f"torch_flash_probe: the profiler saw no kernel {key!r}")


def sweep():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.quant import QuantPolicy

    F = torch.nn.functional
    policy = QuantPolicy("bf16")
    for B, S, d, dt, causal in [(8, 512, 64, torch.float32, True),
                                (8, 512, 64, torch.bfloat16, True),
                                (8, 512, 64, torch.float32, False),
                                (1, 512, 64, torch.float32, True),
                                (64, 512, 64, torch.float32, True),
                                (8, 512, 32, torch.float32, True),
                                (8, 512, 128, torch.float32, True),
                                (8, 2048, 64, torch.float32, True)]:
        H = 16
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt)
                       for _ in range(4))
        q = (q.float() * d ** -0.5).to(dt)
        kw = dict(causal=causal, policy=policy)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        b5 = dev_us(lambda: fa.flash_fwd(q, k, v, **kw), "flash_fwd_tc_kernel")
        b6 = dev_us(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    "flash_bwd_dq_tc_kernel")
        b7 = dev_us(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                    "flash_bwd_dkv_tc_kernel")
        qb, kb, vb = (t.transpose(1, 2).bfloat16().contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dob = do.transpose(1, 2).bfloat16().contiguous()
        with torch.no_grad():
            sdpa = dev_us(lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=causal), "")
        ob = F.scaled_dot_product_attention(qb, kb, vb, is_causal=causal)
        sdpa_bwd = dev_us(lambda: torch.autograd.grad(ob, (qb, kb, vb), dob, retain_graph=True),
                          "", per_call=True)
        pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
        log(f"[sweep] B={B} S={S} H={H} d={d} {str(dt)[6:]} storage, causal={causal}: "
            f"B5 {b5:.1f} us ({4 * d * pairs / b5 / 1e6:.1f} TFLOP/s), B6 {b6:.1f} us "
            f"({6 * d * pairs / b6 / 1e6:.1f} TFLOP/s), B7 {b7:.1f} us "
            f"({8 * d * pairs / b7 / 1e6:.1f} TFLOP/s), SDPA bf16 forward {sdpa:.1f} us, "
            f"backward {sdpa_bwd:.1f} us a call")


def phases():
    from repro_torch.kernels import build, flash_attention as fa
    from repro_torch.quant import QuantPolicy

    src = (CSRC / "flash_attention.cu").read_text()
    for anchor, text, where in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_flash_probe: the source changed; anchor not found once: "
                             f"{anchor[:60]!r}")
        if text is None:   # the loop's first line: the tile's start time after it
            src = src.replace(anchor, anchor.replace(
                "\n\n      float s", "\n      const long long t0 = clock64();\n\n      float s"))
        else:
            src = src.replace(anchor, anchor + text if where == "after" else text + anchor)
    src = src.replace("namespace {\n", "__device__ long long g_phases[16384][8];\nnamespace {\n", 1)
    src += ('\nextern "C" int repro_flash_phases(void* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));\n}\n')
    out = ROOT / "build" / "flash_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(src)
    for h in ("dtype.cuh", "mma.cuh"):
        shutil.copy(CSRC / h, out / h)
    lib_path = out / "libflash_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(out / "flash_attention.cu"),
                    "-o", str(lib_path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_fwd.argtypes = [P] * 5 + [I] * 6 + [Fl, I, I, Fl, I, I, P]
    lib.repro_flash_fwd.restype = I
    for B, dt in ((8, torch.float32), (8, torch.bfloat16), (1, torch.float32)):
        S, H, d = 512, 16, 64
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt) for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(B, H, S, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            err = lib.repro_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      lse.data_ptr(), B, S, S, H, H, d, 0.125, 1, 0, 0.0, 1,
                                      0 if dt == torch.float32 else 1, stream)
            if err:
                raise SystemExit(f"torch_flash_probe: CUDA error {err}")
        torch.cuda.synchronize()
        buf = np.zeros((16384, 8), dtype=np.int64)
        if lib.repro_flash_phases(buf.ctypes.data_as(ctypes.c_void_p)):
            raise SystemExit("torch_flash_probe: reading the phases failed")
        items = (S + 127) // 128 * B * H
        blocks = min(items, torch.cuda.get_device_properties(0).multi_processor_count)
        x = buf[:blocks]
        tiles = x[:, 4].sum()
        log(f"[phases] B5 at ({B}, {S}, {H}, {d}) {str(dt)[6:]} storage, causal: {items} "
            f"items on {blocks} blocks, {tiles} tiles; cycles a tile: "
            + ", ".join(f"{n} {x[:, i].sum() / tiles:.0f}" for i, n in enumerate(PHASES))
            + f"; an item's q and set-up {x[:, 5].sum() / items:.0f}, its epilogue "
            f"{x[:, 6].sum() / items:.0f}; a block {x[:, 7].mean():.0f} on average, "
            f"{x[:, 7].max()} at most")


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_flash_probe: needs a CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip())
    sweep()
    phases()


if __name__ == "__main__":
    main()
