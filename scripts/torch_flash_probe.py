#!/usr/bin/env python3
"""Where the flash kernels spend the card's time: B5, B6 and B7 in the bf16
operand mode (the tensor-core kernels) and in the int8 mode, and B2
(RMSNorm's backward) beside them.

    python3 scripts/torch_flash_probe.py [--src DIR] [--only sweep|phases]

Imports the port from ``DIR`` (default: this checkout's ``src``), so that
an older tree unpacked beside it can be probed by the same script in the
same call.  On the GPU, prints the card's name and power limit, then:

- sweep: first B2 at mup-gpt's train shape x (8, 512, 1024), f32 and
  bf16: each of its kernels' device microseconds and launches a call (one
  row kernel and a column sum in an older tree, one launch in this one),
  beside the autograd backward of ``F.rms_norm``; then device
  microseconds a launch (torch.profiler over 20 calls) of
  ``flash_fwd`` (B5), ``flash_bwd_dq`` (B6) and ``flash_bwd_dkv`` (B7) in
  the bf16 operand mode, of B5, B6 and B7 in the int8 mode, of the int8
  backward's quantization pre-pass where the tree has one
  (``flash_quant_i8_kernel``) and the forward's
  (``flash_quant_fwd_i8_kernel``), the whole int8 forward a call, and of
  SDPA's bf16 forward and backward
  (every kernel of the call) as yardsticks, at mup-gpt's train shape (8,
  512, 16 heads of 64, causal, f32) and beside it: bf16 storage, no causal
  mask (all tiles full), B = 1 (one wave of blocks: the longest block's
  time), B = 64 (many waves), d_head 32 and 128, S = 2048;
- phases: clock64 cycles by phase, read by thread 0 of every block from a
  copy of csrc/flash_attention.cu with clock64 reads put in at anchors
  (built under build/flash_probe/ with nvcc; the times are when
  instructions start, so a phase's wait for an earlier phase's products
  lands in the later phase).  B5 (bf16 operands): a 128-key tile's q k^T,
  softmax, p v, and the barriers with the rounding of the next staged
  tile, each block's cycles in all.  B6 and B7 (int8 operands), per tile
  of 128 keys (B6) or 128 queries (B7): in the ``__dp4a`` kernels the
  quantization of rows and of columns inside the block, the products over
  d, the p/ds step with its quantization, the products over the tile and
  the barriers; in the tensor-core kernels the wait for the tile's copies
  with its barrier, the products over d with the p/ds step (in B7 with
  p's quantization), the quantization of ds into fragments, the products
  over the tile and the barrier that frees the buffer.  B5 in the int8
  mode: in the ``__dp4a`` kernel k and v quantized into shared memory,
  q·kᵀ, the softmax with p's quantization, p·v and the barriers; in the
  tensor-core kernel the wait for the tile's copies with its barrier, q·kᵀ
  (with the logits), the softmax with p's quantization into fragments, p·v
  with its rescale and the barrier.  Each kernel's anchors must
  match its source (the script stops if no anchor set does), at the train
  shape in f32 and bf16 storage and at B = 1.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
NSLOT = 16384            # blocks a kernel's phase table holds

# B5 (flash_fwd_tc_kernel): (anchor, text put before or after it)
B5_PROBES = [
    ("  uint64_t* staged = cv.take<uint64_t>(2);   // k and v; q\n",
     "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n",
     "after"),
    ("    const FwdItem f = fwd_item(i, p);\n    const int q0 = f.q0;\n",
     "    const long long ti0 = clock64();\n", "after"),
    ("    for (int kt = f.kr.x; kt < f.kr.y; ++kt) {   // Kb and Vb hold (i, kt)\n",
     "    const long long ti1 = clock64();\n    ph[5] += ti1 - ti0;\n", "before"),
    ("    // o = acc / max(l, 1e-30) in o's type, lse = m + log(max(l, 1e-30))\n",
     "    const long long te0 = clock64();\n", "before"),
    ("      const int k0 = kt * kFwdBK;\n\n      float s[NT][4];",
     "      const int k0 = kt * kFwdBK;\n      const long long t0 = clock64();\n\n"
     "      float s[NT][4];", "replace"),
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
     "  PROBE_SAVE(0, blockIdx.x);\n", "after"),
]
B5_PHASES = ("q k^T", "softmax", "p v", "barriers, rounding")

# B6 and B7 in the int8 mode as first written (__dp4a, every operand
# quantized inside the block; an older tree has them): ph[0] rows, [1] columns, [2] products over
# d, [3] p/ds and its quantization, [4] products over the tile, [5]
# barriers, [6] tiles
DQ_DP4A = [
    ("  const int nk = (p.T + kI8 - 1) / kI8;\n  for (int kt = 0; kt < nk; ++kt) {\n"
     "    const int k0 = kt * kI8;\n    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;\n"
     "    __syncthreads();\n",
     "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n"
     "  const int nk = (p.T + kI8 - 1) / kI8;\n  for (int kt = 0; kt < nk; ++kt) {\n"
     "    const int k0 = kt * kI8;\n    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;\n"
     "    const long long t0 = clock64();\n    __syncthreads();\n"
     "    const long long tA = clock64();\n", "replace"),
    ("    quant_cols<T, DP>(reinterpret_cast<int8_t*>(kT8), 4 * kLTW, skc, red, kb, kstride, k0,\n"
     "                      kvalid, p.d);\n    __syncthreads();\n",
     "    const long long tB = clock64();\n"
     "    quant_cols<T, DP>(reinterpret_cast<int8_t*>(kT8), 4 * kLTW, skc, red, kb, kstride, k0,\n"
     "                      kvalid, p.d);\n    const long long tC = clock64();\n"
     "    __syncthreads();\n    const long long tD = clock64();\n", "replace"),
    ("    float sds[4];\n", "    const long long tE = clock64();\n", "before"),
    ("      for (int j = 0; j < KJ; ++j) ds8b[r * 4 * kLTW + tx + 16 * j] = quant(ds[j], sds[i]);\n"
     "    }\n    __syncthreads();\n",
     "      for (int j = 0; j < KJ; ++j) ds8b[r * 4 * kLTW + tx + 16 * j] = quant(ds[j], sds[i]);\n"
     "    }\n    const long long tF = clock64();\n    __syncthreads();\n"
     "    const long long tG = clock64();\n", "replace"),
    ("rescale(ai[i][j], sds[i], skc[tx + 16 * j]));\n  }\n",
     "rescale(ai[i][j], sds[i], skc[tx + 16 * j]));\n"
     "    const long long tH = clock64();\n"
     "    ph[0] += tB - tA; ph[1] += tC - tB; ph[2] += tE - tD; ph[3] += tF - tE;\n"
     "    ph[4] += tH - tG; ph[5] += (tA - t0) + (tD - tC) + (tG - tF); ph[6] += 1;\n"
     "  }\n  PROBE_SAVE(1, PROBE_BLOCK);\n", "replace"),
]
DKV_DP4A = [
    ("      if (!tile_visible(q0, kI8, k0, kBK, p)) continue;\n"
     "      __syncthreads();   // the previous tile's readers are done\n",
     "      if (!tile_visible(q0, kI8, k0, kBK, p)) continue;\n"
     "      const long long t0 = clock64();\n"
     "      __syncthreads();   // the previous tile's readers are done\n"
     "      const long long tA = clock64();\n", "replace"),
    ("  const int nq = (p.S + kI8 - 1) / kI8;\n  for (int g = 0; g < G; ++g) {\n",
     "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n",
     "before"),
    ("      quant_cols<T, DP>(reinterpret_cast<int8_t*>(qT8), ",
     "      const long long tB = clock64();\n", "before"),
    ("      for (int r = threadIdx.x; r < kI8; r += kThreads) {\n"
     "        lse_s[r] = r < qvalid ? lse_b[q0 + r] : 0.f;\n"
     "        delta_s[r] = r < qvalid ? delta_b[q0 + r] : 0.f;\n      }\n      __syncthreads();\n",
     "      for (int r = threadIdx.x; r < kI8; r += kThreads) {\n"
     "        lse_s[r] = r < qvalid ? lse_b[q0 + r] : 0.f;\n"
     "        delta_s[r] = r < qvalid ? delta_b[q0 + r] : 0.f;\n      }\n"
     "      const long long tC = clock64();\n      __syncthreads();\n"
     "      const long long tD = clock64();\n", "replace"),
    ("      float spT[4], sdsT[4];\n", "      const long long tE = clock64();\n", "before"),
    ("          dsT8b[kr * 4 * kLTW + tx + 16 * j] = quant(ds[j], sdsT[i]);\n        }\n"
     "      }\n      __syncthreads();\n",
     "          dsT8b[kr * 4 * kLTW + tx + 16 * j] = quant(ds[j], sdsT[i]);\n        }\n"
     "      }\n      const long long tF = clock64();\n      __syncthreads();\n"
     "      const long long tG = clock64();\n", "replace"),
    ("          dk_acc[i][j] = __fadd_rn(dk_acc[i][j], rescale(ak[i][j], sdsT[i], sqc[c]));\n"
     "        }\n",
     "      {\n      const long long tH = clock64();\n"
     "      ph[0] += tB - tA; ph[1] += tC - tB; ph[2] += tE - tD; ph[3] += tF - tE;\n"
     "      ph[4] += tH - tG; ph[5] += (tA - t0) + (tD - tC) + (tG - tF); ph[6] += 1;\n"
     "      }\n", "after"),
    ("ph[6] += 1;\n      }\n    }\n  }\n", "  PROBE_SAVE(2, PROBE_BLOCK);\n", "after"),
]
DP4A_PHASES = ("quantize rows", "quantize columns", "products over d",
               "p/ds and its quantization", "products over the tile", "barriers")

# the same two kernels on the s8 tensor cores, fed by the pre-pass: ph[0]
# the wait for the tile's copies and its barrier, [1] products over d with
# the p/ds step, [2] the quantization of p and ds into A fragments, [3]
# products over the tile with their rescale, [4] the barrier that frees
# the tile's buffer, [6] tiles
# (the kernels mark these places with "// [probe] ..." comments)
DQ_TC = [
    ("  // [probe] B6 start\n",
     "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n",
     "replace"),
    ("    // [probe] B6 tile start\n", "    const long long t0 = clock64();\n", "replace"),
    ("    // [probe] B6 tile staged\n", "    const long long t1 = clock64();\n", "replace"),
    ("    // [probe] B6 ds formed\n", "    const long long t2 = clock64();\n", "replace"),
    ("    // [probe] B6 ds quantized\n", "    const long long t3 = clock64();\n", "replace"),
    ("    // [probe] B6 products added\n", "    const long long t4 = clock64();\n",
     "replace"),
    ("    // [probe] B6 tile end\n",
     "    const long long t5 = clock64();\n    ph[0] += t1 - t0; ph[1] += t2 - t1;"
     " ph[2] += t3 - t2; ph[3] += t4 - t3; ph[4] += t5 - t4; ph[6] += 1;\n", "replace"),
    ("  // [probe] B6 end\n", "  PROBE_SAVE(1, PROBE_BLOCK);\n", "replace"),
]
DKV_TC = [(a.replace("B6", "B7"), t.replace("PROBE_SAVE(1,", "PROBE_SAVE(2,"), w)
          for a, t, w in DQ_TC]
TC_PHASES = ("copies' wait and barrier", "products over d and the p/ds step",
             "quantization into fragments", "products over the tile", "barrier")

# B5 in the int8 mode as first written (__dp4a, k and v quantized inside
# the block for every tile): ph[0] k and v quantized into shared memory, [1]
# q k^T, [2] the softmax and p's quantization, [3] p v, [4] barriers, [6]
# tiles
FWD_DP4A = [
    ("  const int nk = (p.T + kI8 - 1) / kI8;\n  for (int kt = 0; kt < nk; ++kt) {\n"
     "    const int k0 = kt * kI8;\n"
     "    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;   // uniform over the block\n"
     "    __syncthreads();   // the previous tile's readers of k8, vT8, p8 are done\n",
     "  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  const long long tk0 = clock64();\n"
     "  const int nk = (p.T + kI8 - 1) / kI8;\n  for (int kt = 0; kt < nk; ++kt) {\n"
     "    const int k0 = kt * kI8;\n"
     "    if (!tile_visible(q0, kBQ, k0, kI8, p)) continue;\n"
     "    const long long t0 = clock64();\n    __syncthreads();\n"
     "    const long long tA = clock64();\n", "replace"),
    ("    quant_cols<T, DP>(reinterpret_cast<int8_t*>(vT8), 4 * kLTW, sv, red, vb, kstride, k0,\n"
     "                      kvalid, p.d);\n    __syncthreads();\n",
     "    quant_cols<T, DP>(reinterpret_cast<int8_t*>(vT8), 4 * kLTW, sv, red, vb, kstride, k0,\n"
     "                      kvalid, p.d);\n    const long long tB = clock64();\n"
     "    __syncthreads();\n    const long long tC = clock64();\n", "replace"),
    ("    float alpha[4], sp[4];\n", "    const long long tD = clock64();\n", "before"),
    ("      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), row_sum(rs));\n      m[i] = m_new;\n"
     "    }\n    __syncthreads();\n",
     "      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), row_sum(rs));\n      m[i] = m_new;\n"
     "    }\n    const long long tE = clock64();\n    __syncthreads();\n"
     "    const long long tF = clock64();\n", "replace"),
    ("rescale(ai[i][j], sp[i], sv[tx + 16 * j]));\n  }\n",
     "rescale(ai[i][j], sp[i], sv[tx + 16 * j]));\n    const long long tG = clock64();\n"
     "    ph[0] += tB - tA; ph[1] += tD - tC; ph[2] += tE - tD; ph[3] += tG - tF;\n"
     "    ph[4] += (tA - t0) + (tC - tB) + (tF - tE); ph[6] += 1;\n"
     "  }\n  PROBE_SAVE(3, PROBE_BLOCK);\n", "replace"),
]
FWD_DP4A_PHASES = ("k and v quantized into shared memory", "q k^T", "softmax and p's quantization",
                   "p v", "barriers")
# B5 int8 on the s8 tensor cores, fed by the forward pre-pass: ph[0] the
# wait for the tile's copies and its barrier, [1] q k^T, [2] the softmax and
# p's quantization into A fragments, [3] p v with its rescale, [4] the
# barrier that frees the tile's buffer, [6] tiles
FWD_TC = [(a.replace("B6", "B5"), t.replace("PROBE_SAVE(1,", "PROBE_SAVE(3,"), w)
          for a, t, w in DQ_TC]
FWD_TC[3] = ("    // [probe] B5 s formed\n", "    const long long t2 = clock64();\n", "replace")
FWD_TC[4] = ("    // [probe] B5 p quantized\n", "    const long long t3 = clock64();\n", "replace")
FWD_TC_PHASES = ("copies' wait and barrier", "q k^T", "softmax and p's quantization",
                 "p v", "barrier")

# kernel -> [(form, anchors, phase names)]: the first form whose anchors
# all appear once in the source is the one probed
FORMS = {
    "flash_fwd_tc_kernel": [("bf16 tensor cores", B5_PROBES, B5_PHASES)],
    "flash_bwd_dq_i8_kernel": [("__dp4a", DQ_DP4A, DP4A_PHASES),
                               ("s8 tensor cores", DQ_TC, TC_PHASES)],
    "flash_bwd_dkv_i8_kernel": [("__dp4a", DKV_DP4A, DP4A_PHASES),
                                ("s8 tensor cores", DKV_TC, TC_PHASES)],
    "flash_fwd_i8_kernel": [("__dp4a", FWD_DP4A, FWD_DP4A_PHASES),
                            ("s8 tensor cores", FWD_TC, FWD_TC_PHASES)],
}
SLOTS = {"flash_fwd_tc_kernel": 0, "flash_bwd_dq_i8_kernel": 1, "flash_bwd_dkv_i8_kernel": 2,
         "flash_fwd_i8_kernel": 3}


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


def has_prepass(csrc):
    return "flash_quant_i8_kernel" in (csrc / "flash_attention.cu").read_text()


def sweep(csrc):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.quant import QuantPolicy

    F = torch.nn.functional
    bf16, int8 = QuantPolicy("bf16"), QuantPolicy("int8")
    prepass = has_prepass(csrc)
    fwd_prepass = "flash_quant_fwd_i8_kernel" in (csrc / "flash_attention.cu").read_text()
    rmsnorm_bwd()
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
        kw = dict(causal=causal, policy=bf16)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        b5 = dev_us(lambda: fa.flash_fwd(q, k, v, **kw), "flash_fwd_tc_kernel")
        b6 = dev_us(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    "flash_bwd_dq_tc_kernel")
        b7 = dev_us(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                    "flash_bwd_dkv_tc_kernel")
        k8 = dict(causal=causal, policy=int8)
        o8, lse8 = fa.flash_fwd(q, k, v, **k8)
        delta8 = (do.float() * o8.float()).sum(-1).transpose(1, 2).contiguous()
        i6 = dev_us(lambda: fa.flash_bwd_dq(q, k, v, do, lse8, delta8, **k8),
                    "flash_bwd_dq_i8_kernel")
        i7 = dev_us(lambda: fa.flash_bwd_dkv(q, k, v, do, lse8, delta8, **k8),
                    "flash_bwd_dkv_i8_kernel")
        pre = (dev_us(lambda: fa.flash_bwd(q, k, v, do, lse8, delta8, **k8),
                      "flash_quant_i8_kernel") if prepass else None)
        i5 = dev_us(lambda: fa.flash_fwd(q, k, v, **k8), "flash_fwd_i8_kernel")
        fpre = (dev_us(lambda: fa.flash_fwd(q, k, v, **k8), "flash_quant_fwd_i8_kernel")
                if fwd_prepass else None)
        fwd8 = dev_us(lambda: fa.flash_fwd(q, k, v, **k8), "", per_call=True)
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
            f"backward {sdpa_bwd:.1f} us a call; int8 operands: B6 {i6:.1f} us, B7 {i7:.1f} us"
            + (f", pre-pass {pre:.1f} us, backward {pre + i6 + i7:.1f} us" if prepass
               else " (no pre-pass in this tree)")
            + f"; int8 forward: B5 {i5:.1f} us"
            + (f", forward pre-pass {fpre:.1f} us" if fwd_prepass
               else " (no forward pre-pass in this tree)")
            + f", the whole forward {fwd8:.1f} us a call")
        del q, k, v, do, o, lse, delta, o8, lse8, delta8, qb, kb, vb, dob, ob
        torch.cuda.empty_cache()


def kernel_us(fn, n=20):
    """{kernel name: (device us a call, launches a call)} of every kernel
    that ``fn`` launches, from torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / n, e.count / n) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def rmsnorm_bwd():
    """B2 at the train shape x, dy (8, 512, 1024), f32 and bf16 storage:
    each of its kernels' device us and launches a call, beside the autograd
    backward of F.rms_norm (every kernel of the call)."""
    from repro_torch.kernels import rmsnorm as rn

    F = torch.nn.functional
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, dy = (torch.randn(8, 512, 1024, device="cuda", generator=gen).to(dt)
                 for _ in range(2))
        g = 0.5 * torch.randn(1024, device="cuda", generator=gen)
        ours = kernel_us(lambda: rn.rmsnorm_bwd(x, g, dy))
        xl = x.clone().requires_grad_(True)
        wl = (1 + g).requires_grad_(True)
        yl = F.rms_norm(xl, (1024,), weight=wl, eps=1e-6)
        lib = kernel_us(lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True))
        short = lambda k: re.search(r"(\w+)[<(]", k.split("::")[-1]).group(1)   # noqa: E731
        log(f"[sweep] B2 rmsnorm_bwd x (8, 512, 1024) {str(dt)[6:]}: "
            + ", ".join(f"{short(k)} {us:.2f} us in {c:.0f} launch(es)"
                        for k, (us, c) in ours.items())
            + f"; the call {sum(us for us, _ in ours.values()):.2f} us on the card in "
            f"{sum(c for _, c in ours.values()):.0f} launch(es); F.rms_norm's autograd "
            f"backward {sum(us for us, _ in lib.values()):.2f} us in "
            f"{sum(c for _, c in lib.values()):.0f} launches")
        del x, dy, xl, wl, yl


def instrument(src):
    """The source with each kernel's stamps put in, and the forms found."""
    forms = {}
    for kernel, options in FORMS.items():
        for form, probes, names in options:
            out = src      # each anchor must appear once, stamps put in before it included
            for anchor, text, where in probes:
                if out.count(anchor) != 1:
                    break
                out = out.replace(anchor, {"after": anchor + text, "before": text + anchor,
                                           "replace": text}[where])
            else:
                src = out
                forms[kernel] = (form, names)
                break
        else:
            raise SystemExit(f"torch_flash_probe: the source changed; no anchor set of "
                             f"{kernel} matches it")
    head = (f"__device__ long long g_phases[{len(SLOTS)}][{NSLOT}][8];\n"
            "#define PROBE_BLOCK (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
            "blockIdx.z))\n"
            "#define PROBE_SAVE(slot, blk) if (threadIdx.x == 0 && (blk) < "
            f"{NSLOT}) {{ for (int i_ = 0; i_ < 7; ++i_) g_phases[slot][blk][i_] = ph[i_]; "
            "g_phases[slot][blk][7] = clock64() - tk0; }\n")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    src += ('\nextern "C" int repro_flash_phases(void* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));\n}\n'
            'extern "C" int repro_flash_phases_reset() {\n'
            '  void* at = nullptr;\n'
            '  cudaError_t err = cudaGetSymbolAddress(&at, g_phases);\n'
            '  return (int)(err ? err : cudaMemset(at, 0, sizeof(g_phases)));\n}\n')
    return src, forms


def phases(csrc):
    """Build the instrumented source into a library that stands in for the
    port's (so the wrappers launch the stamped kernels), run each kernel at
    the train shape and read the stamps."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.quant import QuantPolicy

    src, forms = instrument((csrc / "flash_attention.cu").read_text())
    out = ROOT / "build" / "flash_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(src)
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, out / h.name)
    cus = [out / "flash_attention.cu"] + [s for s in csrc.glob("*.cu")
                                          if s.name != "flash_attention.cu"]
    objs = [out / (s.stem + ".o") for s in cus]
    lib_path = out / "libflash_probe.so"
    nvcc = build._nvcc()
    build._run_all([[nvcc, *build.NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(cus, objs)])
    build._run_all([[nvcc, *build.NVCC_FLAGS[:2], "-shared", *map(str, objs),
                     "-o", str(lib_path)]])
    lib = ctypes.CDLL(str(lib_path))
    for name, (argtypes, restype) in build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), restype
    build._lib = lib      # the wrappers now launch the stamped kernels
    read = lambda: _read(lib)   # noqa: E731
    for B, dt in ((8, torch.float32), (8, torch.bfloat16), (1, torch.float32)):
        S, H, d = 512, 16, 64
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt)
                       for _ in range(4))
        q = (q.float() * 0.125).to(dt)
        for kernel, (form, names) in forms.items():
            policy = QuantPolicy("bf16" if kernel == "flash_fwd_tc_kernel" else "int8")
            kw = dict(causal=True, policy=policy)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            call = {"flash_fwd_tc_kernel": lambda: fa.flash_fwd(q, k, v, **kw),
                    "flash_fwd_i8_kernel": lambda: fa.flash_fwd(q, k, v, **kw),
                    "flash_bwd_dq_i8_kernel":
                        lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                    "flash_bwd_dkv_i8_kernel":
                        lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)}[kernel]
            call()
            torch.cuda.synchronize()
            if lib.repro_flash_phases_reset():
                raise SystemExit("torch_flash_probe: clearing the phases failed")
            call()
            torch.cuda.synchronize()
            x = read()[SLOTS[kernel]]
            x = x[x[:, 7] > 0]
            where = f"at ({B}, {S}, {H}, {d}) {str(dt)[6:]} storage, causal"
            if kernel == "flash_fwd_tc_kernel":
                items = (S + 127) // 128 * B * H
                tiles = x[:, 4].sum()
                log(f"[phases] B5 {where}: {items} items on {len(x)} blocks, {tiles} tiles; "
                    "cycles a tile: "
                    + ", ".join(f"{n} {x[:, i].sum() / tiles:.0f}" for i, n in enumerate(names))
                    + f"; an item's q and set-up {x[:, 5].sum() / items:.0f}, its epilogue "
                    f"{x[:, 6].sum() / items:.0f}; a block {x[:, 7].mean():.0f} on average, "
                    f"{x[:, 7].max()} at most")
            else:
                tiles = x[:, 6].sum()
                per = [x[:, i].sum() / tiles for i in range(len(names))]
                name = {"flash_bwd_dq_i8_kernel": "B6", "flash_bwd_dkv_i8_kernel": "B7",
                        "flash_fwd_i8_kernel": "B5"}[kernel]
                log(f"[phases] {name}-int8 ({form}) {where}: "
                    f"{len(x)} blocks, {tiles} tiles; cycles a tile: "
                    + ", ".join(f"{n} {c:.0f}" for n, c in zip(names, per))
                    + f" (sum {sum(per):.0f}); a block {x[:, 7].mean():.0f} on average, "
                    f"{x[:, 7].max()} at most")
            del o, lse, delta
        del q, k, v, do
        torch.cuda.empty_cache()


def _read(lib):
    buf = np.zeros((len(SLOTS), NSLOT, 8), dtype=np.int64)
    if lib.repro_flash_phases(buf.ctypes.data_as(ctypes.c_void_p)):
        raise SystemExit("torch_flash_probe: reading the phases failed")
    return buf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", choices=("sweep", "phases"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_probe: needs a CUDA device")
    sys.path.insert(0, a.src)
    csrc = Path(a.src) / "repro_torch" / "kernels" / "csrc"
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip())
    log(f"[probe] tree {a.src}")
    if a.only != "phases":
        sweep(csrc)
    if a.only != "sweep":
        phases(csrc)


if __name__ == "__main__":
    main()
