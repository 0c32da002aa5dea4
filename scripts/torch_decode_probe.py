#!/usr/bin/env python3
"""Where B8 (paged flash decode, ``flash_decode_kernel``) and B9 (the
multi-query paged decode of chunk forwards, ``flash_decode_multi_kernel``)
spend the card's time.

    python3 scripts/torch_decode_probe.py [--out DIR]

On the GPU, prints the card's name and power limit, then:

- splits: device microseconds a launch (torch.profiler over 50 calls) of
  B8 through its C entry point with 1, 2, 4 and 8 blocks a cluster, over
  f32 and int8 pools, at the decode shape (q (4, 9, 64), pools (83, 16, 3,
  64), live lens 120/200/260/310) and at one slot of 2048 tokens and 32
  slots; every result held against the plain version (atol 2e-5);
- sass: the opcodes of each B8 instance in order (runs counted) into
  DIR/decode_sass.txt (default build/decode_probe/), and their counts of
  loads, shuffles, MUFU and FFMA, where cuobjdump is on the machine;
- phases: one launch of a copy of csrc/decode_attention.cu with
  %globaltimer reads put in (built under build/decode_probe/ with nvcc),
  thread 0 of every block (lane 0 of every warp for its page loop): each
  phase's nanoseconds (median and largest over the blocks), from the
  first block's start: q_pos read, the warps' page loops, the block's
  merge into rank 0's shared memory (distributed shared memory), the
  cluster barrier, rank 0's merge; the span from the first block's start
  to the last block's end beside the launch's device time.  The timer
  ticks in steps of tens of nanoseconds;
- multi: B9's device microseconds a launch through its C entry point over
  query tiles (4, 8, 12, 16, 21 and the plan's) by split count (1, 2, 4,
  8 and the plan's), at the chunk shape (q (1, 64, 9, 64) at positions
  192..255, 16 live pages), the speculative-verify shape (4 slots at T =
  5), a chunk of 256 over a 2048-token history and 32 slots at the verify
  T = 5, over f32 and int8 pools, the plan's own choice starred;
  every result held against the plain version (atol 2e-5);
- mphases: one launch of a copy of B9 with %globaltimer stamps put in
  (thread 0 of every block, the first slice, the first stage's first
  step) at the same shapes: the ids, q and q_pos trip, the pages' copy
  (issue to wait), the bf16/int8 conversion, q k^T, the softmax, the
  barrier and p v, the other steps and stages, the stores into the
  owners' stage, the cluster barrier and the local merge, each phase's
  median and largest over the blocks, beside the launch's device time.
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
LENS = [120, 200, 260, 310]
N_STAMPS = 10
STAMP = "  {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); " \
        "g_stamps[((size_t)blockIdx.x * gridDim.y + blockIdx.y) * gridDim.z * {n} + " \
        "blockIdx.z * {n} + ({i})] = t_; }}\n"
# (anchor in flash_decode_kernel, stamp index (an expression), who, where)
PROBES = [
    ("  const int NW = S * kWarps;      // warps of the cluster\n", "0", "threadIdx.x == 0",
     "before"),
    ("  const int n_mine = cw < n_live ? (n_live - cw + NW - 1) / NW : 0;\n", "1",
     "threadIdx.x == 0", "after"),
    ("      // the warp's state: acc summed over the lanes that hold other rows\n",
     "2 + warp", "lane == 0", "before"),
    ("      // the block's state, merged over its warps in order, stored into rank\n", "6",
     "threadIdx.x == 0", "before"),
    ("      cluster.sync();  // every block's state is in rank 0's stage\n", "7",
     "threadIdx.x == 0", "before"),
    ("      // rank 0 merges the blocks in rank order and writes out\n", "8",
     "threadIdx.x == 0", "before"),
    ("      // another pass rewrites the warps' states and rank 0's stage\n", "9",
     "threadIdx.x == 0", "before"),
]
PHASES = [  # (name, from stamp, to stamp)
    ("q_pos and the first page ids read", 0, 1),
    ("page loop (warp 0)", 1, 2),
    ("page loops (the block's last warp)", 1, -1),
    ("the block's barrier", -1, 6),
    ("the block's merge into rank 0's stage", 6, 7),
    ("the cluster barrier", 7, 8),
    ("rank 0's merge (rank 0 only)", 8, 9),
]


def log(*a):
    print(*a, flush=True)


def dev_us(fn, n=50, tries=3):
    """Device microseconds a call of ``fn`` over every kernel it launches
    (torch.profiler over ``n`` calls; a profile that caught none is taken
    again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if hits:
            return sum(e.self_device_time_total for e in hits) / n
    raise SystemExit("torch_decode_probe: the profiler saw no kernel")


def case(B, C, lens, int8, seed):
    """chip_smoke.py's paged_case at smollm-135m's 9/3 heads of 64, page 16
    (int8 pools with their scales when ``int8``)."""
    from repro_torch import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, G, d, P = 3, 3, 64, 16
    N = B * C + 3
    q = torch.randn(B, K * G, d, device="cuda", generator=gen)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    perm = torch.randperm(N, device="cuda", generator=gen)
    tab = perm[:B * C].reshape(B, C).to(torch.int32)
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, T in enumerate(lens):
        t = torch.arange(T, device="cuda")
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    q_pos = torch.tensor([T - 1 for T in lens], dtype=torch.int32, device="cuda")
    scales = {}
    if int8:
        kp, vp, ks, vs = quant.pack_kv(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, pos, tab, q_pos), scales


def call(lib, args, scales, splits, out):
    from repro_torch.kernels import build

    q, kp, vp, pos, tab, q_pos = args
    B, H, d = q.shape
    N, P, K, _ = kp.shape
    ks, vs = scales.get("k_scale"), scales.get("v_scale")
    err = lib.repro_flash_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pos.data_ptr(), tab.data_ptr(),
        q_pos.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), out.data_ptr(), B, H, K, d, N, P,
        tab.shape[1], 0.125, 0, 0.0, splits, 0, 2 if scales else 0, build.stream(q))
    if err:
        raise SystemExit(f"torch_decode_probe: CUDA error {err} at {splits} splits")
    return out


SHAPES = [("decode shape", 4, 20, LENS),
          ("one slot of 2048 tokens", 1, 128, [2048]),
          ("32 slots", 32, 20, [120 + (190 * i) // 31 for i in range(32)])]


def splits_sweep():
    from repro_torch.kernels import build, ref

    lib = build.library()
    for int8 in (False, True):
        for label, B, C, lens in SHAPES:
            args, scales = case(B, C, lens, int8, 7)
            want = ref.decode_attention_ref(*args, scale=0.125, **scales)
            out = torch.empty_like(args[0])
            row = []
            for s in (1, 2, 4, 8):
                got = call(lib, args, scales, s, out)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not err <= 2e-5:
                    raise SystemExit(f"torch_decode_probe: {label} at {s} splits: err {err}")
                row.append(f"{s}: {dev_us(lambda: call(lib, args, scales, s, out)):.2f}")
            log(f"[splits] {'int8' if int8 else 'f32'} pools, {label}: device us a launch "
                f"by splits: " + ", ".join(row))


# B9 (flash_decode_multi_kernel): the chunk shape, the speculative-verify
# shape and the two scaling shapes, smollm-135m's 9/3 heads of 64, page 16:
# (label, B, T, C, hist)
MULTI_SHAPES = [("chunk shape", 1, 64, 20, [192]),
                ("verify shape B = 4, T = 5", 4, 5, 20, [70, 0, 250, 33]),
                ("a chunk of 256 over 2048 tokens", 1, 256, 128, [1792]),
                ("32 slots at T = 5", 32, 5, 20, [120 + (190 * i) // 31 for i in range(32)])]
MULTI_TQ = (4, 8, 12, 16, 21)


def multi_case(B, T, C, hist, int8, seed):
    """chip_smoke.py's multi_case at smollm-135m's 9/3 heads of 64, page 16:
    slot b's history of hist[b] tokens and its T-token chunk written
    through a permuted table (int8 pools with their scales when ``int8``)."""
    from repro_torch import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    K, G, d, P = 3, 3, 64, 16
    N = B * C + 3
    q = torch.randn(B, T, K * G, d, device="cuda", generator=gen)
    kp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    vp = torch.randn(N, P, K, d, device="cuda", generator=gen)
    tab = torch.randperm(N, device="cuda", generator=gen)[:B * C].reshape(B, C).to(torch.int32)
    q_pos = torch.stack([torch.arange(h, h + T, device="cuda") for h in hist]).to(torch.int32)
    pos = torch.full((N, P), -1, dtype=torch.int32, device="cuda")
    for b, h in enumerate(hist):
        t = torch.arange(h + T, device="cuda")
        pos[tab[b, t // P].long(), t % P] = t.to(torch.int32)
    scales = {}
    if int8:
        kp, vp, ks, vs = quant.pack_kv(kp, vp)
        scales = dict(k_scale=ks, v_scale=vs)
    return (q, kp, vp, pos, tab, q_pos), scales


def call_multi(lib, args, scales, tq, splits, out):
    from repro_torch.kernels import build

    q, kp, vp, pos, tab, q_pos = args
    B, T, H, d = q.shape
    N, P, K, _ = kp.shape
    ks, vs = scales.get("k_scale"), scales.get("v_scale")
    err = lib.repro_flash_decode_multi(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pos.data_ptr(), tab.data_ptr(),
        q_pos.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), out.data_ptr(), B, T, H, K, d, N, P,
        tab.shape[1], 0.125, 0, 0.0, tq, splits, 0, 2 if scales else 0, build.stream(q))
    if err:
        raise SystemExit(f"torch_decode_probe: B9 CUDA error {err} at tq {tq}, {splits} splits")
    return out


def multi_sweep():
    """B9's device us a launch over tq x splits at MULTI_SHAPES, f32 and int8
    pools, every result held against the plain version (atol 2e-5); the
    plan's own choice marked with *."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da

    lib = build.library()
    for int8 in (False, True):
        for label, B, T, C, hist in MULTI_SHAPES:
            args, scales = multi_case(B, T, C, hist, int8, 7)
            want = ref.decode_attention_multi_ref(*args, scale=0.125, **scales)
            out = torch.empty_like(args[0])
            plan = da.kernel_multi_plan(B, 3, T, 3, 64, 16, C, args[1].element_size())
            for tq in sorted(set(MULTI_TQ) | {plan.tq}):
                row = []
                for s in sorted({1, 2, 4, 8, plan.splits}):
                    got = call_multi(lib, args, scales, tq, s, out)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    if not err <= 2e-5:
                        raise SystemExit(f"torch_decode_probe: B9 {label} tq {tq}, {s} "
                                         f"splits: err {err}")
                    us = dev_us(lambda: call_multi(lib, args, scales, tq, s, out))
                    mark = "*" if (tq, s) == (plan.tq, plan.splits) else ""
                    row.append(f"{s}: {us:.2f}{mark}")
                log(f"[multi] {'int8' if int8 else 'f32'} pools, {label}, tq {tq} "
                    f"({-(-T // tq)} tiles): device us a launch by splits: " + ", ".join(row))


def phases():
    from repro_torch.kernels import build, ref

    src = (CSRC / "decode_attention.cu").read_text()
    for anchor, idx, who, where in PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_decode_probe: the source changed; anchor not found: "
                             f"{anchor[:60]!r}")
        text = f"  if ({who})\n" + STAMP.format(n=N_STAMPS, i=idx)
        if where == "after":
            src = src.replace(anchor, anchor + text, 1)
        else:
            src = src.replace(anchor, text + anchor, 1)
    src = src.replace("namespace {\n", "__device__ unsigned long long g_stamps[1 << 16];\n"
                      "namespace {\n", 1)
    src += ('\nextern "C" int repro_decode_stamps(void* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n')
    out_dir = ROOT / "build" / "decode_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "decode_attention.cu").write_text(src)
    for h in ("dtype.cuh", "mma.cuh"):
        shutil.copy(CSRC / h, out_dir / h)
    lib_path = out_dir / "libdecode_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(out_dir / "decode_attention.cu"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_decode.argtypes = [P] * 9 + [I] * 7 + [Fl, I, Fl, I, I, I, P]
    lib.repro_flash_decode.restype = I
    real = build.library()
    for int8 in (False, True):
        for label, B, C, lens in SHAPES:
            args, scales = case(B, C, lens, int8, 7)
            S = 8
            out = torch.empty_like(args[0])
            for _ in range(3):
                call(lib, args, scales, S, out)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(*args, scale=0.125, **scales)
            if not (out - want).abs().max().item() <= 2e-5:
                raise SystemExit("torch_decode_probe: the instrumented copy is wrong")
            buf = np.zeros(1 << 16, dtype=np.uint64)
            if lib.repro_decode_stamps(buf.ctypes.data_as(ctypes.c_void_p)):
                raise SystemExit("torch_decode_probe: reading the stamps failed")
            K = args[1].shape[2]
            x = buf[:B * K * S * N_STAMPS].reshape(B * K * S, N_STAMPS).astype(np.int64)
            x = x - x[:, 0].min()
            last_warp = x[:, 2:6].max(axis=1)
            parts = []
            for name, a, b in PHASES:
                ta = last_warp if a == -1 else x[:, a]
                tb = last_warp if b == -1 else x[:, b]
                dt = tb - ta
                if name.startswith("rank 0"):
                    dt = dt[::S]   # the rows of rank 0 (blockIdx.z = 0)
                parts.append(f"{name} {np.median(dt):.0f} (max {dt.max()})")
            span = x[:, 9].max()
            starts = x[:, 0]
            t_probe = dev_us(lambda: call(lib, args, scales, S, out))
            t_real = dev_us(lambda: call(real, args, scales, S, out))
            log(f"[phases] {'int8' if int8 else 'f32'} pools, {label}, {B * K * S} blocks: "
                f"ns from each block's start: " + "; ".join(parts)
                + f"; blocks start over {starts.max()} ns; span {span} ns; device us a "
                f"launch {t_probe:.2f} instrumented, {t_real:.2f} not")


N_MSTAMPS = 11
MSTAMP = "  {{ unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); " \
         "g_mstamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * {n} + ({i})] = t_; }}\n"
# (anchor in flash_decode_multi_kernel, stamp, who, where); thread 0 of each
# block, the first slice, the first stage's first step
MPROBES = [
    ("  // first round trip: this block's page ids (warp 0), q, q_pos (each warp\n", 0,
     "tid == 0", "before"),
    ("  const int n_live = qmax < 0 ? 0 : min(C, qmax / P + 1);\n", 1, "tid == 0", "after"),
    ("        __syncthreads();\n        if constexpr (!kF32) {\n", 2, "tid == 0 && sl == 0 && g == 0",
     "between"),
    ("      const int ntok = min(H_, n_mine - g * H_) * P;\n", 3,
     "tid == 0 && sl == 0 && g == 0", "before"),
    ("          int pt[TN];\n", 4, "tid == 0 && sl == 0 && g == 0 && u0 == 0", "before"),
    ("        __syncthreads();  // the step's p\n", 5,
     "tid == 0 && sl == 0 && g == 0 && u0 == 0", "before"),
    ("        if (u0 + kStepTok < ntok) __syncthreads();  // the next step rewrites p\n", 6,
     "tid == 0 && sl == 0 && g == 0 && u0 == 0", "before"),
    ("    if (sl == 0) cluster_wait();  // every block of the cluster runs\n", 7,
     "tid == 0 && sl == 0", "before"),
    ("    cluster.sync();\n    // this block's rows, the blocks merged in rank order", 8,
     "tid == 0 && sl == 0", "before"),
    ("    // this block's rows, the blocks merged in rank order: a state that saw\n", 9,
     "tid == 0 && sl == 0", "before"),
    ("    // another slice rewrites every block's stage\n", 10, "tid == 0 && sl == 0", "before"),
]
MPHASES = [  # (name, from stamp, to stamp); a stamp a block never reached is 0
    ("ids, q and q_pos", 0, 1),
    ("the pages' copy (issue to wait)", 1, 2),
    ("bf16/int8 conversion", 2, 3),
    ("q k^T (first step)", 3, 4),
    ("softmax (first step)", 4, 5),
    ("barrier and p v (first step)", 5, 6),
    ("the other steps and stages", 6, 7),
    ("stores into the owners' stage", 7, 8),
    ("the cluster barrier", 8, 9),
    ("the local merge and write", 9, 10),
]


def multi_phases():
    """One launch of an instrumented copy of B9 at each MULTI_SHAPES shape, f32
    and int8 pools: each phase's ns (median and largest over the blocks that
    ran it) from thread 0's %globaltimer stamps, the span from the first
    block's start to the last block's end, beside the launch's device time."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da

    src = (CSRC / "decode_attention.cu").read_text()
    for anchor, idx, who, where in MPROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_decode_probe: the source changed; anchor not found: "
                             f"{anchor[:60]!r}")
        text = f"  if ({who})\n" + MSTAMP.format(n=N_MSTAMPS, i=idx)
        if where == "after":
            src = src.replace(anchor, anchor + text, 1)
        elif where == "between":
            head, tail = anchor.split("\n", 1)
            src = src.replace(anchor, head + "\n" + text + tail, 1)
        else:
            src = src.replace(anchor, text + anchor, 1)
    src = src.replace("namespace {\n", "__device__ unsigned long long g_mstamps[1 << 16];\n"
                      "namespace {\n", 1)
    src += ('\nextern "C" int repro_multi_stamps(void* host) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_mstamps, sizeof(g_mstamps));\n}\n'
            'extern "C" int repro_multi_stamps_clear() {\n'
            '  static unsigned long long zero[1 << 16];\n'
            '  return (int)cudaMemcpyToSymbol(g_mstamps, zero, sizeof(zero));\n}\n')
    out_dir = ROOT / "build" / "decode_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "decode_attention_multi.cu").write_text(src)
    for h in ("dtype.cuh", "mma.cuh"):
        shutil.copy(CSRC / h, out_dir / h)
    lib_path = out_dir / "libdecode_multi_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                    str(out_dir / "decode_attention_multi.cu"), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P_, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_flash_decode_multi.argtypes = [P_] * 9 + [I] * 8 + [Fl, I, Fl, I, I, I, I, P_]
    lib.repro_flash_decode_multi.restype = I
    real = build.library()
    for int8 in (False, True):
        for label, B, T, C, hist in MULTI_SHAPES:
            args, scales = multi_case(B, T, C, hist, int8, 7)
            plan = da.kernel_multi_plan(B, 3, T, 3, 64, 16, C, args[1].element_size())
            out = torch.empty_like(args[0])
            for _ in range(3):
                call_multi(lib, args, scales, 0, 0, out)
            torch.cuda.synchronize()
            want = ref.decode_attention_multi_ref(*args, scale=0.125, **scales)
            if not (out - want).abs().max().item() <= 2e-5:
                raise SystemExit("torch_decode_probe: the instrumented B9 copy is wrong")
            if lib.repro_multi_stamps_clear():
                raise SystemExit("torch_decode_probe: clearing the stamps failed")
            call_multi(lib, args, scales, 0, 0, out)
            torch.cuda.synchronize()
            buf = np.zeros(1 << 16, dtype=np.uint64)
            if lib.repro_multi_stamps(buf.ctypes.data_as(ctypes.c_void_p)):
                raise SystemExit("torch_decode_probe: reading the stamps failed")
            n_blocks = plan.splits * plan.tiles * B * 3
            x = buf[:n_blocks * N_MSTAMPS].reshape(n_blocks, N_MSTAMPS).astype(np.int64)
            t_first = x[:, 0].min()
            parts = []
            for name, a, b in MPHASES:
                ran = (x[:, a] > 0) & (x[:, b] > 0)
                if not ran.any():
                    parts.append(f"{name} -")
                    continue
                dt = x[ran, b] - x[ran, a]
                parts.append(f"{name} {np.median(dt):.0f} (max {dt.max()})")
            span = x[:, 10].max() - t_first
            t_probe = dev_us(lambda: call_multi(lib, args, scales, 0, 0, out))
            t_real = dev_us(lambda: call_multi(real, args, scales, 0, 0, out))
            log(f"[mphases] {'int8' if int8 else 'f32'} pools, {label}, plan tq {plan.tq}, "
                f"{plan.splits} splits, {n_blocks} blocks: ns from thread 0's stamps: "
                + "; ".join(parts) + f"; blocks start over {x[:, 0].max() - t_first} ns; "
                f"span {span} ns; device us a launch {t_probe:.2f} instrumented, "
                f"{t_real:.2f} not")


def sass(out):
    """B8's instances in SASS (cuobjdump, where the toolkit has it): their
    opcodes in order, runs of one opcode counted, written to
    ``out``/decode_sass.txt; printed: the counts of loads, shuffles, MUFU
    and FFMA."""
    import re

    from repro_torch.kernels import build

    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    tool = next((t for t in tools if t and Path(t).exists()), None)
    if tool is None:
        log("[sass] not available (no cuobjdump)")
        return
    dump = subprocess.run([tool, "-sass", str(build.library_path("decode_attention"))],
                          capture_output=True, text=True, timeout=600, check=True).stdout
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    for chunk in re.split(r"\n\s*Function : ", dump)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if "19flash_decode_kernelI" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", chunk)
        runs = []
        for op in ops:
            if runs and runs[-1][0] == op:
                runs[-1][1] += 1
            else:
                runs.append([op, 1])
        counts = {k: sum(1 for o in ops if o.startswith(k))
                  for k in ("LDG", "LDS", "LD.", "SHFL", "MUFU", "FFMA", "BAR", "UCGABAR")}
        log(f"[sass] {name[:70]}: {len(ops)} instructions, " + ", ".join(
            f"{k} {n}" for k, n in counts.items()))
        lines.append(name + "\n" + " ".join(f"{o}x{n}" if n > 1 else o for o, n in runs))
    (out / "decode_sass.txt").write_text("\n\n".join(lines))


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "decode_probe",
                    help="directory for decode_sass.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_decode_probe: needs a CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    from repro_torch.kernels import build

    build.wait()
    entry = None
    for line in build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry and "19flash_decode_kernelI" in entry:
            log(f"[build] {entry[:64]}: {line.split(':', 1)[1].strip()}")
    sass(args.out)
    splits_sweep()
    phases()
    multi_sweep()
    multi_phases()


if __name__ == "__main__":
    main()
