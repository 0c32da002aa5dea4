"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain
C interface, and loaded with ``ctypes``.  The build runs at first use, from
the sources in the checkout only, into ``build/repro_torch/<hash>/`` keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_FLASH_ARGS = (_I,) * 6 + (_F, _I, _I, _F, _I, _I, _P)
# C entry points and their argument types (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to a 32-bit int)
_SIGNATURES = {
    "repro_rmsnorm": ((_P, _P, _P, _I, _I, _F, _I, _P), _I),
    # B1 with a (groups, D) gain: x, g, y, rows, D, groups, eps, dtype, stream
    "repro_rmsnorm_grouped": ((_P, _P, _P, _I, _I, _I, _F, _I, _P), _I),
    # B2's scratch rows for (x, g, dy, dx, rows, D, groups, dtype)
    "repro_rmsnorm_bwd_blocks": ((_P, _P, _P, _P, _I, _I, _I, _I), _I),
    # x, g, dy, dx, dgain, scratch; its rows, rows, D, groups, eps, dtype, stream
    "repro_rmsnorm_bwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
    "repro_ce_fwd": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
    "repro_ce_bwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    # B8: q, k, v, pos, table, q_pos, k_scale, v_scale (null but for int8
    # pools), out; then B, H, K, d, N, P, C, scale, window, softcap,
    # splits, q dtype, kv dtype, stream
    "repro_flash_decode": (
        (_P,) * 9 + (_I,) * 7 + (_F, _I, _F, _I, _I, _I, _P),
        _I,
    ),
    # B9: the same pointers, then B, T, H, K, d, N, P, C, scale, window,
    # softcap, tq and splits (0: the plan's), q dtype, kv dtype, stream
    "repro_flash_decode_multi": (
        (_P,) * 9 + (_I,) * 8 + (_F, _I, _F, _I, _I, _I, _I, _P),
        _I,
    ),
    # B9's plan on the current device: B, K, T, G, d, P, C, kv dtype, int[6] out
    "repro_flash_decode_multi_plan": ((_I,) * 8 + (_P,), _LL),
    # flash attention: pointers, then B, S, T, H, K, d, scale, causal,
    # window, softcap, mode, dtype, stream
    "repro_flash_fwd": ((_P,) * 5 + _FLASH_ARGS, _I),
    "repro_flash_bwd_dq": ((_P,) * 7 + _FLASH_ARGS, _I),
    "repro_flash_bwd_dkv": ((_P,) * 8 + _FLASH_ARGS, _I),
    # the int8 forward: its pre-pass (k, v, the array of the 4 quantized
    # buffers; B, T, K, d, dtype, stream), then B5 (q, the array, o, lse; B,
    # S, T, H, K, d, scale, causal, window, softcap, dtype, stream)
    "repro_flash_quant_fwd_i8": ((_P,) * 3 + (_I,) * 5 + (_P,), _I),
    "repro_flash_fwd_i8": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _F, _I, _P), _I),
    # the int8 backward: its pre-pass (q, k, v, do, the array of the 14
    # quantized buffers; B, S, T, H, K, d, dtype, stream), then B6 and B7 on
    # those buffers (the array, lse, delta, outputs; B, S, T, H, K, d,
    # scale, causal, window, softcap, stream)
    "repro_flash_quant_i8": ((_P,) * 5 + (_I,) * 7 + (_P,), _I),
    "repro_flash_bwd_dq_i8": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _F, _P), _I),
    "repro_flash_bwd_dkv_i8": ((_P,) * 5 + (_I,) * 6 + (_F, _I, _I, _F, _P), _I),
    "repro_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of this process's build (None: not built)
build_log = ""         # nvcc's output (-Xptxas -v: registers, smem, spills)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on the machine "
        "with the card (CUDA toolkit on PATH or in /usr/local/cuda)"
    )


def _run_all(cmds):
    """Run the commands concurrently; raise with the output of any failure."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(c)}):\n{o}")
    return "".join(outs)


def _build() -> Path:
    global build_seconds, build_log
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        if not build_log and (out_dir / "build.log").exists():
            build_log = (out_dir / "build.log").read_text()
        return lib_path
    t0 = time.monotonic()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cu = [s for s in _sources() if s.suffix == ".cu"]
        objs = [Path(tmp) / (s.stem + ".o") for s in cu]
        log = _run_all([
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
            for s, o in zip(cu, objs)
        ])
        tmp_lib = Path(tmp) / LIB_NAME
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared",
                          *map(str, objs), "-o", str(tmp_lib)]])
        os.replace(tmp_lib, lib_path)   # atomic: never a half-written library
    build_seconds = time.monotonic() - t0
    build_log = log
    (out_dir / "build.log").write_text(log)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call; later calls take no
    lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
    return _lib


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on the card that holds the
    CUDA tensor ``t``, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def library_path() -> Path:
    """The built library's path (built on first call)."""
    with _lock:
        return _build()


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
