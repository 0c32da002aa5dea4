"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), and each group of sources (GROUPS) is
linked into a shared library of its own with a plain C interface, loaded
with ``ctypes``.  The build runs in the background from the first call of
``start`` or ``library``; an entry point waits for its own group's library
only, so the kernels that build first can run while the rest compile, and
``wait`` waits for all of them.  It builds from the sources in the checkout
only, into ``build/repro_torch/<hash>/`` keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not.  Nothing
here runs at import time.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import signal
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
# sources linked into one library each: flash attention's three widths
# call into each other; the others stand alone
GROUPS = {
    "rmsnorm": ("rmsnorm.cu",),
    "cross_entropy": ("cross_entropy.cu",),
    "decode_attention": ("decode_attention.cu",),
    "flash_attention": ("flash_attention.cu", "flash_attention_dp128.cu",
                        "flash_attention_dp256.cu"),
}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_FLASH_ARGS = (_I,) * 6 + (_F, _I, _I, _F, _I, _I, _P)
# C entry points and their argument types (pointers and the stream as
# c_void_p, so 64-bit addresses are never cut to a 32-bit int), by group
_SIGNATURES = {
    "rmsnorm": {
        "repro_rmsnorm": ((_P, _P, _P, _I, _I, _F, _I, _P), _I),
        # B1 with a (groups, D) gain: x, g, y, rows, D, groups, eps, dtype, stream
        "repro_rmsnorm_grouped": ((_P, _P, _P, _I, _I, _I, _F, _I, _P), _I),
        # B2's scratch rows for (x, g, dy, dx, rows, D, groups, dtype)
        "repro_rmsnorm_bwd_blocks": ((_P, _P, _P, _P, _I, _I, _I, _I), _I),
        # x, g, dy, dx, dgain, scratch; its rows, rows, D, groups, eps, dtype, stream
        "repro_rmsnorm_bwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P), _I),
        "repro_error_string": ((_I,), ctypes.c_char_p),
    },
    "cross_entropy": {
        "repro_ce_fwd": ((_P, _P, _P, _P, _I, _I, _I, _P), _I),
        "repro_ce_bwd": ((_P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    },
    "decode_attention": {
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
    },
    "flash_attention": {
        # flash attention: pointers, then B, S, T, H, K, d, scale, causal,
        # window, softcap, mode, dtype, stream
        "repro_flash_fwd": ((_P,) * 5 + _FLASH_ARGS, _I),
        "repro_flash_bwd_dq": ((_P,) * 7 + _FLASH_ARGS, _I),
        "repro_flash_bwd_dkv": ((_P,) * 8 + _FLASH_ARGS, _I),
        # the int8 forward: its pre-pass (k, v, the array of the 4 quantized
        # buffers; B, T, K, d, dtype, stream), then B5 (q, the array, o, lse;
        # B, S, T, H, K, d, scale, causal, window, softcap, dtype, stream)
        "repro_flash_quant_fwd_i8": ((_P,) * 3 + (_I,) * 5 + (_P,), _I),
        "repro_flash_fwd_i8": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _F, _I, _P), _I),
        # the int8 backward: its pre-pass (q, k, v, do, the array of the 14
        # quantized buffers; B, S, T, H, K, d, dtype, stream), then B6 and B7
        # on those buffers (the array, lse, delta, outputs; B, S, T, H, K, d,
        # scale, causal, window, softcap, stream)
        "repro_flash_quant_i8": ((_P,) * 5 + (_I,) * 7 + (_P,), _I),
        "repro_flash_bwd_dq_i8": ((_P,) * 4 + (_I,) * 6 + (_F, _I, _I, _F, _P), _I),
        "repro_flash_bwd_dkv_i8": ((_P,) * 5 + (_I,) * 6 + (_F, _I, _I, _F, _P), _I),
    },
}
_GROUP_OF = {name: g for g, sigs in _SIGNATURES.items() for name in sigs}

_lock = threading.Lock()
_builds = {}           # group -> _GroupBuild, from the first start()
_started = False
_t0 = None
build_seconds = None   # wall time of this process's build (None: not built)
group_seconds = {}     # each group's library ready after (None: found built)
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


def _finish(cmds, procs):
    """Wait for the started commands; raise with the output of any failure."""
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build failed ({' '.join(c)}):\n{o}")
    return "".join(outs)


def _start(cmd):
    # a process group of its own: nvcc's own children (cicc, ptxas) are
    # stopped with it
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


class _GroupBuild:
    """One group's library: compiled by processes started with every other
    group's, linked by a thread of its own once its objects are there."""

    def __init__(self, group, out_dir, nvcc):
        self.path = out_dir / f"librepro_{group}.so"
        self.log_path = out_dir / f"{group}.log"
        self.done = threading.Event()
        self.error = None
        self.seconds = None
        self.lib = None
        if self.path.exists():
            self.log = self.log_path.read_text() if self.log_path.exists() else ""
            self.done.set()
            return
        self.log = ""
        self.tmp = tempfile.mkdtemp(dir=out_dir)
        cu = [CSRC / name for name in GROUPS[group]]
        self.objs = [Path(self.tmp) / (s.stem + ".o") for s in cu]
        self.cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                     for s, o in zip(cu, self.objs)]
        self.procs = [_start(c) for c in self.cmds]
        self.nvcc = nvcc
        threading.Thread(target=self._link, daemon=True).start()

    def _link(self):
        try:
            log = _finish(self.cmds, self.procs)
            tmp_lib = Path(self.tmp) / self.path.name
            cmd = [self.nvcc, *NVCC_FLAGS[:2], "-shared", *map(str, self.objs),
                   "-o", str(tmp_lib)]
            self.procs.append(_start(cmd))
            log += _finish([cmd], self.procs[-1:])
            os.replace(tmp_lib, self.path)   # atomic: never a half-written library
            self.log_path.write_text(log)
            self.log = log
            self.seconds = time.monotonic() - _t0
        except BaseException as e:   # raised to whoever waits for the group
            self.error = e
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.done.set()

    def wait(self):
        self.done.wait()
        if self.error is not None:
            raise RuntimeError(f"building {self.path.name} failed") from self.error


@atexit.register
def _stop() -> None:
    """Kill the compilers still running when the process exits (an error
    before ``wait``): no nvcc outlives its caller."""
    for b in _builds.values():
        for p in getattr(b, "procs", ()):
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)


def start() -> None:
    """Start building every group's library in the background (one nvcc a
    source, all at once) and return; a group already built is only looked
    up.  Later calls do nothing."""
    global _started, _t0
    if _started:
        return
    with _lock:
        if _started:
            return
        covered = sorted(n for names in GROUPS.values() for n in names)
        if covered != sorted(s.name for s in CSRC.glob("*.cu")):
            raise RuntimeError(f"kernels.build.GROUPS {covered} must name every csrc/*.cu")
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        _t0 = time.monotonic()
        nvcc = None
        if not all((out_dir / f"librepro_{g}.so").exists() for g in GROUPS):
            nvcc = _nvcc()
        for g in GROUPS:
            _builds[g] = _GroupBuild(g, out_dir, nvcc)
        _started = True


def wait() -> None:
    """Wait until every group's library is built (starting the build if
    need be); sets ``build_seconds``, ``group_seconds`` and ``build_log``."""
    global build_seconds, build_log, group_seconds
    start()
    for b in _builds.values():
        b.wait()
    group_seconds = {g: b.seconds for g, b in _builds.items()}
    built = [b.seconds for b in _builds.values() if b.seconds is not None]
    build_seconds = max(built) if built else None
    build_log = "".join(b.log for b in _builds.values())


def _load(group: str) -> ctypes.CDLL:
    start()
    b = _builds[group]
    b.wait()
    with _lock:
        if b.lib is None:
            lib = ctypes.CDLL(str(b.path))
            for name, (argtypes, restype) in _SIGNATURES[group].items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            b.lib = lib
    return b.lib


class _Library:
    """The C entry points of every group: the first use of one waits for
    its group's library and keeps all that group's functions as attributes,
    so later uses are plain attribute reads."""

    def __getattr__(self, name):
        group = _GROUP_OF.get(name)
        if group is None:
            raise AttributeError(name)
        lib = _load(group)
        for n in _SIGNATURES[group]:
            setattr(self, n, getattr(lib, n))
        return getattr(lib, name)


_lib = _Library()


def library() -> _Library:
    """The kernel library, its build started on first call; an entry point
    waits for its own group's build only (``wait`` for all of them)."""
    if not _started:
        start()
    return _lib


def stream(t) -> int:
    """The raw handle of PyTorch's current stream on the card that holds the
    CUDA tensor ``t``, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def library_path(group: str) -> Path:
    """The path of a group's built library (waiting for its build)."""
    start()
    _builds[group].wait()
    return _builds[group].path


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
