"""The port's kernel build (src/repro_torch/kernels/build.py) on the CPU,
with a stand-in for nvcc: every source in exactly one group, every C entry
point defined in its group's sources, a group's library ready while
another group still compiles, the cache, and no compiler left running.
Nothing here compiles CUDA (no nvcc on this machine); the card builds the
real libraries in chip_smoke.py."""
import re
import stat
import time

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

# the stand-in: "compiles" a source by sleeping (0.1 s for B1's, SLOW s for
# the others), prints a ptxas line, writes its output; "-shared" writes the
# library
STAND_IN = """#!/bin/sh
out=""; src=""; shared=0
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; -c) src="$2"; shift;; -shared) shared=1;; esac
  shift
done
if [ $shared = 1 ]; then echo lib > "$out"; exit 0; fi
case "$(basename "$src")" in rmsnorm.cu) sleep 0.1;; *) sleep {slow};; esac
echo "ptxas info    : Used 1 registers ($(basename "$src"))"
echo obj > "$out"
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A fresh build state over ``tmp_path`` with the stand-in compiler;
    returns a function that writes the stand-in for a given SLOW."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build, "_builds", {})
    monkeypatch.setattr(build, "_started", False)
    monkeypatch.setattr(build, "build_seconds", None)
    monkeypatch.setattr(build, "build_log", "")
    nvcc = tmp_path / "nvcc"
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))

    def write(slow):
        nvcc.write_text(STAND_IN.replace("{slow}", str(slow)))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)

    yield write
    build._stop()


def test_groups_name_every_source_once_and_define_their_entry_points():
    names = [n for group in build.GROUPS.values() for n in group]
    assert sorted(names) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert len(names) == len(set(names))
    assert set(build._SIGNATURES) == set(build.GROUPS)
    for group, sigs in build._SIGNATURES.items():
        text = "".join((build.CSRC / n).read_text() for n in build.GROUPS[group])
        defined = set(re.findall(r'extern "C"[^(]*?\b(repro_\w+)\s*\(', text))
        assert set(sigs) <= defined, (group, set(sigs) - defined)
        assert all(build._GROUP_OF[name] == group for name in sigs)


def test_a_group_is_ready_while_another_compiles_and_the_cache_is_used(stand_in):
    stand_in(1.5)
    t = time.monotonic()
    build.start()
    path = build.library_path("rmsnorm")
    first = time.monotonic() - t
    assert path.exists() and first < 1.0, first
    assert not build._builds["decode_attention"].done.is_set()
    build.wait()
    assert all(b.path.exists() for b in build._builds.values())
    assert build.build_log.count("ptxas info") == len(list(build.CSRC.glob("*.cu")))
    assert build.build_seconds >= 1.5
    # a second process finds every library built: nothing runs, the log is kept
    log = build.build_log
    build._builds.clear()
    build._started = False
    t = time.monotonic()
    build.wait()
    assert time.monotonic() - t < 0.5
    assert build.build_seconds is None and build.build_log == log


def test_no_compiler_outlives_the_process(stand_in):
    stand_in(60)
    build.start()
    procs = [p for b in build._builds.values() for p in b.procs]
    assert any(p.poll() is None for p in procs)
    build._stop()
    assert all(p.wait(timeout=5) is not None for p in procs)
    with pytest.raises(RuntimeError, match="building librepro_decode_attention.so failed"):
        build.library_path("decode_attention")
