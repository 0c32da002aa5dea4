"""Phase tracing: a lightweight host-side span tracer with JSONL export.

The port's counterpart of ``repro.obs.trace``, on the same monotonic clock
and with the same event schema.  It records where a token's latency goes —
the phases of a request's life in the serving engines (admission ->
chunk-prefill -> decode/verify -> retire), the sweep's candidate lifecycle,
and train-loop steps — as Chrome-trace-flavored events:

    {"name": "step", "ph": "X", "ts": <us since tracer start>,
     "dur": <us>, "args": {"phase": "decode", ...}}

``ph`` is "X" (complete span, has ``dur``) or "i" (instant event).  One
JSON object per line (:meth:`Tracer.dump` / ``path=``), so logs stream and
cheap tools (jq, pandas) read them without a closing bracket.

Device work never appears here directly: a span brackets the *host's* view
of a step, and PyTorch launches asynchronously, so a span is honest only
where it closes after a read-back (the train step's loss, the engines'
sampled tokens).  For kernel attribution, spans of the phases below carry a
``kernel`` arg naming the port's CUDA kernels that the phase launches, as
torch.profiler lists them, and ``profile_dir`` wraps a region in
``torch.profiler`` so the JSONL spans can be cross-referenced against its
Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

# host phase -> the port's CUDA kernels (kernels/csrc/*.cu, by the name of
# their __global__ functions) that every step of the phase launches:
#   - prefill: a one-shot admission's full-prompt forward, its attention
#     plain (positions are not 0..S-1), B1 in every norm;
#   - chunk_prefill: a chunk's paged forward, B9 in every layer;
#   - decode: the (n_slots, 1) paged forward, B8 in every layer;
#   - verify: a speculative iteration, the drafter's steps through B8 and
#     its catch-up and the target's verify through B9;
#   - train_step: the f32 step, B1-B4 (B5-B7 only under --amp).
PHASE_KERNELS: Dict[str, str] = {
    "prefill": "rmsnorm_kernel",
    "chunk_prefill": "flash_decode_multi_kernel+rmsnorm_kernel",
    "decode": "flash_decode_kernel+rmsnorm_kernel",
    "verify": "flash_decode_multi_kernel+flash_decode_kernel+rmsnorm_kernel",
    "train_step": "rmsnorm_kernel+rmsnorm_bwd_kernel+ce_fwd_kernel+ce_bwd_kernel",
}


class Tracer:
    """Monotonic-clock span/event recorder.

    ``path`` streams events as JSONL while recording; without it events
    accumulate in ``self.events`` (bounded by ``max_events``) for a later
    :meth:`dump`.  ``profile_dir`` arms :meth:`profile` to wrap a region in
    ``torch.profiler`` (CUDA activity included when a card is in use) and
    write its Chrome trace there; it is a no-op when unset, so call sites
    don't need to branch.
    """

    def __init__(self, path: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 max_events: int = 200_000):
        self.t0 = time.monotonic()
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0
        self.profile_dir = profile_dir
        self._profiling = False
        self._file = open(path, "w") if path else None

    # ------------------------------------------------------------------
    def now_us(self) -> float:
        return (time.monotonic() - self.t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        if self._file is not None:
            self._file.write(json.dumps(ev) + "\n")
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def event(self, name: str, **args: Any) -> None:
        """Instant event (admission granted, slot retired, candidate pruned)."""
        self._emit({"name": name, "ph": "i", "ts": self.now_us(),
                    **({"args": args} if args else {})})

    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Complete span around a host-side phase.  Adds the phase's kernel
        names (PHASE_KERNELS; args win on clash)."""
        phase = args.get("phase", name)
        if phase in PHASE_KERNELS and "kernel" not in args:
            args["kernel"] = PHASE_KERNELS[phase]
        ts = self.now_us()
        try:
            yield
        finally:
            self._emit({"name": name, "ph": "X", "ts": ts,
                        "dur": self.now_us() - ts,
                        **({"args": args} if args else {})})

    def complete(self, name: str, t_start: float, t_end: float,
                 **args: Any) -> None:
        """Record an already-timed span from two ``time.monotonic()`` stamps.

        The non-contextmanager spelling for hot loops (the dynamic engine's
        per-step path): the caller times the region itself — with stamps it
        already takes for other bookkeeping — and this just emits.
        """
        phase = args.get("phase", name)
        if phase in PHASE_KERNELS and "kernel" not in args:
            args["kernel"] = PHASE_KERNELS[phase]
        self._emit({"name": name, "ph": "X",
                    "ts": (t_start - self.t0) * 1e6,
                    "dur": (t_end - t_start) * 1e6,
                    **({"args": args} if args else {})})

    @contextlib.contextmanager
    def profile(self, label: str = "obs") -> Iterator[None]:
        """Wrap a region in ``torch.profiler.profile`` when ``profile_dir``
        is set (else a pure no-op) and write its Chrome trace to
        ``<profile_dir>/<label>.trace.json``.  Non-reentrant by
        construction (one profiler at a time), so nested calls no-op too.
        The ``profile_stop`` event names the file."""
        if self.profile_dir is None or self._profiling:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        out = os.path.join(self.profile_dir, f"{label}.trace.json")
        self._profiling = True
        self.event("profile_start", dir=self.profile_dir, label=label)
        try:
            with torch.profiler.profile(activities=activities) as prof:
                yield
            prof.export_chrome_trace(out)
        finally:
            self._profiling = False
            self.event("profile_stop", label=label, path=out)

    # ------------------------------------------------------------------
    def dump(self, path: str) -> int:
        """Write accumulated events as JSONL; returns the event count."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read a trace file back (schema check in tests, ad-hoc analysis)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out

