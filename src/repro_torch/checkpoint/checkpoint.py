"""Fault-tolerant checkpointing: atomic, async, restorable onto any device.

The port's copy of ``repro.checkpoint.checkpoint``, with the same API and
layout but written with ``torch.save`` (any dtype) and a JSON manifest:

    <dir>/step_<N>/
        state.pt         flat {path: tensor or number} of the state
        manifest.json    paths, shapes, dtypes, step, extra
    <dir>/LATEST         committed step pointer (written last = atomic)

  - step-atomic: a checkpoint only becomes visible once LATEST is atomically
    renamed over it; a crash mid-write leaves the previous one intact;
  - save can run in a background thread off the step's critical path
    (``async_save=True``); tensors are copied to host memory on the
    caller's thread first, so the step may go on changing its own.  Every
    save first waits for the one in flight, so writes commit in call order
    (the reference's synchronous save does not wait, and can be overtaken
    by an older async write that then moves LATEST back);
  - restore is device-independent: each leaf lands on the device and dtype
    of the template's leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import torch


def _flatten_with_paths(tree: Any) -> Dict[str, Any]:
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}/{i}")
        else:
            flat[prefix] = node

    rec(tree, "")
    return flat


def _unflatten_like(template: Any, flat: Dict[str, Any]) -> Any:
    def rec(node, prefix):
        if isinstance(node, dict):
            return {
                k: rec(node[k], f"{prefix}/{k}" if prefix else str(k))
                for k in node
            }
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v, f"{prefix}/{i}") for i, v in enumerate(node))
        value = flat[prefix]
        if isinstance(node, torch.Tensor):
            return value.to(device=node.device, dtype=node.dtype)
        return type(node)(value)

    return rec(template, "")


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return v


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(
        self, step: int, state: Any, extra: Optional[Dict] = None,
        async_save: bool = False,
    ) -> None:
        flat = {k: _to_host(v) for k, v in _flatten_with_paths(state).items()}
        # one write at a time, in call order: an older async write finishing
        # after a newer save would point LATEST back at the older step
        self.wait()
        if async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {})
            )
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, Any], extra: Dict):
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_ckpt_")
        try:
            torch.save(flat, os.path.join(tmp, "state.pt"))
            tensors = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}
            manifest = {
                "step": step,
                "keys": list(flat),
                "shapes": {k: list(v.shape) for k, v in tensors.items()},
                "dtypes": {k: str(v.dtype) for k, v in tensors.items()},
                "extra": extra,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            # commit: atomic pointer update
            ptr_tmp = os.path.join(self.directory, ".LATEST.tmp")
            with open(ptr_tmp, "w") as f:
                f.write(str(step))
            os.replace(ptr_tmp, os.path.join(self.directory, "LATEST"))
            self._gc()
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True
            )

    # ------------------------------------------------------------------
    def all_steps(self):
        return sorted(
            int(name.split("_")[1]) for name in os.listdir(self.directory)
            if name.startswith("step_")
        )

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(
        self, template: Any, step: Optional[int] = None,
    ) -> Tuple[Any, int, Dict]:
        """Restore into the structure of ``template``: every tensor onto the
        device and dtype of the template's tensor at the same path."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                          weights_only=True)
        return _unflatten_like(template, flat), step, manifest.get("extra", {})
