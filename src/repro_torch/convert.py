"""Carry the reference's weights into the port.

The reference keeps params as a nested pytree whose leaf paths are the
``flatten_meta`` dotted names; the port keeps a flat dict under the same
names and shapes (group params stacked over a leading layer axis in both).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.meta import flatten_tree


def params_from_numpy(tree: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested dicts (or a flat dict) of numpy arrays -> ``{dotted name:
    tensor}`` on ``device``, dtypes kept."""
    dev = resolve_device(device)
    flat = flatten_tree(tree, lambda x: isinstance(x, np.ndarray))
    return {name: torch.from_numpy(np.array(a, copy=True)).to(dev)
            for name, a in flat.items()}
