"""Vectorized per-request sampling: greedy / temperature / top-k / top-p.

The port's counterpart of ``repro.serving.sampling``.  Every knob is a
per-slot tensor, so one decode batch mixes greedy and stochastic requests:

  - temperature <= 0  -> greedy (argmax);
  - top_k <= 0        -> no top-k cut;
  - top_p >= 1        -> no nucleus cut.

Sort-free, as in the reference: both cuts are *value thresholds* found by
bisection (each step one O(V) compare + reduce, 30 steps to f32 precision):

  top-k:  keep x > tau_k  where tau_k = sup{v : |{x > v}| >= k}
  top-p:  keep x > tau_p  where tau_p = sup{v : mass(x > v) >= top_p}

Randomness.  torch cannot replay the reference's ``jax.random`` keys, so the
port keeps their *property* instead: each draw is a pure function of (seed,
request, position, event tag), computed by a counter-based integer hash
(Wellons' lowbias32) in int64 tensor ops that give the same bits on the CPU
and the card.  A draw is a Gumbel-max over the filtered logits, with one
hashed uniform per (event, vocab entry).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF  # the house masking constant

_BISECT_STEPS = 30
_M32 = 0xFFFFFFFF


def default_params(n: int, device):
    """Greedy defaults: (temperature, top_k, top_p) tensors for n requests."""
    return (
        torch.zeros((n,), dtype=torch.float32, device=device),
        torch.zeros((n,), dtype=torch.int32, device=device),
        torch.ones((n,), dtype=torch.float32, device=device),
    )


# ---------------------------------------------------------------------------
# counter-based random bits
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without overflow:
    the constant is split into 16-bit halves so no product exceeds 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a 32-bit integer mix (x in [0, 2^32), int64)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def event_key(seed: int, pos, req, tag: int, device) -> torch.Tensor:
    """Key of one sampling event per slot: a hash of (seed, absolute input
    position, request, tag) — invariant to admission timing and slot."""
    as64 = lambda v: torch.as_tensor(v, device=device).to(torch.int64) & _M32
    k = _hash32(as64(seed))
    k = _hash32(k ^ as64(pos))
    k = _hash32(k ^ as64(req))
    return _hash32(k ^ tag)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """(..., V) standard Gumbel noise, one hashed uniform per (key, entry)."""
    v = torch.arange(V, dtype=torch.int64, device=keys.device)
    h = _hash32(_hash32(_mul32(v, 0x9E3779B1) ^ keys[..., None]))
    u = ((h >> 8).float() + 0.5) * (1.0 / 2**24)     # in (0, 1)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------

def _filter_thresholds(scaled, top_k, top_p):
    """(tau_k, tau_p) value thresholds, one per row of (S, V) scaled logits."""
    V = scaled.shape[-1]
    probs = torch.softmax(scaled, dim=-1)
    x_max = scaled.max(dim=-1).values
    lo0 = scaled.min(dim=-1).values - 1.0
    kk = torch.where(top_k > 0, top_k, V)
    # 2.0: mass(x > lo0) = 1 < 2 -> keep all
    tp = torch.where(top_p >= 1.0, torch.full_like(top_p, 2.0), top_p)
    lo_k, hi_k, lo_p, hi_p = lo0, x_max, lo0, x_max
    for _ in range(_BISECT_STEPS):
        mid_k = 0.5 * (lo_k + hi_k)
        above_k = (scaled > mid_k[:, None]).sum(dim=-1)
        up = above_k >= kk
        lo_k, hi_k = torch.where(up, mid_k, lo_k), torch.where(up, hi_k, mid_k)
        mid_p = 0.5 * (lo_p + hi_p)
        mass_p = torch.where(scaled > mid_p[:, None], probs, 0.0).sum(dim=-1)
        up = mass_p >= tp
        lo_p, hi_p = torch.where(up, mid_p, lo_p), torch.where(up, hi_p, mid_p)
    return lo_k, lo_p


def keep_mask(logits, temperature, top_k, top_p):
    """(S, V) bool: the entries the top-k / top-p filters keep (the mode
    always survives).  Also returns the temperature-scaled logits."""
    scaled = logits.float() / temperature.clamp(min=1e-6)[:, None]
    tau_k, tau_p = _filter_thresholds(scaled, top_k, top_p)
    keep = scaled > torch.maximum(tau_k, tau_p)[:, None]
    keep |= scaled == scaled.max(dim=-1, keepdim=True).values
    return keep, scaled


def sample(
    logits: torch.Tensor,        # (S, V)
    temperature: torch.Tensor,   # (S,) float32
    top_k: torch.Tensor,         # (S,) int32;  <= 0 disables
    top_p: torch.Tensor,         # (S,) float32; >= 1 disables
    keys: torch.Tensor,          # (S,) int64 event keys (see event_key)
) -> torch.Tensor:
    """Per-slot next-token sampling; returns (S,) int32."""
    greedy_tok = logits.float().argmax(dim=-1)
    keep, scaled = keep_mask(logits, temperature, top_k, top_p)
    masked = torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))
    tok = (masked + gumbel(keys, logits.shape[-1])).argmax(dim=-1)
    return torch.where(temperature <= 0.0, greedy_tok, tok).to(torch.int32)


def sample_token(logits, temperature, top_k, top_p, key) -> torch.Tensor:
    """Single-row convenience over :func:`sample`; returns () int32."""
    return sample(
        logits[None], temperature.reshape(1), top_k.reshape(1),
        top_p.reshape(1), key.reshape(1),
    )[0]
