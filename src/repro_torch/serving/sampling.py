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

Speculative decoding (``filtered_dist``, ``spec_accept``) keeps the same
keys: an accept test is one hashed uniform per key, and a categorical draw
from explicit probabilities is a Gumbel-max over their log with the noise
``sample()`` adds.  So where a residual equals the target's filtered
distribution, its draw is the token ``sample()`` gives on the same key, up
to rounding.
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


def filtered_dist(logits, temperature, top_k, top_p) -> torch.Tensor:
    """(S, V) float32 probabilities of exactly the distribution ``sample()``
    draws from: the softmax over the kept temperature-scaled logits, a
    one-hot at the argmax for greedy rows.  Speculation needs it for the
    drafter (proposal and acceptance ratio) and the target (verify and
    residual); any drift from ``sample()`` would bias the output."""
    greedy = torch.nn.functional.one_hot(logits.float().argmax(dim=-1),
                                         logits.shape[-1]).float()
    keep, scaled = keep_mask(logits, temperature, top_k, top_p)
    masked = torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))
    return torch.where(temperature[:, None] <= 0.0, greedy,
                       torch.softmax(masked, dim=-1))


def uniform_from(keys: torch.Tensor) -> torch.Tensor:
    """One U[0, 1) draw per key, any shape."""
    return (_hash32(keys) >> 8).float() * (1.0 / 2**24)


def categorical_from(keys: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One draw per key from the rows of ``probs`` (..., V) (zeros allowed):
    Gumbel-max over log p with ``sample()``'s noise; int64 (...)."""
    return (torch.log(probs) + gumbel(keys, probs.shape[-1])).argmax(dim=-1)


def spec_accept(
    p_dist: torch.Tensor,        # (S, k+1, V) target filtered dists
    q_dist: torch.Tensor,        # (S, k, V) drafter filtered dists
    drafts: torch.Tensor,        # (S, k) drafted tokens
    accept_keys: torch.Tensor,   # (S, k) keys, one per draft position
    sample_keys: torch.Tensor,   # (S, k+1) keys, one per candidate slot
    accept_mask=None,            # (S, k) bool; False forces rejection there
):
    """Standard speculative rejection sampling (leading accept + residual),
    as the reference's ``spec_accept``.

    Draft i is accepted iff u_i q_i(d_i) < p_i(d_i), u_i uniform (so with
    probability min(1, p/q)); the chain stops at the first rejection.  With
    n drafts accepted, the extra token comes from norm(max(p_n - q_n, 0)),
    or from p_k itself when all k are (the bonus: q padded with a zero
    row).  Greedy (one-hot p and q): a draft is accepted iff it is the
    target's argmax, and the extra token is the target's argmax.
    ``accept_mask`` truncates the chain (adaptive draft length); the caller
    zeroes ``q_dist`` there too, so a forced stop's residual is p.

    Returns (n_acc (S,) int64, extra (S,) int64).
    """
    S, k, V = q_dist.shape
    d = drafts.long()[..., None]
    p_at_d = torch.gather(p_dist[:, :k], 2, d)[..., 0]
    q_at_d = torch.gather(q_dist, 2, d)[..., 0]
    accept = uniform_from(accept_keys) * q_at_d.clamp(min=1e-30) < p_at_d
    if accept_mask is not None:
        accept = accept & accept_mask
    n_acc = accept.long().cumprod(dim=1).sum(dim=1)
    q_pad = torch.cat([q_dist, q_dist.new_zeros(S, 1, V)], dim=1)
    sel = n_acc[:, None, None].expand(S, 1, V)
    p_sel = torch.gather(p_dist, 1, sel)[:, 0]
    resid = (p_sel - torch.gather(q_pad, 1, sel)[:, 0]).clamp(min=0.0)
    z = resid.sum(dim=-1, keepdim=True)
    # z = 0 only where q covers p exactly: fall back to p, still unbiased
    resid = torch.where(z > 0, resid / z.clamp(min=1e-30), p_sel)
    key_sel = torch.gather(sample_keys, 1, n_acc[:, None])[:, 0]
    return n_acc, categorical_from(key_sel, resid)


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
