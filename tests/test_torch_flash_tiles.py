"""The freedoms that the tensor-core B5, B6 and B7 (the bf16 operand mode of
``csrc/flash_attention.cu``) rely on, held on their plain versions
(``kernels/ref.py``) on the CPU.

- B7's query tile in the bf16 mode does not change the function: dk and dv
  summed over query tiles of 64 or of 128 agree to f32 summation error
  (rtol 1e-6, and atol 1e-6 of the output's largest entry for entries that
  cancel towards 0).
- B5's query tile does not change the function either: the tensor-core
  kernel blocks 128 query rows where the plain version walks 64, and the
  two give the same bits (a tile that a block visits but a row sees no key
  of adds exact zeros to the row, or is wiped by the next tile's alpha =
  0).
- B5's row sum of p in the bf16 mode follows the tensor-core fragments'
  order (``ref._mma_row_sum``): it is that order, written out lane by lane,
  bit for bit, and a plain ``sum`` to f32 rounding (rtol 1e-6).  The
  forward under it agrees with the forward under the 16-lane order of the
  other modes to f32 rounding (o and lse atol 1e-6).
- The f32 forward still walks ``ref._lane_row_sum``, and the bf16 and int8
  forwards walk ``ref._mma_row_sum`` (the int8 kernel, on the s8 tensor
  cores, sums l in the same fragments' order: its m16n8k32 accumulators
  share the m16n8k16 layout).
- B6's tiles in the bf16 mode do not change the function either: dq summed
  over key tiles of 16 (one MMA's keys), 32 (a warp's step in the
  tensor-core kernel) or 128 agrees with dq over the kernel's 64-key tiles
  (``FLASH_TILES["dq"]["bf16"]``) to f32 summation error, and the query
  tile changes no bit (dq's rows are independent).
- ds rounds to bf16 at one place whatever the tiles: once, element by
  element, before ds·k.  dq under every tiling agrees to f32 summation
  error with ds rounded to bf16 times k rounded to bf16 summed in float64,
  and not with the same product of the unrounded ds (the control).
- The bf16 mode's products over d (q·kᵀ, do·vᵀ) are summed in the
  tensor-core kernels' order (``ref._mma_dot``): it is that order written
  out element by element with exact sums (each 16 products and the running
  f32 value, rounded toward zero), bit for bit, and a plain f32 matmul of
  the bf16 operands to f32 summation error, though not bit for bit.
- Against the reference: the bf16 plain forward at the kernel's contract
  matches the reference's plain attention under the bf16 policy at the
  tier at which tests/test_torch_amp.py holds the port's bf16 attention to
  it (atol 1e-2: the two round p at different places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402

BF16 = QuantPolicy("bf16")

# B, S, H, K, d, window, softcap, scale
CASES = {
    "causal": (2, 256, 4, 4, 32, 0, 0.0, 0.125),
    "GQA, ragged S": (1, 200, 6, 2, 32, 0, 0.0, 0.125),
    "window 48": (1, 320, 4, 2, 16, 48, 0.0, 0.125),
    "softcap 20": (1, 192, 4, 2, 32, 0, 20.0, 0.5),
}


def _inputs(B, S, H, K, d, seed):
    """q (the caller scales it), k, v and do, float32, from numpy."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, S, H, d), dtype=np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, K, d), dtype=np.float32))
            for _ in range(2))
    return q, k, v, do


def _close(got, want, what):
    tol = 1e-6 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=tol, msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dkv_bf16_query_tile_is_free(case, monkeypatch):
    B, S, H, K, d, window, softcap, scale = CASES[case]
    q, k, v, do = _inputs(B, S, H, K, d, seed=3)
    qs = q * scale
    kw = dict(causal=True, window=window, softcap=softcap, policy=BF16)
    o, lse = ref.flash_fwd_ref(qs, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    out = {}
    for tq in (64, 128):
        monkeypatch.setitem(ref.FLASH_TILES["dkv"], "bf16", (tq, 64))
        out[tq] = ref.flash_bwd_ref(qs, k, v, do, lse, delta, **kw)
    assert ref.flash_tile("dkv", BF16) == (128, 64)
    for name, a, b in zip(("dk", "dv"), out[64][1:], out[128][1:]):
        _close(a, b, name)
    torch.testing.assert_close(out[64][0], out[128][0], rtol=0, atol=0)   # dq: B6's tiles


def _dq_inputs(case, seed):
    """(qs, k, v, do, lse, delta, kw) of a case under the bf16 policy."""
    B, S, H, K, d, window, softcap, scale = CASES[case]
    q, k, v, do = _inputs(B, S, H, K, d, seed=seed)
    qs = q * scale
    kw = dict(causal=True, window=window, softcap=softcap, policy=BF16)
    o, lse = ref.flash_fwd_ref(qs, k, v, **kw)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return qs, k, v, do, lse, delta, kw


def _dq_at(tiles, monkeypatch, *args, **kw):
    monkeypatch.setitem(ref.FLASH_TILES["dq"], "bf16", tiles)
    return ref.flash_bwd_ref(*args, **kw)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_bf16_tiles_are_free(case, monkeypatch):
    qs, k, v, do, lse, delta, kw = _dq_inputs(case, seed=6)
    tiles = ref.FLASH_TILES["dq"]["bf16"]
    assert tiles == (64, 64)   # flash_bwd_dq_tc_kernel: 4 warps of 16 rows, 64-key tiles
    args = (qs, k, v, do, lse, delta)
    kernel = _dq_at(tiles, monkeypatch, *args, **kw)
    for keys in (16, 32, 128):
        _close(_dq_at((tiles[0], keys), monkeypatch, *args, **kw), kernel, f"dq, {keys}-key tiles")
    for rows in (16, 128):
        assert torch.equal(_dq_at((rows, tiles[1]), monkeypatch, *args, **kw), kernel)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_bf16_rounds_ds_once_before_ds_k(case, monkeypatch):
    """ds as flash_bwd_ref forms it (p from lse, masked, (dp - delta), the
    softcap's 1 - t^2, the scale), rounded to bf16, times k rounded to bf16
    with float64 sums: every tiling's dq is that to f32 summation error,
    and the unrounded ds is not."""
    B, S, H, K, d, window, softcap, scale = CASES[case]
    qs, k, v, do, lse, delta, kw = _dq_inputs(case, seed=8)
    qh, kh, vh = ref._heads(qs, k, v)
    s, t = ref._capped_logits(qh, kh, scale=1.0, softcap=softcap, policy=BF16)
    mask = ref._visible(S, S, True, window, qs.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = ref._d_dot(do.transpose(1, 2).float(), vh.transpose(-1, -2), BF16)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1 - t * t)
    kb = kh.bfloat16().double()
    rounded = (ds.bfloat16().double() @ kb).float().transpose(1, 2)
    unrounded = (ds.double() @ kb).float().transpose(1, 2)
    for keys in (16, 64, 128):
        got = _dq_at((64, keys), monkeypatch, qs, k, v, do, lse, delta, **kw)
        _close(got, rounded, f"dq, {keys}-key tiles, against ds rounded once")
        with pytest.raises(AssertionError):
            _close(got, unrounded, "dq against the unrounded ds")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_bf16_query_tile_is_free(case, monkeypatch):
    B, S, H, K, d, window, softcap, scale = CASES[case]
    q, k, v, _ = _inputs(B, S, H, K, d, seed=4)
    kw = dict(causal=True, window=window, softcap=softcap, policy=BF16)
    out = {}
    for tq in (64, 128):
        monkeypatch.setitem(ref.FLASH_TILES["fwd"], "bf16", (tq, 128))
        out[tq] = ref.flash_fwd_ref(q * scale, k, v, **kw)
    assert torch.equal(out[64][0], out[128][0]) and torch.equal(out[64][1], out[128][1])


def _mma_dot_written_out(a, b):
    """ref._mma_dot element by element: exact sums (Fraction) of each 16
    products of d and the running float32 value, rounded toward zero."""
    from fractions import Fraction

    a = a.to(torch.bfloat16).double().numpy()
    b = b.to(torch.bfloat16).double().numpy()
    out = np.zeros(a.shape[:-1] + b.shape[-1:], dtype=np.float32)
    for idx in np.ndindex(out.shape):
        *lead, i, j = idx
        acc = np.float32(0.0)
        for c0 in range(0, a.shape[-1], 16):
            exact = Fraction(float(acc)) + sum(
                Fraction(float(a[(*lead, i, c)])) * Fraction(float(b[(*lead, c, j)]))
                for c in range(c0, min(c0 + 16, a.shape[-1])))
            y = np.float32(float(exact))
            if abs(Fraction(float(y))) > abs(exact):
                y = np.nextafter(y, np.float32(0.0))
            acc = y
        out[idx] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("d", [40, 64, 20])
def test_mma_dot_is_the_tensor_core_order(d):
    rng = np.random.default_rng(d)
    # values over several binades, so that orders and roundings give other bits
    a = torch.from_numpy((rng.standard_normal((2, 6, d)) * 2.0 ** rng.integers(-6, 4, (2, 6, d)))
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((2, d, 5)) * 2.0 ** rng.integers(-6, 4, (2, d, 5)))
                         .astype(np.float32))
    got = ref._mma_dot(a, b)
    assert got.dtype == torch.float32 and torch.equal(got, _mma_dot_written_out(a, b))
    plain = ref.kernel_dot(a, b, BF16)
    _close(got, plain, "the MMA order against an f32 matmul")
    assert torch.equal(ref._d_dot(a, b, BF16), got)
    assert torch.equal(ref._d_dot(a, b, None), ref.kernel_dot(a, b, None))


def test_mma_dot_and_f32_matmul_differ():
    """The two orders are not the same function (so the bf16 plain versions
    have to pick one)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    assert not torch.equal(ref._mma_dot(a, b), ref.kernel_dot(a, b, BF16))


def _mma_order(p, width):
    """The bf16 kernel's row sum written out: lane t adds keys 8 j + 2 t, then
    8 j + 2 t + 1, for j = 0, 1, ... from 0.0; then lanes xor 1, then xor 2."""
    x = torch.nn.functional.pad(p, (0, width - p.shape[-1]))
    lanes = []
    for t in range(4):
        acc = torch.zeros_like(x[..., 0])
        for j in range(width // 8):
            for e in range(2):
                acc = acc + x[..., 8 * j + 2 * t + e]
        lanes.append(acc)
    lanes = [lanes[t] + lanes[t ^ 1] for t in range(4)]
    return (lanes[0] + lanes[2])[..., None]


@pytest.mark.parametrize("n", [128, 100, 9, 1])
def test_mma_row_sum_is_the_fragment_order(n):
    rng = np.random.default_rng(n)
    # values over many binades, so that another order gives other bits
    p = torch.from_numpy((rng.random((3, 5, n)) * 2.0 ** rng.integers(-20, 1, (3, 5, n)))
                         .astype(np.float32))
    got = ref._mma_row_sum(p, 128)
    assert torch.equal(got, _mma_order(p, 128))
    torch.testing.assert_close(got, p.sum(-1, keepdim=True), rtol=1e-6, atol=0)


def test_mma_and_lane_orders_differ():
    """The two orders are not the same function in f32: a row where they
    give other bits exists (so the bf16 plain version has to pick one)."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy((rng.random((64, 128)) * 2.0 ** rng.integers(-24, 1, (64, 128)))
                         .astype(np.float32))
    assert not torch.equal(ref._mma_row_sum(p, 128), ref._lane_row_sum(p, 128))


@pytest.mark.parametrize("mode,walks", [("none", "_lane_row_sum"), ("int8", "_mma_row_sum"),
                                        ("bf16", "_mma_row_sum")])
def test_forward_row_sum_by_mode(mode, walks, monkeypatch):
    calls = {"_lane_row_sum": 0, "_mma_row_sum": 0}
    for name in calls:
        real = getattr(ref, name)

        def spy(p, width, _name=name, _real=real):
            calls[_name] += 1
            return _real(p, width)

        monkeypatch.setattr(ref, name, spy)
    q, k, v, _ = _inputs(1, 300, 2, 1, 16, seed=1)
    ref.flash_fwd_ref(q * 0.25, k, v, causal=True, policy=QuantPolicy(mode))
    assert calls[walks] == 3 and sum(calls.values()) == 3   # one call a 128-key tile


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_order_changes_only_rounding(case, monkeypatch):
    B, S, H, K, d, window, softcap, scale = CASES[case]
    q, k, v, _ = _inputs(B, S, H, K, d, seed=5)
    kw = dict(causal=True, window=window, softcap=softcap, policy=BF16)
    o, lse = ref.flash_fwd_ref(q * scale, k, v, **kw)
    monkeypatch.setattr(ref, "_mma_row_sum", ref._lane_row_sum)
    o2, lse2 = ref.flash_fwd_ref(q * scale, k, v, **kw)
    torch.testing.assert_close(o, o2, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_matches_reference_plain(case):
    """The reference's attention under its bf16 policy (``ops.attention``,
    ``impl="ref"``: its plain version), on the same numpy inputs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.quant import QuantPolicy as JPolicy

    B, S, H, K, d, window, softcap, scale = CASES[case]
    q, k, v, _ = _inputs(B, S, H, K, d, seed=7)
    o, _ = ref.flash_fwd_ref(q * scale, k, v, causal=True, window=window,
                             softcap=softcap, policy=BF16)
    want = jops.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(v.numpy()), scale=scale, causal=True, window=window,
                          softcap=softcap, impl="ref", policy=JPolicy("bf16"))
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0, atol=1e-2)
