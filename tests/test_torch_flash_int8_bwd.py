"""The int8 backward of flash attention as the tensor-core kernels run it:
a pre-pass that quantizes q, k, v and do once, then B6 and B7 on the s8
tensor cores.  Held here on the CPU through its plain versions, against
the reference on the same numpy inputs, and on the card against them.

- The pre-pass's plain version (``ref.flash_quant_bwd_ref``) gives the
  bytes and scales of the reference's ``repro.quant.core.quantize_int8``
  (run through JAX on the CPU) on every output: per row over d (zero-padded
  to DP = 64 or 128), and per column over each 128-row tile, stored
  K-major in the fragments' order (``ref.FRAG_PERM``), rows past S or T
  zeros.  Exact: equal bytes, equal scales.
- ``ref.flash_bwd_i8_ref``, ``flash_bwd_ref`` restated on those bytes as
  the kernels compute (p and ds quantized per row over each tile and
  permuted like the tiles), gives dq, dk and dv bit-equal to
  ``flash_bwd_ref`` (the int8 products are exact integers, so a
  permutation of the contraction axis changes no sum), and, composed as
  ``ops.attention`` composes B5-B7, lies within the int8 tier of the
  reference's interpret-mode kernels at 128 x 128 blocks, as
  tests/test_torch_amp_int8.py holds ``flash_bwd_ref``: each output's max
  abs error within 5e-2, its mean within 3e-5.
- ``FRAG_PERM``, written out from the m16n8k32 fragment layouts, is a
  bijection of each 16-group, and the int32 product is unchanged when it
  permutes A's columns and B's rows.
- The kernels' quantization from a row's reciprocal (``quant_rcp``, with
  the IEEE quotient near half steps), mirrored in float32 numpy, gives
  the IEEE quotient's bytes (``quantize_int8``'s), near half steps and
  for tiny values included.
- On the card (``gpu`` marker): the pre-pass byte for byte, and B6 and B7
  against their plain versions by chip_smoke.py's int8 checks.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402

INT8 = QuantPolicy("int8")
INT8_MAX_ERR = 5e-2     # the int8 tier against f32
INT8_MEAN_ERR = 3e-5


@pytest.fixture(scope="module")
def jx():
    """The reference's quantizer and attention, imported only by the tests
    that compare with them (the machine with the card runs the GPU tests
    without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.quant import QuantPolicy as JPolicy
    from repro.quant.core import quantize_int8

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=jops, quantize=quantize_int8,
                                 int8=JPolicy("int8"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, T, H, K, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, d), (B, T, K, d), (B, T, K, d), (B, S, H, d))]


# ---------------------------------------------------------------------------
# (a) the pre-pass's plain version against the reference's quantize_int8
# ---------------------------------------------------------------------------

# B, S, T, H, K, d
PREPASS_CASES = {
    "ragged S 200 / T 190, d 40 -> DP 64, GQA 9/3": (2, 200, 190, 9, 3, 40),
    "d 96 -> DP 128, S 130": (1, 130, 130, 4, 2, 96),
    "d 64, two whole tiles": (1, 256, 256, 2, 2, 64),
    "d 256 -> DP 256, S 130 / T 120, gemma2's 8/4 heads": (1, 130, 120, 8, 4, 256),
}


def _want_rows(jx, x, DP):
    """Per row over d of (B, R, heads, d): bytes (B, R, heads, DP), scales
    (B, heads, R), from the reference's quantizer."""
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, DP - x.shape[-1])))
    q8, s = jx.quantize(jx.jnp.asarray(xp), axis=-1)
    return np.asarray(q8), np.asarray(s)[..., 0].transpose(0, 2, 1)


def _want_cols(jx, x, DP):
    """Per column over each 128-row tile of (B, R, heads, d), transposed to
    (B, heads, tiles, DP, 128) with each 16-group in FRAG_PERM order, and
    the scales (B, heads, tiles, DP)."""
    B, R, heads, d = x.shape
    n = -(-R // 128)
    xp = np.pad(x, ((0, 0), (0, n * 128 - R), (0, 0), (0, DP - d)))
    q8, s = jx.quantize(jx.jnp.asarray(xp.reshape(B, n, 128, heads, DP)), axis=2)
    q8 = np.asarray(q8).transpose(0, 3, 1, 4, 2)
    perm = [16 * (i // 16) + ref.FRAG_PERM[i % 16] for i in range(128)]
    return q8[..., perm], np.asarray(s)[:, :, 0].transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", sorted(PREPASS_CASES))
def test_prepass_plain_matches_reference_quantizer(jx, case):
    """Every output of the pre-pass's plain version, shapes and dtypes as
    the kernel's wrapper allocates them, equal to the reference's bytes and
    scales."""
    B, S, T, H, K, d = PREPASS_CASES[case]
    q, k, v, do = _inputs(B, S, T, H, K, d)
    got = ref.flash_quant_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, do)))
    shapes = fa.i8_shapes(B, S, T, H, K, d)
    assert set(got) == set(fa.I8_FIELDS) == set(shapes)
    for name, t in got.items():
        assert (tuple(t.shape), t.dtype) == shapes[name], name
    DP = fa.padded_d(d)
    want = {}
    for name, x in (("q", q), ("do", do), ("k", k), ("v", v)):
        want[name + "8"], want["s" + name] = _want_rows(jx, x, DP)
    for name, x in (("q", q), ("do", do), ("k", k)):
        want[name + "T8"], want["s" + name + "c"] = _want_cols(jx, x, DP)
    for name in fa.I8_FIELDS:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=f"{case} {name}")
    # rows past S and T, and d past the head dim, are zeros in the tiles
    n_pad = -(-T // 128) * 128 - T
    if n_pad:
        inv = np.argsort([16 * (i // 16) + ref.FRAG_PERM[i % 16] for i in range(128)])
        assert not got["kT8"][:, :, -1].numpy()[..., inv][..., 128 - n_pad:].any()
    assert not got["qT8"][:, :, :, d:].numpy().any()


# ---------------------------------------------------------------------------
# (b) the backward on the pre-quantized operands
# ---------------------------------------------------------------------------

# B, S, H, K, d, window, softcap, scale
BWD_CASES = {
    "causal, GQA 4/2": (1, 256, 4, 2, 64, 0, 0.0, 0.125),
    "window 48, GQA 9/3": (1, 256, 9, 3, 64, 48, 0.0, 0.125),
    "softcap 20": (1, 256, 4, 2, 64, 0, 20.0, 0.5),
    "d_head 96 (DP 128)": (1, 256, 2, 2, 96, 0, 0.0, 0.125),
    # gemma2's heads of 256 (DP 256) with its softcap 50 and a window
    "d_head 256, window 48, softcap 50": (1, 256, 4, 2, 256, 48, 50.0, 0.0625),
}
# ragged rows and keys (no reference comparison: its blocks must divide S)
RAGGED_CASES = {
    "ragged S 200, d 40, GQA 9/3": (2, 200, 9, 3, 40, 0, 0.0, 0.125),
    "ragged S 190, d 128, softcap": (1, 190, 4, 4, 128, 0, 20.0, 0.5),
    "ragged S 130, d 200 (DP 256)": (1, 130, 4, 2, 200, 0, 0.0, 0.0625),
}


def _contract(arrays, *, scale, window, softcap, restated):
    """(o, dq, dk, dv) composed as ops.attention composes B5-B7 (the scale
    folded into q, delta = rowsum(do * o)) from the int8 plain versions:
    the backward from flash_bwd_ref, or restated on the pre-pass's bytes."""
    q, k, v, do = (torch.from_numpy(a.copy()) for a in arrays)
    kw = dict(causal=True, window=window, softcap=softcap)
    qs = q * scale
    o, lse = ref.flash_fwd_ref(qs, k, v, policy=INT8, **kw)
    delta = (do * o).sum(-1).transpose(1, 2)
    if restated:
        ops_ = ref.flash_quant_bwd_ref(qs, k, v, do)
        dq, dk, dv = ref.flash_bwd_i8_ref(ops_, lse, delta, d=q.shape[-1], **kw)
    else:
        dq, dk, dv = ref.flash_bwd_ref(qs, k, v, do, lse, delta, policy=INT8, **kw)
    return [o, dq * scale, dk, dv]


@pytest.mark.parametrize("case", sorted(BWD_CASES) + sorted(RAGGED_CASES))
def test_restated_backward_is_bit_equal_to_flash_bwd_ref(case):
    B, S, H, K, d, window, softcap, scale = {**BWD_CASES, **RAGGED_CASES}[case]
    arrays = _inputs(B, S, S, H, K, d)
    kw = dict(scale=scale, window=window, softcap=softcap)
    got = _contract(arrays, restated=True, **kw)
    want = _contract(arrays, restated=False, **kw)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.equal(g, w), (case, name, float((g - w).abs().max()))


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_restated_backward_matches_reference_kernel(jx, case):
    """Within the int8 tier of the reference's interpret-mode B5-B7 at 128 x
    128 blocks: max abs error 5e-2, mean 3e-5."""
    B, S, H, K, d, window, softcap, scale = BWD_CASES[case]
    arrays = _inputs(B, S, S, H, K, d)
    q, k, v, do = (jx.jnp.asarray(a) for a in arrays)

    def f(q, k, v):
        return jx.ops.attention(q, k, v, scale=scale, causal=True, window=window,
                                softcap=softcap, block_q=128, block_k=128,
                                impl="interpret", policy=jx.int8)

    o, vjp = jx.jax.vjp(f, q, k, v)
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(do)]
    got = _contract(arrays, scale=scale, window=window, softcap=softcap, restated=True)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        err = np.abs(g.numpy() - w)
        assert err.max() <= INT8_MAX_ERR and err.mean() <= INT8_MEAN_ERR, \
            (case, name, float(err.max()), float(err.mean()))


# ---------------------------------------------------------------------------
# (c) the fragments' permutation
# ---------------------------------------------------------------------------

def _accumulator_columns(t):
    """The columns of a 16-column group that lane (g, t) holds in the s32
    accumulators of two m16n8k32 n-tiles: (n-tile j, element e) at column
    8 j + 2 t + e."""
    return [8 * j + 2 * t + e for j in range(2) for e in range(2)]


def _a_positions(t):
    """The k positions of a 16-group that lane (g, t) supplies as its four
    A bytes (a0 or a2): 4 t .. 4 t + 3."""
    return [4 * t + e for e in range(4)]


def test_frag_perm_is_the_accumulator_to_fragment_map():
    """Packing each lane's accumulator columns, in order, as its A bytes
    puts column FRAG_PERM[p] at position p; the map is a bijection of the
    16-group, and TILE_PERM repeats it over each group of a 128 tile."""
    perm = [None] * 16
    for t in range(4):
        for pos, col in zip(_a_positions(t), _accumulator_columns(t)):
            perm[pos] = col
    assert tuple(perm) == ref.FRAG_PERM
    assert sorted(ref.FRAG_PERM) == list(range(16))
    assert sorted(ref.TILE_PERM) == list(range(128))
    assert all(ref.TILE_PERM[i] // 16 == i // 16 for i in range(128))


def test_frag_perm_leaves_the_int8_product_unchanged():
    """A (m, 128) @ B (128, n) of int8 values, exact in int64, equals the
    product with A's columns and B's rows both in TILE_PERM order; a
    permutation of one side alone does not."""
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (16, 128)).astype(np.int64)
    b = rng.integers(-127, 128, (128, 8)).astype(np.int64)
    perm = list(ref.TILE_PERM)
    np.testing.assert_array_equal(a[:, perm] @ b[perm], a @ b)
    assert (a[:, perm] @ b != a @ b).any()


def _quant(x, scale):
    """quantize_int8's byte in float32, as the dp4a kernels formed it:
    rint(x / max(scale, 1e-12)) by IEEE division, half to even, clipped to
    +-127."""
    sc = np.maximum(scale, np.float32(1e-12))
    return np.clip(np.rint(x / sc), -127, 127).astype(np.int8)


def _quant_rcp(x, scale):
    """quant_rcp of csrc/flash_attention.cu in float32: x * (1 / sc), and
    the IEEE quotient only within 2^-12 of a half step."""
    sc = np.maximum(scale, np.float32(1e-12))
    rcp = np.float32(1) / sc
    y = x * rcp
    r = np.rint(y)
    near = np.abs(np.abs(y - r) - np.float32(0.5)) < np.float32(2.0 ** -12)
    r = np.where(near, np.rint(x / sc), r)
    return np.clip(r, -127, 127).astype(np.int8), near


def test_reciprocal_quantization_gives_quant_bytes():
    """The kernels quantize p, ds and the pre-pass's values as x * (1 /
    scale) with the IEEE quotient near half steps: the same bytes as
    _quant over rows of normal values, of tiny and denormal values, and of
    values a few ulps from every half step (where the fallback is taken)."""
    rng = np.random.default_rng(11)
    with np.errstate(over="ignore", under="ignore"):
        rows = [rng.standard_normal((4096, 128)).astype(np.float32),
                (rng.standard_normal((4096, 128)) * 1e-38).astype(np.float32),
                np.exp(rng.uniform(-100, 0, (4096, 128))).astype(np.float32)]
        amax = np.abs(rows[0]).max(-1, keepdims=True)
        scale = amax / np.float32(127)
        k = rng.integers(-127, 127, (4096, 128)).astype(np.float32)
        half = ((k + np.float32(0.5)) * scale).astype(np.float32)
        steps = rng.integers(-3, 4, half.shape)
        rows.append(np.nextafter(half, np.where(steps > 0, np.inf, -np.inf)).astype(np.float32)
                    * (steps != 0) + half * (steps == 0))
        taken = 0
        for x in rows:
            s = np.abs(x).max(-1, keepdims=True) / np.float32(127)
            if x is rows[-1]:
                s = scale
            got, near = _quant_rcp(x, s)
            np.testing.assert_array_equal(got, _quant(x, s))
            taken += int(near.sum())
    assert taken > 0    # the fallback was exercised


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(range(19)))
def test_int8_backward_kernels_match_plain_on_card(case):
    """On chip_smoke.py's FLASH_CASES row ``case``: the pre-pass's bytes and
    scales equal its plain version's; B6 and B7 (one pre-pass, as
    ops.attention runs them) pass chip_smoke's int8 checks against
    flash_bwd_ref (max within the int8 tier, mean within FLASH_MEAN_TOL)
    and equal flash_bwd_i8_ref; dk/dv the same bits when repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    cs = _chip_smoke()
    label, B, S, H, K, d, window, cap, scale, dt = cs.FLASH_CASES[case]
    q, k, v, do = cs.flash_inputs(B, S, H, K, d, dt, case)
    qs = (q.float() * scale).to(dt)
    kw = dict(causal=True, window=window, softcap=cap, policy=INT8)
    got_ops, want_ops = fa.quantize_bwd(qs, k, v, do), ref.flash_quant_bwd_ref(qs, k, v, do)
    for name in fa.I8_FIELDS:
        assert torch.equal(got_ops[name], want_ops[name]), (label, name)
    o, lse = fa.flash_fwd(qs, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    n0 = ops.launch_counts()
    got = fa.flash_bwd(qs, k, v, do, lse, delta, **kw)
    n1 = ops.launch_counts()
    assert [n1[n] - n0[n] for n in ("flash_bwd_quant_int8", "flash_bwd_dq_int8",
                                    "flash_bwd_dkv_int8")] == [1, 1, 1]
    want = ref.flash_bwd_ref(qs, k, v, do, lse, delta, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert cs.rounds_like(name, cs.rounded_err(g, w), cs.INT8_MAX_TOL), (label, name)
    restated = ref.flash_bwd_i8_ref(want_ops, lse, delta, d=d, causal=True, window=window,
                                    softcap=cap)
    for name, g, w in zip(("dq", "dk", "dv"), got, restated):
        assert torch.equal(g, w), (label, name, float((g - w).abs().max()))
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, lse, delta, **kw)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])


# ---------------------------------------------------------------------------
# (e) the widest head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["forward", "backward"])
def test_prepass_plain_versions_refuse_a_head_past_256(which):
    """d_head 257 is past the kernels' widest padding (DP 256): both plain
    pre-passes and padded_d raise, where a narrower width would crop d."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 2, 257))
    with pytest.raises(ValueError, match="d_head"):
        if which == "forward":
            ref.flash_quant_fwd_ref(k, v)
        else:
            ref.flash_quant_bwd_ref(q, k, v, q)
    with pytest.raises(ValueError, match="d_head"):
        fa.padded_d(257)
    assert [fa.padded_d(d) for d in (1, 64, 65, 128, 129, 256)] == [64, 64, 128, 128, 256, 256]
