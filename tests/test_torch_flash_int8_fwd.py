"""The int8 forward of flash attention as the tensor-core kernel runs it: a
pre-pass that quantizes k and v once, then B5 on the s8 tensor cores.
Held here on the CPU through its plain versions, against the reference on
the same numpy inputs, and on the card against them.

- The pre-pass's plain version (``ref.flash_quant_fwd_ref``) gives the
  bytes and scales of the reference's ``repro.quant.core.quantize_int8``
  (run through JAX on the CPU): k per row over d (zero-padded to DP = 64 or
  128), v per column over each 128-key tile, stored K-major in the
  fragments' order (``ref.FRAG_PERM``), keys past T zeros.  Exact: equal
  bytes, equal scales.  Its k8 and sk are the backward pre-pass's, byte for
  byte.
- ``ref.flash_fwd_i8_ref``, ``flash_fwd_ref`` restated on those bytes as the
  kernel computes (q quantized per row over d, p quantized per row over
  each key tile and permuted like vT8), gives o and lse bit-equal to
  ``flash_fwd_ref`` in the int8 mode (the int8 products are exact
  integers, so a permutation of the contraction axis changes no sum).
- The int8 plain forward, which sums l in the tensor-core fragments' order
  (``ref._mma_row_sum``), lies within the int8 tier of the reference's
  interpret-mode B5 at 128 x 128 blocks (max abs error 5e-2, mean 3e-5, as
  tests/test_torch_amp_int8.py holds it), and within f32 rounding of the
  forward under the 16-lane order it summed in before (o and lse atol
  1e-6, rtol 1e-6).
- On the card (``gpu`` marker): the pre-pass byte for byte, and B5 against
  its plain version by chip_smoke.py's int8 checks, one pre-pass and one
  B5 launch a call.
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
            for s in ((B, S, H, d), (B, T, K, d), (B, T, K, d))]


# ---------------------------------------------------------------------------
# (a) the forward pre-pass's plain version against the reference's quantize_int8
# ---------------------------------------------------------------------------

# B, T, K, d
PREPASS_CASES = {
    "ragged T 190, d 40 -> DP 64, 3 kv heads (GQA 9/3)": (2, 190, 3, 40),
    "d 96 -> DP 128, T 130": (1, 130, 2, 96),
    "d 64, two whole tiles": (1, 256, 2, 64),
    "d 256 -> DP 256, T 130, gemma2's 4 kv heads": (1, 130, 4, 256),
    "d 200 -> DP 256, T 90": (1, 90, 2, 200),
}


@pytest.mark.parametrize("case", sorted(PREPASS_CASES))
def test_fwd_prepass_plain_matches_reference_quantizer(jx, case):
    """Every output of the forward pre-pass's plain version, shapes and
    dtypes as the kernel's wrapper allocates them, equal to the reference's
    bytes and scales; keys past T and d past the head dim are zeros."""
    B, T, K, d = PREPASS_CASES[case]
    _, k, v = _inputs(B, 1, T, K, K, d)
    got = ref.flash_quant_fwd_ref(torch.from_numpy(k), torch.from_numpy(v))
    shapes = fa.fwd_i8_shapes(B, T, K, d)
    assert set(got) == set(fa.FWD_I8_FIELDS) == set(shapes)
    for name, t in got.items():
        assert (tuple(t.shape), t.dtype) == shapes[name], name
    DP = fa.padded_d(d)
    kp = np.pad(k, ((0, 0), (0, 0), (0, 0), (0, DP - d)))
    k8, sk = jx.quantize(jx.jnp.asarray(kp), axis=-1)
    np.testing.assert_array_equal(got["k8"].numpy(), np.asarray(k8))
    np.testing.assert_array_equal(got["sk"].numpy(), np.asarray(sk)[..., 0].transpose(0, 2, 1))
    n = -(-T // 128)
    vp = np.pad(v, ((0, 0), (0, n * 128 - T), (0, 0), (0, DP - d)))
    v8, sv = jx.quantize(jx.jnp.asarray(vp.reshape(B, n, 128, K, DP)), axis=2)
    v8 = np.asarray(v8).transpose(0, 3, 1, 4, 2)[..., list(ref.TILE_PERM)]
    np.testing.assert_array_equal(got["vT8"].numpy(), v8)
    np.testing.assert_array_equal(got["svc"].numpy(), np.asarray(sv)[:, :, 0].transpose(0, 2, 1, 3))
    inv = np.argsort(ref.TILE_PERM)
    assert not got["vT8"][:, :, -1].numpy()[..., inv][..., 128 - (n * 128 - T):].any() \
        or n * 128 == T
    assert not got["vT8"][:, :, :, d:].numpy().any() and not got["k8"][..., d:].numpy().any()


@pytest.mark.parametrize("case", sorted(PREPASS_CASES))
def test_fwd_prepass_k_is_the_backward_prepass_k(case):
    """The forward pre-pass's k8 and sk equal the backward pre-pass's, byte
    for byte (one quantization of k per row over d, whichever pass makes
    it)."""
    B, T, K, d = PREPASS_CASES[case]
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, T, T, K, K, d))
    fwd = ref.flash_quant_fwd_ref(k, v)
    bwd = ref.flash_quant_bwd_ref(q, k, v, q)
    assert torch.equal(fwd["k8"], bwd["k8"]) and torch.equal(fwd["sk"], bwd["sk"])


# ---------------------------------------------------------------------------
# (b) the forward on the pre-quantized operands
# ---------------------------------------------------------------------------

# B, S, H, K, d, window, softcap, scale
FWD_CASES = {
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
    "S = T = 1": (2, 1, 4, 2, 64, 0, 0.0, 0.125),
    "S 129": (1, 129, 4, 2, 64, 0, 0.0, 0.125),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES) + sorted(RAGGED_CASES))
def test_restated_forward_is_bit_equal_to_flash_fwd_ref(case):
    B, S, H, K, d, window, softcap, scale = {**FWD_CASES, **RAGGED_CASES}[case]
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, S, H, K, d))
    kw = dict(causal=True, window=window, softcap=softcap)
    qs = q * scale
    want = ref.flash_fwd_ref(qs, k, v, policy=INT8, **kw)
    got = ref.flash_fwd_i8_ref(ref.flash_quant_fwd_ref(k, v), qs, **kw)
    for name, g, w in zip(("o", "lse"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (case, name)
        assert torch.equal(g, w), (case, name, float((g - w).abs().max()))


# ---------------------------------------------------------------------------
# (c) the new row-sum order against the reference and the old order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_int8_forward_matches_reference_kernel(jx, case):
    """The int8 plain forward (summing l in the fragments' order), restated
    on the pre-pass's bytes, within the int8 tier of the reference's
    interpret-mode forward at 128 x 128 blocks: o's max abs error within
    5e-2, its mean within 3e-5."""
    B, S, H, K, d, window, softcap, scale = FWD_CASES[case]
    q, k, v = _inputs(B, S, S, H, K, d)
    want = np.asarray(jx.ops.attention(
        *(jx.jnp.asarray(a) for a in (q, k, v)), scale=scale, causal=True, window=window,
        softcap=softcap, block_q=128, block_k=128, impl="interpret", policy=jx.int8))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    o, _ = ref.flash_fwd_i8_ref(ref.flash_quant_fwd_ref(kt, vt), torch.from_numpy(q) * scale,
                                causal=True, window=window, softcap=softcap)
    err = np.abs(o.numpy() - want)
    assert err.max() <= INT8_MAX_ERR and err.mean() <= INT8_MEAN_ERR, \
        (case, float(err.max()), float(err.mean()))


@pytest.mark.parametrize("case", sorted(FWD_CASES) + sorted(RAGGED_CASES))
def test_int8_row_sum_order_changes_only_rounding(case, monkeypatch):
    """The int8 forward under the fragments' row-sum order and under the
    16-lane order it used before agree to f32 rounding: o and lse within
    atol 1e-6 and rtol 1e-6 (a few ulps of entries up to ~2.5 in the softcap
    cases; m and p do not depend on l)."""
    B, S, H, K, d, window, softcap, scale = {**FWD_CASES, **RAGGED_CASES}[case]
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, S, H, K, d, seed=7))
    kw = dict(causal=True, window=window, softcap=softcap, policy=INT8)
    o, lse = ref.flash_fwd_ref(q * scale, k, v, **kw)
    monkeypatch.setattr(ref, "_mma_row_sum", ref._lane_row_sum)
    o2, lse2 = ref.flash_fwd_ref(q * scale, k, v, **kw)
    torch.testing.assert_close(o, o2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lse2, rtol=1e-6, atol=1e-6)


def test_int8_forward_on_cpu_raises_and_counts_nothing():
    """On CPU tensors the forward pre-pass and B5's int8 mode raise (no
    fallback), and nothing is counted; ops.attention takes the plain
    version there."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 1, 16))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fa.quantize_fwd(k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v, policy=INT8)
    ops.attention(q, k, v, scale=0.25, policy=INT8)
    counts = ops.launch_counts()
    assert counts["flash_fwd_quant_int8"] == counts["flash_fwd_int8"] == 0


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
def test_int8_forward_kernels_match_plain_on_card(case):
    """On chip_smoke.py's FLASH_CASES row ``case``: the forward pre-pass's
    bytes and scales equal its plain version's; B5 (one pre-pass and one
    launch a call) passes chip_smoke's int8 checks against flash_fwd_ref
    (lse at the f32 tier, o's max within the int8 tier and mean within
    FLASH_MEAN_TOL), which the plain version tiled 64 wide fails where S >
    64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    cs = _chip_smoke()
    label, B, S, H, K, d, window, cap, scale, dt = cs.FLASH_CASES[case]
    q, k, v, _ = cs.flash_inputs(B, S, H, K, d, dt, case)
    qs = (q.float() * scale).to(dt)
    kw = dict(causal=True, window=window, softcap=cap, policy=INT8)
    got_ops, want_ops = fa.quantize_fwd(k, v), ref.flash_quant_fwd_ref(k, v)
    for name in fa.FWD_I8_FIELDS:
        assert torch.equal(got_ops[name], want_ops[name]), (label, name)
    n0 = ops.launch_counts()
    o, lse = fa.flash_fwd(qs, k, v, **kw)
    n1 = ops.launch_counts()
    assert [n1[n] - n0[n] for n in ("flash_fwd_quant_int8", "flash_fwd_int8")] == [1, 1]
    want = ref.flash_fwd_ref(qs, k, v, **kw)
    torch.testing.assert_close(lse, want[1], atol=2e-5, rtol=1e-5)
    assert cs.rounds_like("o", cs.rounded_err(o, want[0]), cs.INT8_MAX_TOL), label
    if S > 64:
        with cs.int8_tiles(ref, 64):
            wrong = ref.flash_fwd_ref(qs, k, v, **kw)[0]
        assert not cs.rounds_like("o", cs.rounded_err(o, wrong), cs.INT8_MAX_TOL), label
