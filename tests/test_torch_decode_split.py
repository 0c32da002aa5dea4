"""B8's split-KV: the plain split-merge version against the plain version
and the reference's Pallas kernel, and the kernel on the card.

``kernels/ref.py::decode_attention_split_ref`` walks B8's page assignment
(page j to cluster warp j mod splits x warps), keeps one online-softmax
state per warp and merges the warps of each block, then the blocks, in
the kernel's order.  Here it is held, on the same numpy inputs, against
``decode_attention_ref`` and the reference's ``flash_decode`` in interpret
mode (as tests/test_torch_kernels.py runs it) at the reference's tiers:
float32 atol 2e-5, bfloat16 atol 2e-2.  The cases cover every split count
1-8, warps that walk several pages, splits that get no page, an inactive
slot and a slot whose entries are all masked (exact zeros), a window that
masks whole splits, softcap, int8 pools with their scales, and bf16.  On a
card, the kernel is held against its plain version on chip_smoke.py's B8
cases (``check_decode_cases``, ``check_int8_decode_cases``).
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference's flash_decode, imported only by the tests that compare
    with it (the machine with the card runs the GPU test without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import flash_decode

    return types.SimpleNamespace(jax=jax, jnp=jnp, flash_decode=flash_decode,
                                 dt={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


def _case(K, G, lens, *, d=8, P=4, seed=0, int8=False, q_pos=None):
    """Slots with histories of ``lens`` tokens (0: inactive, q_pos -1) in a
    pool whose pages are permuted across slots, stale random values in
    unwritten entries.  ``q_pos`` overrides the query positions (a slot at
    q_pos >= 0 over pages that hold nothing sees only masked entries).
    Int8 pools come with (N, K) scales."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), K * G
    C = max(1, max(-(-L // P) for L in lens), *(-(-(p + 1) // P) for p in q_pos or ()))
    N = B * C + 2
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, (N, P, K, d)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(0.005, 0.05, (N, K)).astype(np.float32) for _ in range(2)]
    else:
        kp, vp = (rng.standard_normal((N, P, K, d)).astype(np.float32) for _ in range(2))
        scales = None
    tab = rng.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    pos = np.full((N, P), -1, np.int32)
    for b, T in enumerate(lens):
        for t in range(T):
            pos[tab[b, t // P], t % P] = t
    qp = np.array(q_pos if q_pos is not None else [T - 1 for T in lens], np.int32)
    return (q, kp, vp, pos, tab, qp), scales


def _torch(arrays, scales, dtype):
    q, kp, vp, pos, tab, qp = (torch.from_numpy(a.copy()) for a in arrays)
    q = q.to(TORCH_DT[dtype])
    if scales is None:
        kp, vp = kp.to(TORCH_DT[dtype]), vp.to(TORCH_DT[dtype])
        kw = {}
    else:
        kw = dict(k_scale=torch.from_numpy(scales[0]), v_scale=torch.from_numpy(scales[1]))
    return (q, kp, vp, pos, tab, qp), kw


def _jax(jx, arrays, scales, dtype):
    q, kp, vp, pos, tab, qp = arrays
    dt = jx.dt[dtype]
    args = [jx.jnp.asarray(q, dt)]
    if scales is None:
        args += [jx.jnp.asarray(kp, dt), jx.jnp.asarray(vp, dt)]
        kw = {}
    else:
        args += [jx.jnp.asarray(kp), jx.jnp.asarray(vp)]
        kw = dict(k_scale=jx.jnp.asarray(scales[0]), v_scale=jx.jnp.asarray(scales[1]))
    args += [jx.jnp.asarray(a) for a in (pos, tab, qp)]
    return args, kw


# (id, K, G, lens, window, softcap, dtype, int8, splits, warps, q_pos)
SPLIT_CASES = [
    *[(f"splits {s}", 2, 2, (45, 13, 0, 30), 0, 0.0, "float32", False, s, 4, None)
      for s in range(1, 9)],
    # 12 pages over 2 warps: each warp walks 6 pages in turn
    ("warps walk several pages", 2, 2, (45, 13, 0, 30), 0, 0.0, "float32", False, 2, 1, None),
    # 2 live pages over 8 x 4 warps: 30 warps and 6 splits get nothing
    ("a slot shorter than the cluster's warps", 1, 3, (5, 8), 0, 0.0, "float32", False,
     8, 4, None),
    ("inactive slots", 2, 2, (0, 0, 20), 0, 0.0, "float32", False, 8, 4, None),
    # slot 0 at q_pos 9 over pages that hold nothing: every entry masked
    ("a fully masked slot", 2, 2, (0, 20), 0, 0.0, "float32", False, 8, 4, [9, 19]),
    # a window of 5 over 45 tokens masks every page but the last two
    ("window masks whole splits", 2, 2, (45, 30), 5, 0.0, "float32", False, 8, 4, None),
    ("softcap", 2, 2, (45, 13, 0, 30), 0, 5.0, "float32", False, 3, 4, None),
    ("int8 pools with scales", 2, 2, (45, 13, 0, 30), 0, 0.0, "float32", True, 8, 4, None),
    ("int8 pools, window + softcap", 1, 4, (45, 30), 9, 5.0, "float32", True, 5, 1, None),
    ("bf16", 2, 2, (45, 13, 0, 30), 0, 0.0, "bfloat16", False, 8, 4, None),
    ("bf16 q over int8 pools", 4, 1, (45, 13), 6, 0.0, "bfloat16", True, 4, 2, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_ref_matches_plain_and_reference(jx, case):
    _, K, G, lens, window, softcap, dtype, int8, splits, warps, q_pos = case
    arrays, scales = _case(K, G, lens, int8=int8, q_pos=q_pos)
    targs, tkw = _torch(arrays, scales, dtype)
    kw = dict(scale=0.3, window=window, softcap=softcap)
    got = ref.decode_attention_split_ref(*targs, splits=splits, warps=warps, **kw, **tkw)
    plain = ref.decode_attention_ref(*targs, **kw, **tkw)
    jargs, jkw = _jax(jx, arrays, scales, dtype)
    want = jx.flash_decode(*jargs, **kw, **jkw, interpret=True)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    atol = ATOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=atol, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)
    zero = targs[5] < 0
    if q_pos is not None:
        zero |= torch.tensor([L == 0 for L in lens])
    assert torch.count_nonzero(got[zero]) == 0          # exact zeros
    assert torch.count_nonzero(got[~zero]) > 0


def test_split_ref_at_the_serve_decode_shape():
    """At the serve's decode shape (smollm-135m's 9/3 heads of 64, pages of
    16, lens 120-310), with the kernel's own split count and warps, f32
    pools and int8 pools."""
    arrays, _ = _case(3, 3, (120, 200, 260, 310), d=64, P=16, seed=5)
    targs, _ = _torch(arrays, None, "float32")
    S = da.decode_splits(4, 3, targs[4].shape[1])
    assert S == 8
    kw = dict(scale=0.125)
    got = ref.decode_attention_split_ref(*targs, splits=S, warps=da.DECODE_WARPS, **kw)
    torch.testing.assert_close(got, ref.decode_attention_ref(*targs, **kw), atol=2e-5, rtol=0)
    arrays, scales = _case(3, 3, (120, 200, 260, 310), d=64, P=16, seed=6, int8=True)
    targs, tkw = _torch(arrays, scales, "float32")
    got = ref.decode_attention_split_ref(*targs, splits=S, warps=da.DECODE_WARPS, **kw, **tkw)
    torch.testing.assert_close(got, ref.decode_attention_ref(*targs, **kw, **tkw),
                               atol=2e-5, rtol=0)


def test_merge_weighs_empty_states_zero():
    """An empty state (m = NEG_INF, l = 0, acc = 0) merged with others adds
    nothing; empty states alone merge to l = 0, acc = 0 (never exp(0) = 1
    times anything)."""
    empty = (torch.full((2,), ref.NEG_INF), torch.zeros(2), torch.zeros(2, 3))
    full = (torch.tensor([1.5, -2.0]), torch.tensor([2.0, 3.0]), torch.ones(2, 3))
    m, l, acc = ref._merge_states([empty, full, empty])
    assert torch.equal(m, full[0]) and torch.equal(l, full[1]) and torch.equal(acc, full[2])
    m, l, acc = ref._merge_states([empty, empty])
    assert torch.equal(l, torch.zeros(2)) and torch.equal(acc, torch.zeros(2, 3))


@pytest.mark.parametrize("B,K,C,want", [
    (4, 3, 20, 8),       # the serve's decode shape
    (1, 3, 128, 8),      # one long slot
    (32, 3, 20, 8),      # many slots
    (4, 3, 1, 1),        # one page a slot: one block
    (2, 1, 5, 5),        # fewer pages than the cluster's 8 blocks
    (1, 1, 0, 1),        # an empty table (the wrapper launches nothing)
])
def test_decode_splits(B, K, C, want):
    assert da.decode_splits(B, K, C) == want
    assert 1 <= want <= da.MAX_SPLITS


@pytest.mark.gpu
def test_kernel_refuses_more_kv_heads_than_the_grid_holds():
    """The kernel's one shape limit, the grid's second dimension (kv heads),
    raises a ValueError that names it, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    K = da.MAX_GRID_Y + 1
    q = torch.zeros(1, K, 1, device="cuda")
    kp = torch.zeros(1, 1, K, 1, device="cuda")
    pos = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    n0 = da.launches
    with pytest.raises(ValueError, match="65535"):
        da.flash_decode(q, kp, kp, pos, pos, pos[0])
    assert da.launches == n0


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["f32 and bf16", "int8"])
def test_decode_kernel_matches_plain_on_chip_smoke_cases(pools):
    """B8 against its plain version on every case of chip_smoke.py's decode
    phases (its check: atol 2e-5, 2e-2 where bf16 enters; inactive and
    fully masked slots exactly zero), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    cs = _chip_smoke()
    if pools == "int8":
        n0, check, cases = da.int8_launches, cs.check_int8_decode_cases, cs.INT8_DECODE_CASES
    else:
        n0, check, cases = da.launches, cs.check_decode_cases, cs.DECODE_CASES
    check(ops)
    n1 = da.int8_launches if pools == "int8" else da.launches
    assert n1 - n0 == len(cases)
