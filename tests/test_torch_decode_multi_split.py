"""B9's split-KV over a cluster and its plan: the plain split-merge version
against the plain version and the reference's Pallas kernel, the plan on
the CPU, and the kernel on the card.

``kernels/ref.py::decode_attention_multi_split_ref`` walks B9's work as
the kernel deals it: the T queries in tiles of ``tq``, a tile's live
pages dealt to ``splits`` blocks (page j to block j mod splits), one
online-softmax state a block over its pages, the blocks merged in rank
order.  Here it is held, on the same numpy inputs, against
``decode_attention_multi_ref`` and the reference's ``flash_decode_multi``
in interpret mode (as tests/test_torch_decode_multi.py runs it) at the
reference's tiers: float32 atol 2e-5, bfloat16 atol 2e-2.  The cases cover
the engine's chunk with the plan's own tq and splits, the speculative-verify
shape, window, softcap, MQA and MHA, int8 pools with their scales, rows at
q_pos -1 (exact zeros), splits that get no page, and d_head 128 and 256.
``decode_multi_plan`` (the kernel's ``multi_plan``, mirrored) is held to
its limits on cards of 132 and 114 SMs.  On a card, the kernel is held against its plain version on
chip_smoke.py's B9 cases and its plan against the kernel's own.
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
    """The reference's flash_decode_multi, imported only by the tests that
    compare with it (the machine with the card runs the GPU tests without
    JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import flash_decode_multi

    return types.SimpleNamespace(jnp=jnp, flash_decode_multi=flash_decode_multi,
                                 dt={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, T, K, G, d, P, C, hist, *, dead=(), int8=False, seed=0):
    """Slot b with hist[b] tokens of history and a T-token chunk after them,
    written through a permuted page table; stale random values elsewhere;
    ``dead`` (b, t) rows at q_pos -1 (their entries not written).  Int8
    pools come with (N, K) scales."""
    rng = np.random.default_rng(seed)
    N = B * C + 2
    q = rng.standard_normal((B, T, K * G, d)).astype(np.float32)
    if int8:
        kp, vp = (rng.integers(-127, 128, (N, P, K, d)).astype(np.int8) for _ in range(2))
        scales = [rng.uniform(0.005, 0.05, (N, K)).astype(np.float32) for _ in range(2)]
    else:
        kp, vp = (rng.standard_normal((N, P, K, d)).astype(np.float32) for _ in range(2))
        scales = None
    tab = rng.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    q_pos = np.stack([np.arange(h, h + T) for h in hist]).astype(np.int32)
    for b, t in dead:
        q_pos[b, t] = -1
    pos = np.full((N, P), -1, np.int32)
    for b, h in enumerate(hist):
        for t in [*range(h), *q_pos[b][q_pos[b] >= 0]]:
            pos[tab[b, t // P], t % P] = t
    return (q, kp, vp, pos, tab, q_pos), scales


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


# (id, (B, T, K, G, d, P, C, hist), dead, window, softcap, dtype, int8, tq, splits);
# tq / splits None: the plan's own
SPLIT_CASES = [
    ("the engine's chunk, the plan's tiles and splits", (1, 64, 3, 3, 64, 16, 20, [192]),
     (), 0, 0.0, "float32", False, None, None),
    ("the verify shape B = 4, T = 5", (4, 5, 3, 3, 64, 16, 20, [70, 0, 250, 33]),
     tuple((1, t) for t in range(5)), 0, 0.0, "float32", False, None, None),
    ("window", (2, 12, 2, 2, 16, 4, 12, [20, 3]), (), 7, 0.0, "float32", False, 5, 3),
    ("softcap", (2, 12, 2, 2, 16, 4, 12, [20, 3]), (), 0, 5.0, "float32", False, 4, 8),
    ("MQA", (2, 9, 1, 9, 16, 4, 12, [20, 3]), ((0, 0),), 0, 0.0, "float32", False, 7, 4),
    ("MHA", (2, 9, 4, 1, 16, 4, 12, [20, 3]), ((1, 8),), 0, 0.0, "float32", False, 9, 2),
    ("int8 pools with scales", (2, 12, 2, 2, 16, 4, 12, [20, 3]), ((1, 0),), 0, 0.0,
     "float32", True, 5, 8),
    ("int8 pools, window + softcap, bf16 q", (2, 9, 1, 4, 16, 4, 12, [20, 3]), (), 6, 5.0,
     "bfloat16", True, 4, 3),
    ("rows at -1, a tile of them all", (2, 8, 2, 2, 16, 4, 6, [9, 0]),
     ((0, 7), *((1, t) for t in range(4))), 0, 0.0, "float32", False, 4, 2),
    # one live page over 8 blocks: 7 splits without a page weigh 0
    ("splits without a page", (2, 3, 2, 2, 16, 4, 12, [0, 1]), (), 0, 0.0, "float32",
     False, 3, 8),
    ("bf16", (2, 12, 2, 2, 16, 4, 12, [20, 3]), (), 0, 0.0, "bfloat16", False, 5, 4),
    ("d_head 128", (2, 6, 2, 2, 128, 4, 6, [9, 3]), (), 0, 0.0, "float32", False, 3, 4),
    ("d_head 256, gemma2-2b's 8/4 heads", (2, 6, 4, 2, 256, 4, 6, [9, 3]), ((0, 5),), 0, 0.0,
     "float32", False, None, None),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_multi_split_ref_matches_plain_and_reference(jx, case):
    _, shape, dead, window, softcap, dtype, int8, tq, splits = case
    B, T, K, G, d, P, C, hist = shape
    arrays, scales = _case(B, T, K, G, d, P, C, hist, dead=dead, int8=int8)
    targs, tkw = _torch(arrays, scales, dtype)
    plan = da.decode_multi_plan(B, K, T, G, d, P, C, targs[1].element_size())
    tq, splits = tq or plan.tq, splits or plan.splits
    kw = dict(scale=0.3, window=window, softcap=softcap)
    got = ref.decode_attention_multi_split_ref(*targs, tq=tq, splits=splits, **kw, **tkw)
    plain = ref.decode_attention_multi_ref(*targs, **kw, **tkw)
    jargs, jkw = _jax(jx, arrays, scales, dtype)
    want = jx.flash_decode_multi(*jargs, **kw, **jkw, interpret=True)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    atol = ATOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=atol, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)
    zero = targs[5] < 0
    assert torch.count_nonzero(got[zero]) == 0                 # exact zeros
    assert torch.count_nonzero(got[~zero]) > 0


def test_multi_split_ref_at_the_scaling_shapes():
    """A chunk of 256 over a 2048-token history and 32 slots at T = 5
    (smollm-135m's 9/3 heads of 64, pages of 16), each with the plan's own
    tiles and splits (a ring of two slots for the first), against the
    plain version at the f32 tier."""
    for B, T, C, hist in ((1, 256, 128, [1792]),
                          (32, 5, 20, [120 + (190 * i) // 31 for i in range(32)])):
        arrays, _ = _case(B, T, 3, 3, 64, 16, C, hist, seed=3)
        targs, _ = _torch(arrays, None, "float32")
        plan = da.decode_multi_plan(B, 3, T, 3, 64, 16, C)
        got = ref.decode_attention_multi_split_ref(*targs, tq=plan.tq, splits=plan.splits,
                                                   scale=0.125)
        want = ref.decode_attention_multi_ref(*targs, scale=0.125)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


FLOAT64_CASES = {
    "d_head 256, 8/4 heads": (dict(B=2, T=6, K=4, G=2, d=256, P=4, C=6, hist=[9, 3],
                                   dead=((1, 0),)), "float32", dict(scale=0.125)),
    "int8 pools": (dict(B=2, T=9, K=2, G=2, d=16, P=4, C=12, hist=[20, 3], int8=True),
                   "float32", dict(scale=0.3, window=7)),
    "bf16, window, softcap": (dict(B=2, T=9, K=2, G=2, d=16, P=4, C=12, hist=[20, 3]),
                              "bfloat16", dict(scale=0.3, window=7, softcap=5.0)),
}


@pytest.mark.parametrize("case", list(FLOAT64_CASES))
def test_multi_ref_in_float64_is_the_same_function(jx, case):
    """The plain version with float64 sums (the card's B9 checks hold the
    kernel to it where the f32 plain version is shown to be at fault)
    against the f32 one and the reference's kernel, at the tiers."""
    shape, dtype, kw = FLOAT64_CASES[case]
    shape = dict(shape)
    args = [shape.pop(k) for k in ("B", "T", "K", "G", "d", "P", "C", "hist")]
    arrays, scales = _case(*args, **shape)
    targs, tkw = _torch(arrays, scales, dtype)
    got = ref.decode_attention_multi_ref(*targs, acc_dtype=torch.float64, **kw, **tkw)
    plain = ref.decode_attention_multi_ref(*targs, **kw, **tkw)
    jargs, jkw = _jax(jx, arrays, scales, dtype)
    want = jx.flash_decode_multi(*jargs, **kw, **jkw, interpret=True)
    assert got.dtype == targs[0].dtype
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)
    assert torch.count_nonzero(got[targs[5] < 0]) == 0


@pytest.mark.parametrize("B,K,T,G,d,P,C", [
    (1, 3, 64, 3, 64, 16, 20),      # the engine's chunk
    (1, 3, 256, 3, 64, 16, 128),    # a chunk of 256 over 2048 tokens
    (32, 3, 5, 3, 64, 16, 20),      # 32 slots at the verify T = 5
    (4, 4, 24, 2, 256, 16, 20),     # gemma2-2b's 8/4 heads of 256
    (2, 1, 9, 9, 64, 16, 20),       # MQA, G = 9
    (2, 9, 9, 1, 64, 16, 20),       # MHA
    (1, 1, 1, 64, 64, 16, 1),       # G = 64: one query fills the rows
    (3, 2, 7, 2, 20, 8, 9),         # d_head 20
    (1, 1, 4, 1, 256, 16, 128),     # a ring of two slots
    (8, 65535, 1, 1, 8, 4, 2),      # the grid's y at its limit
])
def test_decode_multi_plan(B, K, T, G, d, P, C):
    for kv_bytes, sms in ((4, 132), (2, 132), (1, 132), (4, 114)):   # H100 SXM, PCIe
        plan = da.decode_multi_plan(B, K, T, G, d, P, C, kv_bytes, sms)
        assert 1 <= plan.splits <= da.MAX_SPLITS
        assert 1 <= plan.tq * G <= da.MULTI_MAX_ROWS
        assert plan.tiles == -(-T // plan.tq) and plan.tq <= T
        assert K <= da.MAX_GRID_Y                          # the grid's y: kv heads
        assert plan.smem <= da.MAX_DYN_SMEM
        assert plan.slots in (1, 2) and plan.stage_pages >= 1
        if plan.slots == 1:                                # every page a block may own
            assert plan.stage_pages == -(-C // plan.splits)
        assert plan.smem == da.multi_smem_bytes(plan.tq * G, plan.splits, plan.stage_pages,
                                                plan.slots, d, P, C, kv_bytes,
                                                64 * plan.cv)


def test_decode_multi_plan_at_the_chunk_shape():
    """The engine's chunk gets 48 rows a block (3 before), 8 splits."""
    plan = da.decode_multi_plan(1, 3, 64, 3, 64, 16, 20)
    assert (plan.tq, plan.tiles, plan.splits, plan.slots) == (16, 4, 8, 1)
    assert plan.tq * 3 > 3


@pytest.mark.parametrize("G,d,P,match", [
    (65, 64, 16, "65 rows"),          # more query heads a kv head than a block's rows
    (1, 8192, 16, "bytes"),           # one page of a ring slot does not fit
    (4, 64, 4096, "bytes"),
])
def test_decode_multi_plan_refuses_what_it_cannot_place(G, d, P, match):
    with pytest.raises(ValueError, match=match) as e:
        da.decode_multi_plan(1, 1, 4, G, d, P, 4)
    assert "bytes of shared memory" in str(e.value)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("pools", ["f32 and bf16", "int8"])
def test_multi_kernel_matches_plain_on_chip_smoke_cases(pools):
    """B9 against its plain version on every case of chip_smoke.py's B9
    phases (atol 2e-5, 2e-2 where bf16 enters; rows at -1 exactly zero),
    one launch a call, and its plan equal to the kernel's own."""
    _need_card()
    cs = _chip_smoke()
    if pools == "int8":
        n0, check, cases = da.multi_int8_launches, cs.check_int8_multi_cases, \
            cs.INT8_MULTI_CASES
    else:
        n0, check, cases = da.multi_launches, cs.check_multi_cases, cs.MULTI_CASES
    check(ops, da)
    n1 = da.multi_int8_launches if pools == "int8" else da.multi_launches
    assert n1 - n0 == len(cases) + 1                       # and T = 1 against B8


@pytest.mark.gpu
def test_multi_kernel_refuses_what_the_plan_cannot_place():
    """The wrapper raises the plan's ValueError, with the bytes it would
    need, and launches nothing."""
    _need_card()
    q = torch.zeros(1, 2, 1, 8192, device="cuda")
    kp = torch.zeros(2, 16, 1, 8192, device="cuda")
    pos = torch.zeros(2, 16, dtype=torch.int32, device="cuda")
    tab = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    qp = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    n0 = da.multi_launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        da.flash_decode_multi(q, kp, kp, pos, tab, qp)
    assert da.multi_launches == n0
