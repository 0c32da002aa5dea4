"""B9, the paged multi-query flash decode (chunked prefill, prefix-cache
suffixes, speculative verify): the port's plain version against the
reference, its dispatch, and (on a card only) the CUDA kernel against the
plain version.

On the CPU ``ops.decode_attention_multi`` runs ``ref.decode_attention_multi_ref``;
it is held against the reference's Pallas kernel body in interpret mode
(``flash_decode_multi(..., interpret=True)``) and its jnp oracle
(``decode_attention_multi_ref``) on the same numpy inputs, at the
reference's tolerances (docs/kernels.md): float32 atol 2e-5, bfloat16 2e-2.
The cases cover GQA / MQA / MHA x window x softcap, histories that end
mid-page, a permuted page table with stale bytes in unwritten entries, two
slots whose tables map the same physical pages, rows at q_pos = -1 (exact
zeros), and T = 1 against the single-query oracle.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference's kernels, imported only by the tests that compare with
    them (the machine with the card runs the GPU tests without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import flash_decode_multi

    return types.SimpleNamespace(
        jnp=jnp, ref=jref, flash_decode_multi=flash_decode_multi,
        dt={"float32": jnp.float32, "bfloat16": jnp.bfloat16},
    )


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def multi_case(K, G, T=5, d=16, P=4, C=6, hist=(9, 0, 13), dead=((1, 0), (2, 4)),
               share=True, seed=0):
    """Slots with ``hist`` tokens of history and a T-token chunk written after
    them (positions hist .. hist + T - 1), in a pool whose pages are permuted
    across slots; unwritten entries hold stale random bytes at pos -1.
    ``dead`` rows get q_pos = -1 (their chunk entries are not written);
    with ``share`` slot 1's first two table entries map slot 0's pages (a
    prefix shared through the cache, so slot 1's history is slot 0's)."""
    rng = np.random.default_rng(seed)
    B, H = len(hist), K * G
    N = B * C + 2
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    kp = rng.standard_normal((N, P, K, d)).astype(np.float32)
    vp = rng.standard_normal((N, P, K, d)).astype(np.float32)
    tab = rng.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    hist = list(hist)
    if share:
        tab[1, :2] = tab[0, :2]
        hist[1] = max(hist[1], 2 * P)       # slot 1 owns the shared pages' span
        hist[0] = max(hist[0], 2 * P)
    q_pos = np.stack([np.arange(h, h + T) for h in hist]).astype(np.int32)
    for b, t in dead:
        q_pos[b, t] = -1
    pos = np.full((N, P), -1, np.int32)
    for b in range(B):
        for t in range(hist[b]):
            if not (share and b == 1 and t < 2 * P):   # written by slot 0
                pos[tab[b, t // P], t % P] = t
        for t in q_pos[b][q_pos[b] >= 0]:
            pos[tab[b, t // P], t % P] = t
    return q, kp, vp, pos, tab, q_pos


def _both(jx, a, dtype):
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.copy()), jx.jnp.asarray(a)
    return (torch.from_numpy(a.copy()).to(TORCH_DT[dtype]),
            jx.jnp.asarray(a, jx.dt[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


MULTI_CASES = [
    # (K, G, window, softcap, dtype)
    (1, 4, 0, 0.0, "float32"),     # MQA
    (2, 2, 0, 0.0, "float32"),     # GQA
    (4, 1, 0, 0.0, "float32"),     # MHA
    (2, 2, 7, 0.0, "float32"),
    (1, 4, 0, 30.0, "float32"),
    (4, 1, 9, 5.0, "float32"),
    (3, 3, 0, 0.0, "bfloat16"),    # smollm's grouping
    (1, 4, 6, 30.0, "bfloat16"),
]


@pytest.mark.parametrize("K,G,window,softcap,dtype", MULTI_CASES)
def test_multi_plain_matches_reference_kernel(jx, K, G, window, softcap, dtype):
    arrays = multi_case(K, G)
    q, kp, vp = (_both(jx, a, dtype) for a in arrays[:3])
    pos, tab, q_pos = (_both(jx, a, dtype) for a in arrays[3:])
    kw = dict(scale=0.3, window=window, softcap=softcap)
    got = ops.decode_attention_multi(q[0], kp[0], vp[0], pos[0], tab[0],
                                     q_pos[0], **kw)
    want_kernel = jx.flash_decode_multi(q[1], kp[1], vp[1], pos[1], tab[1],
                                        q_pos[1], interpret=True, **kw)
    want_ref = jx.ref.decode_attention_multi_ref(q[1], kp[1], vp[1], pos[1],
                                                 tab[1], q_pos[1], **kw)
    assert got.dtype == q[0].dtype and got.shape == q[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=ATOL[dtype])
    for b, t in ((1, 0), (2, 4)):                 # q_pos = -1: exact zeros
        assert torch.count_nonzero(got[b, t]) == 0


@pytest.mark.parametrize("window", [0, 5])
def test_multi_plain_single_row_is_the_single_query_oracle(window):
    """T = 1 through the multi-query oracle equals the single-query one."""
    q, kp, vp, pos, tab, q_pos = (torch.from_numpy(a) for a in
                                  multi_case(2, 2, T=1, dead=((2, 0),)))
    got = ref.decode_attention_multi_ref(q, kp, vp, pos, tab, q_pos, scale=0.3,
                                         window=window)
    want = ref.decode_attention_ref(q[:, 0], kp, vp, pos, tab, q_pos[:, 0],
                                    scale=0.3, window=window)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), atol=2e-5)
    assert torch.count_nonzero(got[2]) == 0


def test_multi_row_sees_only_its_own_prefix():
    """Causality within the chunk comes from the stored positions: row t of
    the chunk equals a T = 1 query at its position over the same pages with
    the later chunk entries erased."""
    q, kp, vp, pos, tab, q_pos = (torch.from_numpy(a) for a in
                                  multi_case(2, 2, dead=(), share=False))
    got = ref.decode_attention_multi_ref(q, kp, vp, pos, tab, q_pos, scale=0.3)
    for t in range(q.shape[1]):
        later = pos.clone()
        later[later > q_pos[0, t]] = -1
        want = ref.decode_attention_ref(q[:1, t], kp, vp, later, tab[:1],
                                        q_pos[:1, t], scale=0.3)
        np.testing.assert_allclose(got[0, t].numpy(), want[0].numpy(), atol=2e-5)


# ---------------------------------------------------------------------------
# dispatch contract
# ---------------------------------------------------------------------------

def test_multi_kernel_impl_on_cpu_raises_and_counts_nothing():
    args = [torch.from_numpy(a) for a in multi_case(2, 2)]
    da.multi_launches = 0
    ops.decode_attention_multi(*args, scale=0.3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention_multi(*args, scale=0.3, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        da.flash_decode_multi(*args)
    assert da.multi_launches == 0
    assert ops.launch_counts()["flash_decode_multi"] == 0


def test_multi_auto_on_cpu_is_the_plain_version():
    args = [torch.from_numpy(a) for a in multi_case(3, 3)]
    torch.testing.assert_close(
        ops.decode_attention_multi(*args, scale=0.3),
        ref.decode_attention_multi_ref(*args, scale=0.3), rtol=0, atol=0,
    )


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("K,G,window,softcap,dtype", MULTI_CASES)
def test_multi_kernel_matches_plain_on_card(K, G, window, softcap, dtype):
    _need_card()
    t = [torch.from_numpy(a).cuda() for a in multi_case(K, G)]
    t[:3] = [a.to(TORCH_DT[dtype]) for a in t[:3]]
    kw = dict(scale=0.3, window=window, softcap=softcap)
    n0 = da.multi_launches
    got = ops.decode_attention_multi(*t, impl="kernel", **kw)
    assert da.multi_launches == n0 + 1
    want = ops.decode_attention_multi(*t, impl="ref", **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype])
    for b, tt in ((1, 0), (2, 4)):
        assert torch.count_nonzero(got[b, tt]) == 0


@pytest.mark.gpu
def test_multi_kernel_cases_of_the_chip_smoke():
    """chip_smoke.py's B9 cases (engine chunk, ragged tiles, verify, MHA,
    MQA, window, softcap, bf16, shared pages, T = 1 against B8)."""
    _need_card()
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.check_multi_cases(ops, da)
