"""The port's kernels: plain versions against the reference, dispatch rules,
and (on a card only) the CUDA kernels against their plain versions.

On the CPU the port's ops run their plain PyTorch versions
(kernels/ref.py); they are held against the reference's Pallas kernel bodies
in interpret mode and against the reference's jnp oracles, on the same numpy
inputs.  Tolerances are the reference's (docs/kernels.md § Tolerance
policy): float32 atol 2e-5, bfloat16 atol 2e-2.

B1 is the fused RMSNorm, B8 the paged flash-decode kernel.  The B8 cases
cover GQA / MQA / MHA x window x softcap, with a half-filled last page, a
permuted page table, stale bytes in unwritten entries and a q_pos = -1 slot.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference's kernels, imported only by the tests that compare with
    them (the machine with the card runs the GPU tests without JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import flash_decode
    from repro.kernels.rmsnorm import rmsnorm

    return types.SimpleNamespace(
        jnp=jnp, ref=jref, flash_decode=flash_decode, rmsnorm=rmsnorm,
        dt={"float32": jnp.float32, "bfloat16": jnp.bfloat16},
    )


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(jx, a, dtype):
    """The same numpy values as a torch tensor and a jax array of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.copy()), jx.jnp.asarray(a)
    return (torch.from_numpy(a.copy()).to(TORCH_DT[dtype]),
            jx.jnp.asarray(a, jx.dt[dtype]))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# B1 rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 48), (8, 576), (3, 7, 40)])
def test_rmsnorm_plain_matches_reference_kernel(jx, shape, dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    g = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    tx, jxx = _both(jx, x, dtype)
    tg, jg = torch.from_numpy(g), jx.jnp.asarray(g)
    got = ops.fused_rmsnorm(tx, tg, eps=1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want_kernel = jx.rmsnorm(jxx, jg, eps=1e-6, block_rows=8, interpret=True)
    want_ref = jx.ref.rmsnorm_ref(jxx, jg, 1e-6)
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=ATOL[dtype])


# ---------------------------------------------------------------------------
# B8 flash decode
# ---------------------------------------------------------------------------

def _paged_case(K, G, d=8, P=4, C=5, lens=(13, 20, 0), seed=0):
    """Slots with histories of ``lens`` tokens (13: half-filled last page;
    0: inactive slot, q_pos = -1) in a pool whose pages are permuted across
    slots.  Unwritten entries hold stale random bytes at pos -1."""
    rng = np.random.default_rng(seed)
    B, H = len(lens), K * G
    N = B * C + 2
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp = rng.standard_normal((N, P, K, d)).astype(np.float32)
    vp = rng.standard_normal((N, P, K, d)).astype(np.float32)
    tab = rng.permutation(N)[:B * C].reshape(B, C).astype(np.int32)
    pos = np.full((N, P), -1, np.int32)
    for b, T in enumerate(lens):
        for t in range(T):
            pos[tab[b, t // P], t % P] = t
    q_pos = np.array([T - 1 for T in lens], np.int32)   # 0 tokens -> -1
    return q, kp, vp, pos, tab, q_pos


DECODE_CASES = [
    # (K, G, window, softcap, dtype)
    (1, 4, 0, 0.0, "float32"),     # MQA
    (2, 2, 0, 0.0, "float32"),     # GQA
    (4, 1, 0, 0.0, "float32"),     # MHA
    (2, 2, 6, 0.0, "float32"),
    (1, 4, 0, 30.0, "float32"),
    (4, 1, 9, 5.0, "float32"),
    (3, 3, 0, 0.0, "bfloat16"),    # smollm's grouping
    (1, 4, 6, 30.0, "bfloat16"),
]


@pytest.mark.parametrize("K,G,window,softcap,dtype", DECODE_CASES)
def test_decode_plain_matches_reference_kernel(jx, K, G, window, softcap, dtype):
    arrays = _paged_case(K, G)
    q, kp, vp = (_both(jx, a, dtype) for a in arrays[:3])
    pos, tab, q_pos = (_both(jx, a, dtype) for a in arrays[3:])
    got = ops.decode_attention(
        q[0], kp[0], vp[0], pos[0], tab[0], q_pos[0], scale=0.3,
        window=window, softcap=softcap,
    )
    want_kernel = jx.flash_decode(
        q[1], kp[1], vp[1], pos[1], tab[1], q_pos[1], scale=0.3,
        window=window, softcap=softcap, interpret=True,
    )
    want_ref = jx.ref.decode_attention_ref(
        q[1], kp[1], vp[1], pos[1], tab[1], q_pos[1], scale=0.3,
        window=window, softcap=softcap,
    )
    assert got.dtype == q[0].dtype and got.shape == q[0].shape
    np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=ATOL[dtype])
    assert torch.count_nonzero(got[2]) == 0      # q_pos = -1: exact zeros


# ---------------------------------------------------------------------------
# dispatch contract
# ---------------------------------------------------------------------------

def _small_inputs():
    q, kp, vp, pos, tab, q_pos = (torch.from_numpy(a) for a in _paged_case(2, 2))
    x = torch.randn(4, 48)
    g = torch.zeros(48)
    return (q, kp, vp, pos, tab, q_pos), (x, g)


def test_kernel_impl_on_cpu_raises_and_counts_nothing():
    dec, (x, g) = _small_inputs()
    rn.launches = da.launches = 0
    ops.fused_rmsnorm(x, g)
    ops.fused_rmsnorm(x, g, impl="ref")
    ops.decode_attention(*dec, scale=0.3)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_rmsnorm(x, g, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(*dec, scale=0.3, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, g)
    with pytest.raises(ValueError, match="CUDA"):
        da.flash_decode(*dec)
    with pytest.raises(ValueError, match="impl"):
        ops.fused_rmsnorm(x, g, impl="pallas")
    assert rn.launches == 0 and da.launches == 0


def test_auto_on_cpu_is_the_plain_version():
    dec, (x, g) = _small_inputs()
    torch.testing.assert_close(ops.fused_rmsnorm(x, g), ref.rmsnorm_ref(x, g),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        ops.decode_attention(*dec, scale=0.3),
        ref.decode_attention_ref(*dec, scale=0.3), rtol=0, atol=0,
    )


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain_on_card(dtype):
    _need_card()
    x = torch.randn(37, 576, device="cuda").to(TORCH_DT[dtype])
    g = 0.5 * torch.randn(576, device="cuda")
    n0 = rn.launches
    got = ops.fused_rmsnorm(x, g, impl="kernel")
    assert rn.launches == n0 + 1
    want = ops.fused_rmsnorm(x, g, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("K,G,window,softcap,dtype", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(K, G, window, softcap, dtype):
    _need_card()
    arrays = _paged_case(K, G)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    t[:3] = [a.to(TORCH_DT[dtype]) for a in t[:3]]
    n0 = da.launches
    got = ops.decode_attention(*t, scale=0.3, window=window, softcap=softcap,
                               impl="kernel")
    assert da.launches == n0 + 1
    want = ops.decode_attention(*t, scale=0.3, window=window, softcap=softcap,
                                impl="ref")
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATOL[dtype])
    assert torch.count_nonzero(got[2]) == 0
