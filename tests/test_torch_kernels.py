"""The port's kernels: plain versions against the reference, dispatch rules,
and (on a card only) the CUDA kernels against their plain versions.

On the CPU the port's ops run their plain PyTorch versions
(kernels/ref.py); they are held against the reference's Pallas kernel bodies
in interpret mode and against the reference's jnp oracles, on the same numpy
inputs.  Tolerances are the reference's (docs/kernels.md § Tolerance
policy): float32 atol 2e-5, bfloat16 atol 2e-2.

B1 is the fused RMSNorm, B2 its backward, B3/B4 the chunked softmax
cross-entropy forward and backward, B5/B6/B7 flash attention forward, dq
and dk/dv (their plain versions against the reference are in
tests/test_torch_amp.py), B8 the paged flash-decode kernel.  The
B8 cases cover GQA / MQA / MHA x window x softcap, with a half-filled last
page, a permuted page table, stale bytes in unwritten entries and a
q_pos = -1 slot.  Gradients (B2, B4 and the autograd Functions of
``ops.fused_rmsnorm`` / ``ops.softmax_cross_entropy``) are held to the
gradient tiers: float32 atol 2e-4 / rtol 1e-3, bfloat16 atol 5e-2; the
cross-entropy cases include masked (-100) labels and V that no chunk
divides.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cross_entropy as ce  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": dict(atol=2e-4, rtol=1e-3),
            "bfloat16": dict(atol=5e-2, rtol=0)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The reference's kernels, imported only by the tests that compare with
    them (the machine with the card runs the GPU tests without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.cross_entropy import cross_entropy
    from repro.kernels.decode_attention import flash_decode
    from repro.kernels.rmsnorm import rmsnorm

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ref=jref, flash_decode=flash_decode, rmsnorm=rmsnorm,
        cross_entropy=cross_entropy,
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
# B2 rmsnorm backward
# ---------------------------------------------------------------------------

def _rmsnorm_grad_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    g = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, g, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 48), (8, 576), (3, 7, 40), (21, 1024)])
def test_rmsnorm_bwd_plain_matches_reference_vjp(jx, shape, dtype):
    """ref.rmsnorm_bwd_ref and the autograd Function's backward against
    jax.vjp of the reference's Pallas RMSNorm (its custom_vjp backward
    kernel, in interpret mode)."""
    x, g, dy = _rmsnorm_grad_inputs(shape)
    tx, jxx = _both(jx, x, dtype)
    tdy, jdy = _both(jx, dy, dtype)
    tg, jg = torch.from_numpy(g), jx.jnp.asarray(g)
    _, vjp = jx.jax.vjp(
        lambda a, b: jx.rmsnorm(a, b, eps=1e-6, block_rows=8, interpret=True),
        jxx, jg)
    want_dx, want_dg = vjp(jdy)
    dx, dg = ref.rmsnorm_bwd_ref(tx, tg, tdy, 1e-6)
    assert dx.dtype == tx.dtype and dg.dtype == torch.float32
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(_f32(dx), _f32(want_dx), **tol)
    np.testing.assert_allclose(_f32(dg), _f32(want_dg), **GRAD_TOL["float32"])

    lx = tx.clone().requires_grad_(True)
    lg = tg.clone().requires_grad_(True)
    y = ops.fused_rmsnorm(lx, lg, eps=1e-6)
    ax, ag = torch.autograd.grad(y, (lx, lg), tdy)
    assert ag.dtype == lg.dtype
    torch.testing.assert_close(ax, dx, rtol=0, atol=0)
    torch.testing.assert_close(ag, dg, rtol=0, atol=0)


def test_rmsnorm_autograd_matches_autodiff_of_plain_forward():
    """The hand-derived backward equals torch autodiff of the plain forward
    (float32 gradient tier: the two sum in different orders)."""
    x, g, dy = (torch.from_numpy(a) for a in _rmsnorm_grad_inputs((6, 40)))
    lx, lg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    want = torch.autograd.grad(ref.rmsnorm_ref(lx, lg), (lx, lg), dy)
    got = ref.rmsnorm_bwd_ref(x, g, dy)
    torch.testing.assert_close(got[0], want[0], **GRAD_TOL["float32"])
    torch.testing.assert_close(got[1], want[1], **GRAD_TOL["float32"])


# ---------------------------------------------------------------------------
# B3 / B4 chunked softmax cross-entropy
# ---------------------------------------------------------------------------

def _ce_inputs(N, V, seed=0):
    """Logits with a wide range, labels with masked (-100) rows and one on
    the last column, and a loss cotangent that is zero on masked rows."""
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.standard_normal((N, V))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[::3] = -100
    labels[-1] = V - 1
    g = rng.uniform(0.5, 1.5, N).astype(np.float32) * (labels >= 0)
    return logits, labels, g


# (N, V, block_v of the reference kernel: it needs V % block_v == 0)
CE_CASES = [(8, 96, 32), (13, 40, 40), (32, 256, 128)]


@pytest.mark.parametrize("N,V,bv", CE_CASES)
def test_cross_entropy_plain_matches_reference_kernel(jx, N, V, bv):
    logits, labels, g = _ce_inputs(N, V)
    jl, jlab = jx.jnp.asarray(logits), jx.jnp.asarray(labels)

    def jloss(x):
        return jx.cross_entropy(x, jlab, block_rows=8, block_v=bv, interpret=True)

    want_loss, vjp = jx.jax.vjp(jloss, jl)
    (want_dx,) = vjp(jx.jnp.asarray(g))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    loss, lse = ref.softmax_cross_entropy_ref(tl, tlab)
    np.testing.assert_allclose(_f32(loss), _f32(want_loss), atol=ATOL["float32"])
    np.testing.assert_allclose(
        _f32(loss), _f32(jx.ref.softmax_cross_entropy_ref(jl, jlab)),
        atol=ATOL["float32"])
    dx = ref.softmax_cross_entropy_bwd_ref(tl, tlab, lse, torch.from_numpy(g))
    np.testing.assert_allclose(_f32(dx), _f32(want_dx), **GRAD_TOL["float32"])
    assert torch.count_nonzero(dx[torch.from_numpy(labels < 0)]) == 0

    lx = tl.clone().requires_grad_(True)
    per_row = ops.softmax_cross_entropy(lx, tlab)
    torch.testing.assert_close(per_row, loss, rtol=0, atol=0)
    (ax,) = torch.autograd.grad(per_row, lx, torch.from_numpy(g))
    torch.testing.assert_close(ax, dx, rtol=0, atol=0)


def test_cross_entropy_op_keeps_leading_dims_and_no_label_grad():
    logits, labels, _ = _ce_inputs(12, 50, seed=3)
    x = torch.from_numpy(logits).reshape(3, 4, 50).requires_grad_(True)
    lab = torch.from_numpy(labels).reshape(3, 4)
    loss = ops.softmax_cross_entropy(x, lab)
    assert loss.shape == (3, 4) and loss.dtype == torch.float32
    want = torch.nn.functional.cross_entropy(
        x.detach().reshape(12, 50), lab.reshape(12).clamp(min=0).long(),
        reduction="none").reshape(3, 4)
    torch.testing.assert_close(loss.detach(), want, atol=2e-5, rtol=0)
    mask = (lab >= 0).float()
    (dx,) = torch.autograd.grad((loss * mask).sum(), x)
    assert torch.count_nonzero(dx[lab < 0]) == 0


def test_new_kernels_on_cpu_raise_and_count_nothing():
    x, g, dy = (torch.from_numpy(a) for a in _rmsnorm_grad_inputs((4, 48)))
    logits, labels, gg = (torch.from_numpy(a) for a in _ce_inputs(6, 40))
    ops.reset_launch_counts()
    ops.softmax_cross_entropy(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        ops.softmax_cross_entropy(logits, labels, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm_bwd(x, g, dy)
    with pytest.raises(ValueError, match="CUDA"):
        ce.ce_fwd(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        ce.ce_bwd(logits, labels, gg, gg)
    assert set(ops.launch_counts().values()) == {0}

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D", [(1, 48), (37, 576), (4097, 1024)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(rows, D, dtype):
    _need_card()
    x = (3 * torch.randn(rows, D, device="cuda")).to(TORCH_DT[dtype])
    g = 0.5 * torch.randn(D, device="cuda")
    dy = torch.randn(rows, D, device="cuda").to(TORCH_DT[dtype])
    n0 = rn.bwd_launches
    dx, dg = rn.rmsnorm_bwd(x, g, dy)
    assert rn.bwd_launches == n0 + 1
    want_dx, want_dg = ref.rmsnorm_bwd_ref(x, g, dy)
    torch.testing.assert_close(dx.float(), want_dx.float(), **GRAD_TOL[dtype])
    torch.testing.assert_close(dg, want_dg, **GRAD_TOL["float32"])
    again = rn.rmsnorm_bwd(x, g, dy)[1]
    assert torch.equal(again, dg)            # fixed summation order


@pytest.mark.gpu
@pytest.mark.parametrize("N,V", [(1, 7), (37, 1000), (256, 2048), (64, 50257)])
def test_cross_entropy_kernels_match_plain_on_card(N, V):
    _need_card()
    logits, labels, g = (torch.from_numpy(a).cuda() for a in _ce_inputs(N, V))
    lab = labels.clamp(0, V - 1)
    n0 = ops.launch_counts()
    loss, lse = ce.ce_fwd(logits, lab)
    dx = ce.ce_bwd(logits, lab, lse, g)
    n1 = ops.launch_counts()
    assert (n1["ce_fwd"] - n0["ce_fwd"], n1["ce_bwd"] - n0["ce_bwd"]) == (1, 1)
    want_loss, want_lse = ref.softmax_cross_entropy_ref(logits, lab)
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=ATOL["float32"])
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=ATOL["float32"])
    want_dx = ref.softmax_cross_entropy_bwd_ref(logits, lab, want_lse, g)
    torch.testing.assert_close(dx, want_dx, **GRAD_TOL["float32"])
    assert torch.count_nonzero(dx[labels < 0]) == 0


# B, S, H, K, d, window, softcap, storage dtype, operand mode
FLASH_CASES = [
    (2, 128, 4, 4, 64, 0, 0.0, "float32", "none"),
    (2, 200, 9, 3, 64, 0, 0.0, "float32", "none"),      # GQA, ragged S
    (1, 256, 4, 2, 64, 48, 0.0, "float32", "bf16"),     # window
    (1, 130, 4, 2, 128, 0, 20.0, "float32", "bf16"),    # softcap, d 128
    (2, 96, 4, 1, 32, 0, 0.0, "bfloat16", "none"),      # MQA, d 32
    (1, 192, 6, 2, 64, 0, 0.0, "bfloat16", "bf16"),
]


def _chip_smoke():
    """chip_smoke.py as a module: its B5-B7 check (flash_pair, rounds_like
    and their limits) is the one these cases use."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,d,window,softcap,dtype,mode", FLASH_CASES)
def test_flash_kernels_match_plain_on_card(B, S, H, K, d, window, softcap, dtype,
                                           mode):
    """B5-B7 through ops.attention's autograd Function, one launch each, and
    in the f32 operand mode against the plain attention under autograd (the
    f32 tiers, or the bf16 tiers with bf16 storage).  Then each kernel
    against its plain version at the kernels' contract (flash_fwd_ref,
    flash_bwd_ref, which round where the kernels round), by chip_smoke.py's
    check: lse at f32 (atol 2e-5 / rtol 1e-5); o and dq/dk/dv at the f32
    tiers where nothing rounds to bf16, else chip_smoke.rounds_like (max
    abs err within the bf16 tiers, mean within FLASH_MEAN_TOL), which in
    the bf16 mode the f32-mode outputs must fail.  dk/dv the same bits when
    repeated."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = TORCH_DT[dtype]
    q, do = (torch.randn(B, S, H, d, device="cuda", generator=gen).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, S, K, d, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    scale = 0.5 if softcap else 0.125
    policy = QuantPolicy(mode)
    kw = dict(causal=True, window=window, softcap=softcap, policy=policy)
    outs = {}
    for impl in ("kernel", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = ops.launch_counts()
        o = ops.attention(*leaves, impl=impl, scale=scale, **kw)
        grads = torch.autograd.grad(o, leaves, do)
        n1 = ops.launch_counts()
        launched = [n1[n] - n0[n] for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
        assert launched == ([1, 1, 1] if impl == "kernel" else [0, 0, 0])
        assert all(g.dtype == dt for g in grads)
        outs[impl] = [o.detach(), *grads]
    if mode == "none":
        tier = dtype
        got, want = outs["kernel"], outs["ref"]
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                                   atol=ATOL[tier])
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g.float(), w.float(), **GRAD_TOL[tier])

    cs = _chip_smoke()
    qs = (q.float() * scale).to(dt)
    got, want, _ = cs.flash_pair(fa, ref, qs, k, v, do, **kw)
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=1e-5)
    rounded = [mode == "bf16" or dtype == "bfloat16"] + [mode == "bf16"] * 3
    for name, g, w, r in zip(("o", "dq", "dk", "dv"), got[:1] + got[2:],
                             want[:1] + want[2:], rounded):
        if r:
            assert cs.rounds_like(name, cs.rounded_err(g, w)), (name, cs.rounded_err(g, w))
            continue
        tol = dict(rtol=0, atol=ATOL["float32"]) if name == "o" else GRAD_TOL["float32"]
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
    dk, dv = fa.flash_bwd_dkv(qs, k, v, do, got[1], _[0] if False else
                              (do.float() * got[0].float()).sum(-1).transpose(1, 2).contiguous(),
                              **kw)
    assert torch.equal(dk, got[3]) and torch.equal(dv, got[4])
    if mode == "bf16":
        f32, _, _ = cs.flash_pair(fa, ref, qs, k, v, do, **dict(kw, policy=None))
        for name, g, w in zip(("o", "dq", "dk", "dv"), f32[:1] + f32[2:],
                              want[:1] + want[2:]):
            assert not cs.rounds_like(name, cs.rounded_err(g, w)), name
