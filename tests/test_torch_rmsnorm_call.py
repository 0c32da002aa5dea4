"""B1's call path (``ops.fused_rmsnorm``): where no gradient is wanted it
calls the forward alone, without the autograd Function; where one is, the
Function runs B1 forward and B2 backward as before.

- Under ``torch.no_grad()`` and with inputs that need no gradient, the call
  gives the same bits as through ``ops._RMSNorm`` (the plain version on the
  CPU), and the output needs no gradient either.
- On the kernel branch (its wiring held on the CPU by standing the plain
  versions in for the CUDA wrappers): no gradient wanted -> one forward
  call, no Function, the gain handed over as float32 and contiguous;
  gradient wanted -> the Function, whose backward is B2.
- With x, the gain or both requiring a gradient, the gradients flow and
  match jax.vjp of the reference's Pallas RMSNorm (interpret mode) at the
  float32 gradient tier (atol 2e-4, rtol 1e-3).
- ``impl="kernel"`` on a CPU tensor raises and counts nothing, with and
  without a gradient wanted.
- On the card (marked ``gpu``): one call adds exactly one to
  ``rmsnorm.launches``, with and without a gradient wanted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    g = (0.5 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("no_grad", [True, False], ids=["no_grad", "inputs_need_none"])
def test_forward_alone_gives_the_functions_bits(dtype, no_grad):
    x, g, _ = _inputs((4, 1, 576))
    x = x.to(dtype)
    if no_grad:
        x.requires_grad_(True)   # wanted by nothing while grad mode is off
        with torch.no_grad():
            got = ops.fused_rmsnorm(x, g, eps=1e-6)
            want = ops._RMSNorm.apply(x.detach(), g, 1e-6, False)
    else:
        got = ops.fused_rmsnorm(x, g, eps=1e-6)
        want = ops._RMSNorm.apply(x, g, 1e-6, False)
    assert not got.requires_grad and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.fixture
def kernel_branch(monkeypatch):
    """ops' kernel branch on the CPU: resolve_impl says "kernel" and the
    CUDA wrappers are stood in for by their plain versions, recording what
    they are handed."""
    seen = {"fwd": [], "bwd": [], "apply": 0}

    def fwd(x, gain, eps=1e-6):
        seen["fwd"].append(gain)
        return ref.rmsnorm_ref(x, gain, eps)

    def bwd(x, gain, dy, eps=1e-6):
        seen["bwd"].append(gain)
        return ref.rmsnorm_bwd_ref(x, gain, dy, eps)

    real_apply = ops._RMSNorm.apply

    def apply(*a):
        seen["apply"] += 1
        return real_apply(*a)

    monkeypatch.setattr(ops, "resolve_impl", lambda impl, x: "kernel")
    monkeypatch.setattr(rn, "rmsnorm", fwd)
    monkeypatch.setattr(rn, "rmsnorm_bwd", bwd)
    monkeypatch.setattr(ops._RMSNorm, "apply", apply)
    return seen


def test_kernel_branch_without_grad_skips_the_function(kernel_branch):
    x, g, _ = _inputs((3, 40))
    g_strided = torch.stack([g, g], 1)[:, 0].to(torch.bfloat16)   # neither f32 nor contiguous
    with torch.no_grad():
        y = ops.fused_rmsnorm(x, g_strided, impl="kernel")
    y2 = ops.fused_rmsnorm(x, g, impl="kernel")
    assert kernel_branch["apply"] == 0 and len(kernel_branch["fwd"]) == 2
    handed = kernel_branch["fwd"][0]
    assert handed.dtype == torch.float32 and handed.is_contiguous()
    assert kernel_branch["fwd"][1] is g   # already f32 and contiguous: not copied
    assert torch.equal(y, ref.rmsnorm_ref(x, g_strided.float(), 1e-6))
    assert torch.equal(y2, ref.rmsnorm_ref(x, g, 1e-6))


def test_kernel_branch_with_grad_runs_the_function(kernel_branch):
    x, g, dy = _inputs((3, 40))
    lx, lg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    y = ops.fused_rmsnorm(lx, lg, impl="kernel")
    dx, dg = torch.autograd.grad(y, (lx, lg), dy)
    assert kernel_branch["apply"] == 1
    assert len(kernel_branch["fwd"]) == 1 and len(kernel_branch["bwd"]) == 1
    want = ref.rmsnorm_bwd_ref(x, g, dy, 1e-6)
    assert torch.equal(dx, want[0]) and torch.equal(dg, want[1])


@pytest.mark.parametrize("needs", ["x", "gain", "both"])
def test_gradients_match_the_reference_vjp(needs):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.rmsnorm import rmsnorm as jrmsnorm

    x, g, dy = _inputs((5, 7, 48), seed=1)
    _, vjp = jax.vjp(lambda a, b: jrmsnorm(a, b, eps=1e-6, block_rows=8, interpret=True),
                     jnp.asarray(x.numpy()), jnp.asarray(g.numpy()))
    want_dx, want_dg = vjp(jnp.asarray(dy.numpy()))
    lx = x.clone().requires_grad_(needs in ("x", "both"))
    lg = g.clone().requires_grad_(needs in ("gain", "both"))
    y = ops.fused_rmsnorm(lx, lg, eps=1e-6)
    assert y.requires_grad
    leaves = [t for t in (lx, lg) if t.requires_grad]
    got = dict(zip([id(t) for t in leaves], torch.autograd.grad(y, leaves, dy)))
    if lx.requires_grad:
        np.testing.assert_allclose(got[id(lx)].numpy(), np.asarray(want_dx), **GRAD_TOL)
    if lg.requires_grad:
        np.testing.assert_allclose(got[id(lg)].numpy(), np.asarray(want_dg), **GRAD_TOL)


@pytest.mark.parametrize("grad", [False, True])
def test_kernel_on_cpu_raises_and_counts_nothing(grad):
    x, g, _ = _inputs((4, 48))
    x.requires_grad_(grad)
    rn.launches = rn.bwd_launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_rmsnorm(x, g, impl="kernel")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ops.fused_rmsnorm(x, g, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x.detach(), g)
    assert rn.launches == 0 and rn.bwd_launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("grad", [False, True])
def test_one_call_is_one_launch_on_card(grad):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90) and nvcc to build the kernels")
    x, g, dy = (t.cuda() for t in _inputs((4, 1, 576)))
    x.requires_grad_(grad)
    n0, b0 = rn.launches, rn.bwd_launches
    y = ops.fused_rmsnorm(x, g, impl="kernel")
    assert rn.launches == n0 + 1 and y.requires_grad == grad
    want = ref.rmsnorm_ref(x.detach(), g)
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=2e-5)
    if grad:
        y.backward(dy)
        assert rn.bwd_launches == b0 + 1 and rn.launches == n0 + 1
