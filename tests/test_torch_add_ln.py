"""Pallas rows 13 (`fused_add_ln_mlp`) and 14 (`fused_add_layer_norm`) of
the port against the JAX package's interpreted kernels on the CPU, fp32,
forward and backward: the port's twins on a CPU tensor and its autograd
Functions (row 13: autograd of the twin, as JAX's `_bwd` is a VJP of
`add_ln_mlp_ref`; row 14: the formula of `_faln_bwd` in plain PyTorch)
against `jax.grad` through the Pallas kernels' custom VJPs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops.pallas_add_layernorm import fused_add_layer_norm  # noqa: E402
from stswincl_tpu.ops.pallas_add_ln_mlp import fused_add_ln_mlp  # noqa: E402
from stswincl_tpu_torch.ops.add_layernorm import (  # noqa: E402
    add_layer_norm, add_layer_norm_bwd, add_layer_norm_ref)
from stswincl_tpu_torch.ops.add_ln_mlp import (add_ln_mlp,  # noqa: E402
                                               add_ln_mlp_ref)

torch.set_num_threads(1)
T_ = torch.from_numpy

# fp32 on both sides, the same formulas in another summation order (and,
# for row 13, the same GELU polynomial): ||port - jax|| / ||jax|| <= 1e-4
# for every output and gradient.
TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _rows(rng, C, rows=(2, 40)):
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k  # noqa: E731
                                  + o).astype(np.float32)
    return f(*rows, C), f(*rows, C), f(C, k=0.1, o=1.0), f(C, k=0.1), f


@pytest.mark.parametrize("gelu_exact", [True, False], ids=["erf", "tanh"])
def test_row13_forward_and_backward_match_jax(rng, gelu_exact):
    C, hidden = 64, 256
    x, y, scale, bias, f = _rows(rng, C)
    w1, b1 = f(C, hidden, k=0.1), f(hidden, k=0.05)   # JAX (in, out) layout
    w2, b2 = f(hidden, C, k=0.1), f(C, k=0.05)
    Gs, Gm = f(*x.shape), f(*x.shape)
    args = (x, y, scale, bias, w1, b1, w2, b2)

    def jloss(*a):
        s, m = fused_add_ln_mlp(*a, gelu_exact, 1e-5, True)
        return jnp.sum(s * Gs) + jnp.sum(m * Gm), (s, m)
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(8)),
                                           has_aux=True)(
        *map(jnp.asarray, args))

    port_args = [T_(a) for a in (x, y, scale, bias)] + [
        T_(np.ascontiguousarray(w1.T)), T_(b1),
        T_(np.ascontiguousarray(w2.T)), T_(b2)]
    with torch.no_grad():
        for got, w in zip(add_ln_mlp(*port_args, gelu_exact), want):
            assert _rel(got, w) <= TOL
    for fn in (add_ln_mlp, add_ln_mlp_ref):  # the Function, the twin
        leaves = [t.clone().requires_grad_() for t in port_args]
        s, m = fn(*leaves, gelu_exact)
        ((s * T_(Gs)).sum() + (m * T_(Gm)).sum()).backward()
        for got, w in zip((s, m), want):
            assert _rel(got.detach(), w) <= TOL
        for i, (leaf, jg) in enumerate(zip(leaves, jgrads)):
            g = leaf.grad.numpy()
            assert _rel(g.T if i in (4, 6) else g, jg) <= TOL, (fn, i)


@pytest.mark.parametrize("return_sum", [True, False])
def test_row14_forward_and_backward_match_jax(rng, return_sum):
    C = 128
    x, y, scale, bias, f = _rows(rng, C, rows=(3, 5, 24))
    Gs, Gn = f(*x.shape), f(*x.shape)
    args = (x, y, scale, bias)

    def jloss(*a):
        s, n = fused_add_layer_norm(*a, 1e-5, return_sum, True)
        loss = jnp.sum(n * Gn) + (jnp.sum(s * Gs) if return_sum else 0.0)
        return loss, (s, n)
    (_, (want_s, want_n)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray, args))
    assert (want_s is None) == (not return_sum)

    port_args = [T_(a) for a in args]
    for fn in (add_layer_norm, add_layer_norm_ref):  # the Function, the twin
        leaves = [t.clone().requires_grad_() for t in port_args]
        s, n = fn(*leaves, return_sum=return_sum)
        assert (s is None) == (not return_sum)
        loss = (n * T_(Gn)).sum()
        if return_sum:
            assert _rel(s.detach(), want_s) <= TOL
            loss = loss + (s * T_(Gs)).sum()
        assert _rel(n.detach(), want_n) <= TOL
        loss.backward()
        for leaf, jg in zip(leaves, jgrads):
            assert _rel(leaf.grad, jg) <= TOL, fn
    with torch.no_grad():
        s, n = add_layer_norm(*port_args, return_sum=return_sum)
    assert _rel(n, want_n) <= TOL
    # the backward formula alone, without the sum's gradient
    got = add_layer_norm_bwd(*port_args[:3], None, T_(Gn))
    leaves = [t.clone().requires_grad_() for t in port_args]
    _, n = add_layer_norm_ref(*leaves, return_sum=False)
    want = torch.autograd.grad((n * T_(Gn)).sum(), leaves)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C", [48, 96, 3072])
def test_row14_bf16_takes_any_width(monkeypatch, C):
    """Row 14's bf16 wrapper refuses no width: on a CPU tensor it stops at
    the device check (the message names the device, not C), and on
    tensors that report `is_cuda` it reaches `stswin_add_layer_norm` with
    the call's rows and C (48 and 96 as the JAX kernel's tests, 3072 past
    the warp-a-row kernel's 2048)."""
    from stswincl_tpu_torch import kernels
    from stswincl_tpu_torch.ops import add_layernorm as aln
    x = torch.zeros((3, 5, C), dtype=torch.bfloat16)
    scale, bias = torch.ones(C), torch.zeros(C)
    with pytest.raises(ValueError) as err:
        aln._kernel(x, x, scale, bias, 1e-5, True)
    assert "device cpu" in str(err.value) and str(C) not in str(err.value)

    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(kernels, "use_device", lambda dev: 0)
    meta = dict(device="meta")
    xm = torch.empty((3, 5, C), dtype=torch.bfloat16, **meta)
    s, out = aln._kernel(xm, xm, torch.empty(C, **meta),
                         torch.empty(C, **meta), 1e-5, True)
    assert out.shape == s.shape == xm.shape
    assert [(name, a[-3:-1]) for name, a in launched] == [
        ("stswin_add_layer_norm", (15, C))]
