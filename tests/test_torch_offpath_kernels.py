"""Pallas rows 12 (`fused_mlp`), 15 (`fused_layer_norm`) and 17
(`conv3x3_bn_act`) of the port, and their entry points (the `Mlp` and
`FusedLayerNorm` modules), against the JAX package on the CPU, fp32: the
JAX kernels run interpreted, the port's twins run on a CPU tensor and its
autograd Functions give the gradients (row 12: autograd of `mlp_ref`, as
JAX's `_fmlp_bwd` is a VJP of it; row 15: the formula of `_fln_bwd`)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import stswincl_tpu.ops.pallas_attention as jpa  # noqa: E402
import stswincl_tpu.ops.pallas_mlp as jpm  # noqa: E402
from stswincl_tpu.models.swin import Mlp as JMlp  # noqa: E402
from stswincl_tpu.ops import pallas_conv as jconv  # noqa: E402
from stswincl_tpu.ops import pallas_layernorm as jln  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.ckpt.from_jax import to_jax_layout  # noqa: E402
from stswincl_tpu_torch.models.swin import Mlp  # noqa: E402
from stswincl_tpu_torch.ops import conv, layernorm, mlp  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

# fp32 on both sides, the same formulas in another summation order (row 12:
# the same GELU polynomial; row 17: the same products in another order):
# ||port - jax|| / ||jax|| <= 1e-4 for every output and gradient.
TOL = 1e-4
ERF_POLY_ERR = 2.6e-5  # max |erf_poly_fast - erf| (`pallas_mlp.py:38-44`)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _f(rng):
    return lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k
                                     + o).astype(np.float32)


@pytest.mark.parametrize("C,hidden,gelu_exact", [
    (64, 256, True), (64, 256, False),
    (32, 512, True),  # the hidden-blocking shape of test_pallas_mlp.py
], ids=["erf", "tanh", "C32-hidden512"])
def test_row12_forward_and_backward_match_jax(rng, C, hidden, gelu_exact):
    f = _f(rng)
    x = f(2, 48, C)
    w1, b1 = f(C, hidden, k=0.1), f(hidden, k=0.05)  # JAX (in, out) layout
    w2, b2 = f(hidden, C, k=0.1), f(C, k=0.05)
    G = f(*x.shape)

    def jloss(*a):
        out = jpm.fused_mlp(*a, gelu_exact, True)
        return jnp.sum(out * G), out
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                           has_aux=True)(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))

    port = [T_(x), T_(np.ascontiguousarray(w1.T)), T_(b1),
            T_(np.ascontiguousarray(w2.T)), T_(b2)]
    with torch.no_grad():
        assert _rel(mlp.fused_mlp(*port, gelu_exact), want) <= TOL
    for fn in (mlp.fused_mlp, mlp.mlp_ref):  # the Function, the twin
        leaves = [t.clone().requires_grad_() for t in port]
        out = fn(*leaves, gelu_exact)
        assert _rel(out.detach(), want) <= TOL
        (out * T_(G)).sum().backward()
        for i, (leaf, jg) in enumerate(zip(leaves, jgrads)):
            g = leaf.grad.numpy()
            assert _rel(g.T if i in (1, 3) else g, jg) <= TOL, (fn, i)


def test_mlp_module_matches_jax(rng, monkeypatch):
    """The port's `Mlp`, loaded from the JAX `Mlp`'s variables, against the
    JAX module on its TPU routing (`fused_mlp`, interpreted) to TOL, and
    against the JAX module off the TPU (flax's exact-erf GELU) to the
    bound the erf polynomial's error gives through fc2."""
    x = _f(rng)(2, 48, 32)
    jm = JMlp(hidden=128, out=32)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    want_xla = np.asarray(jm.apply(variables, jnp.asarray(x)))
    calls = []
    fused = jpm.fused_mlp

    def interpreted(x, w1, b1, w2, b2, gelu_exact=True, interpret=False):
        calls.append(1)
        return fused(x, w1, b1, w2, b2, gelu_exact, True)
    monkeypatch.setattr(jpm, "fused_mlp", interpreted)
    monkeypatch.setattr(jpa, "_is_tpu_backend", lambda: True)
    want_tpu = np.asarray(jm.apply(variables, jnp.asarray(x)))
    assert calls == [1]

    for kern in (None, True):  # the twin; the Function on a CPU tensor
        m = load_from_jax(Mlp(32, 128, 32, kernels=kern), variables)
        got = m(T_(x))
        assert got.shape == x.shape and got.dtype == torch.float32
        got = got.detach().numpy()
        assert _rel(got, want_tpu) <= TOL
        p = variables["params"]
        pre = x @ np.asarray(p["fc1"]["kernel"]) + np.asarray(p["fc1"]["bias"])
        # |gelu_poly - gelu| <= 0.5 |pre| ERF_POLY_ERR, summed through |w2|
        bound = (0.5 * ERF_POLY_ERR * np.abs(pre)
                 @ np.abs(np.asarray(p["fc2"]["kernel"]))) + 1e-5
        assert (np.abs(got - want_xla) <= bound).all()


@pytest.mark.parametrize("shape", [(6, 128, 96), (3, 40, 64), (5, 9, 100),
                                   (3, 2050), (2, 3072)],
                         ids=["C96", "odd-rows-C64", "C100", "C2050",
                              "C3072"])
def test_row15_forward_matches_jax(rng, shape):
    f = _f(rng)
    C = shape[-1]
    x, scale, bias = f(*shape), f(C, k=0.5, o=1.0), f(C, k=0.5)
    want = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                jnp.asarray(bias), 1e-5, True)
    for fn in (layernorm.fused_layer_norm, layernorm.layer_norm_ref):
        got = fn(T_(x), T_(scale), T_(bias))
        assert got.shape == x.shape and _rel(got, want) <= TOL


def test_row15_backward_matches_jax(rng):
    f = _f(rng)
    x, scale, bias = f(4, 64, 32), f(32, k=0.5, o=1.0), f(32, k=0.5)
    G = f(*x.shape)

    def jloss(*a):
        return jnp.sum(jln.fused_layer_norm(*a, 1e-5, True) * G)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, scale, bias)))
    for fn in (layernorm.fused_layer_norm, layernorm.layer_norm_ref):
        leaves = [T_(a).requires_grad_() for a in (x, scale, bias)]
        (fn(*leaves) * T_(G)).sum().backward()
        for leaf, jg in zip(leaves, jgrads):
            assert leaf.grad.dtype == torch.float32
            assert _rel(leaf.grad, jg) <= TOL, fn


@pytest.mark.parametrize("shape", [(5, 9, 100), (3, 2050), (2, 3072)],
                         ids=["C100", "C2050", "C3072"])
def test_row15_backward_matches_jax_at_wide_rows(rng, shape):
    """The widths of the kernel's wide-row path (C % 8 != 0, C > 2048):
    the Function's backward and the twin's autograd against JAX's."""
    f = _f(rng)
    C = shape[-1]
    x, scale, bias = f(*shape), f(C, k=0.5, o=1.0), f(C, k=0.5)
    G = f(*x.shape)

    def jloss(*a):
        return jnp.sum(jln.fused_layer_norm(*a, 1e-5, True) * G)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, scale, bias)))
    for fn in (layernorm.fused_layer_norm, layernorm.layer_norm_ref):
        leaves = [T_(a).requires_grad_() for a in (x, scale, bias)]
        (fn(*leaves) * T_(G)).sum().backward()
        for leaf, jg in zip(leaves, jgrads):
            assert _rel(leaf.grad, jg) <= TOL, fn


@pytest.mark.parametrize("impl,kern", [("interpret", True), ("xla", False),
                                      ("auto", None)])
def test_fused_layer_norm_module_matches_jax(rng, impl, kern):
    f = _f(rng)
    x = f(5, 24, 64)
    variables = {"params": {"scale": f(64, k=0.5, o=1.0), "bias": f(64)}}
    jm = jln.FusedLayerNorm(impl=impl)
    G = f(*x.shape)

    def jloss(v, x):
        out = jm.apply(v, x)
        return jnp.sum(out * G), out
    (_, want), (jg_v, jg_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))
    m = load_from_jax(layernorm.FusedLayerNorm(64, kernels=kern), variables)
    xt = T_(x).requires_grad_()
    out = m(xt)
    assert _rel(out.detach(), want) <= TOL
    (out * T_(G)).sum().backward()
    assert _rel(xt.grad, jg_x) <= TOL
    assert _rel(m.weight.grad, jg_v["params"]["scale"]) <= TOL
    assert _rel(m.bias.grad, jg_v["params"]["bias"]) <= TOL


def _conv_case(rng, C=128, shape=(2, 16, 32)):
    f = _f(rng)
    x = f(*shape, C)
    w = f(C, C, 3, 3, k=0.05)  # the port's OIHW
    return (x, w, f(C, k=0.1, o=1.0), f(C, k=0.1), f(*shape, C),
            to_jax_layout("conv.weight", w))  # HWIO, as `from_jax` maps it


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("relu,with_res", [(True, False), (False, False),
                                           (True, True)],
                         ids=["relu", "linear", "relu-residual"])
def test_row17_matches_jax(rng, dilation, relu, with_res):
    x, w, scale, shift, res, w_hwio = _conv_case(rng)
    res = res if with_res else None
    want = jconv.conv3x3_bn_act(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(scale),
        jnp.asarray(shift), dilation=dilation, relu=relu,
        residual=None if res is None else jnp.asarray(res), interpret=True)
    kw = dict(dilation=dilation, relu=relu,
              residual=None if res is None else T_(res))
    for fn in (conv.conv3x3_bn_act, conv.conv3x3_bn_act_ref):
        got = fn(T_(x), T_(w), T_(scale), T_(shift), **kw)
        assert got.shape == x.shape and _rel(got, want) <= TOL


def test_row17_basicblock_composition_matches_jax(rng):
    """Two calls wired as a BasicBlock (conv-BN-ReLU, conv-BN + x, ReLU),
    as `test_pallas_conv.py`'s composition, on both packages."""
    x, w1, s, b, _, w1_hwio = _conv_case(rng, shape=(1, 16, 16))
    _, w2, _, _, _, w2_hwio = _conv_case(rng, shape=(1, 16, 16))
    jx = jnp.asarray(x)
    mid = jconv.conv3x3_bn_act(jx, jnp.asarray(w1_hwio), jnp.asarray(s),
                               jnp.asarray(b), dilation=2, relu=True,
                               interpret=True)
    want = jconv.conv3x3_bn_act(mid, jnp.asarray(w2_hwio), jnp.asarray(s),
                                jnp.asarray(b), dilation=2, relu=True,
                                residual=jx, interpret=True)
    xt = T_(x)
    got = conv.conv3x3_bn_act(xt, T_(w1), T_(s), T_(b), dilation=2)
    got = conv.conv3x3_bn_act(got, T_(w2), T_(s), T_(b), dilation=2,
                              residual=xt)
    assert _rel(got, want) <= TOL


def test_fold_bn_matches_jax(rng):
    f = _f(rng)
    gamma, beta, mean = f(16, o=1.0), f(16), f(16)
    var = np.abs(f(16)) + 0.1
    want = jconv.fold_bn(*map(jnp.asarray, (gamma, beta, mean, var)))
    got = conv.fold_bn(*map(T_, (gamma, beta, mean, var)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_row17_envelope():
    """The port's envelope (OIHW w) against the Pallas one (HWIO w): both
    take the dilated stages; the port also takes the 64-channel layer1
    shape, which the TPU's 128 lanes ruled out; both refuse stride 2 and
    a 1x1 kernel; the port refuses channels off its multiples."""
    x5, w5 = (4, 64, 80, 512), (512, 512, 3, 3)
    assert conv.supports(x5, w5, 4, 1)
    assert jconv.supports(x5, (3, 3, 512, 512), 4, 1)
    x1, w1 = (4, 128, 160, 64), (64, 64, 3, 3)
    assert conv.supports(x1, w1, 1, 1)
    assert not jconv.supports(x1, (3, 3, 64, 64), 1, 1)
    assert conv.supports(x5, w5, 18, 1)  # most taps in the padding
    assert not conv.supports(x5, w5, 1, 2)
    assert not jconv.supports(x5, (3, 3, 512, 512), 1, 2)
    assert not conv.supports(x5, (512, 512, 1, 1), 1, 1)
    assert not conv.supports((4, 64, 80, 48), (64, 48, 3, 3), 1, 1)  # Cin
    assert not conv.supports(x5, (500, 512, 3, 3), 1, 1)  # Cout
    assert not conv.supports(x5, (512, 256, 3, 3), 1, 1)  # w over other Cin
    assert not conv.supports(x5, w5, 0, 1)


def test_kernel_wrappers_refuse_cpu_launches():
    """The kernels themselves run only on a card: a CPU tensor handed to
    a launch raises instead of falling back."""
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="no kernel"):
        mlp._kernel(x, torch.zeros(128, 64), torch.zeros(128),
                    torch.zeros(64, 128), torch.zeros(64), True)
    with pytest.raises(ValueError, match="no kernel"):
        layernorm._kernel(x, torch.ones(64), torch.zeros(64), 1e-5)
    with pytest.raises(ValueError, match="no kernel"):
        conv._kernel(torch.zeros(1, 4, 4, 32), torch.zeros(32, 32, 3, 3),
                     torch.ones(32), torch.zeros(32), 1, True, None)
