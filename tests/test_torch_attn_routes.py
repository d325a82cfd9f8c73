"""The `attn_impl` routes 'pallas', 'pallas_windows' and 'einsum' of the
port against the JAX package on the CPU, fp32: Pallas rows 10
(`windowed_attention_image`) and 11 (`fused_window_attention`), forward
and backward, against the Pallas kernels in interpret mode; the
SwinTemporalStack of each route against the JAX stack; `build_model` on
each route against the JAX `build_model`; one stage-1 train step on the
'pallas' route against the JAX `make_seg_train_step`; and the port's
dead-compute, streaming and autograd-Function paths on each route against
its own plain forms.

The JAX side reaches its Pallas kernels through the monkeypatches of
`tests/test_pallas_block_attention.py` and `tests/test_pallas_attention.py`
(interpret mode), set up here for this file only."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu.models import SwinTemporalStack as JStack  # noqa: E402
from stswincl_tpu.ops import pallas_attention as jpa  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jpba  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu.pipelines import common as jcommon  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax, state_dict_from_jax  # noqa: E402
from stswincl_tpu_torch.models import SwinTemporalStack  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.models.swin import resolve_attn_impl  # noqa: E402
from stswincl_tpu_torch.ops.attention import (  # noqa: E402
    fused_window_attention, space_time_window_attention_fused)
from stswincl_tpu_torch.ops.block_attention import (  # noqa: E402
    windowed_attention_image)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from tests.test_torch_train import check_train_step_matches_jax  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

ROUTES = ("einsum", "pallas", "pallas_windows")
# Rows 10 and 11 against the interpreted Pallas kernels, fp32: the same
# formula in another summation order, ||port - jax|| / ||jax|| <= 1e-5 for
# the output and every gradient.
OP_TOL = 1e-5
# The stacks, fp32 on both sides with the same GELU polynomial (the JAX
# stack on its TPU routing, kernels interpreted): 1e-4, as
# `tests/test_torch_swin.py` holds the 'pallas_full' route.
STACK_TOL = 1e-4
# The whole model, JAX on its CPU route: its GELU is the exact erf, the
# port's the polynomial (2.6e-5 apart), as in `tests/test_torch_model.py`.
LOGIT_TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's routes 'pallas' and 'pallas_windows' with their
    Pallas kernels interpreted on the CPU."""
    import stswincl_tpu.models.swin as jswin

    wai = jpba.windowed_attention_image
    monkeypatch.setattr(jpba, "windowed_attention_image",
                        lambda qkv, b, m, heads, scale, ws, interpret=False:
                        wai(qkv, b, m, heads, scale, ws, True))
    stwaf = jpa.space_time_window_attention_fused
    monkeypatch.setattr(jswin, "space_time_window_attention_fused",
                        lambda q, k, v, rb, m, scale, use_pallas=None:
                        stwaf(q, k, v, rb, m, scale, interpret=True))


@pytest.fixture
def jax_tpu_routing(jax_interpret, monkeypatch):
    """On top of `jax_interpret`: the JAX blocks routed as on the TPU, so
    their tail is the interpreted epilogue kernel (the function K2 ports)
    rather than the flax LayerNorm / Mlp path."""
    import stswincl_tpu.ops.pallas_add_ln_mlp as palm
    monkeypatch.setattr(jpa, "_is_tpu_backend", lambda: True)
    epi = palm.fused_swin_block_epilogue
    monkeypatch.setattr(palm, "fused_swin_block_epilogue",
                        lambda *a, **kw: epi(*a[:11], 1e-5, True))


def _attn_case(rng, masked, B=2, T=2, H=8, W=12, C=32, heads=2, ws=4):
    """qkv (B, T, H, W, 3C), the tiled bias and mask of a (S)W-MSA block:
    nW = 6 windows an image and B = 2 images, so a mask indexed by the
    wrong convention meets a window it does not belong to."""
    N, TN = ws * ws, T * ws * ws
    qkv = rng.standard_normal((B, T, H, W, 3 * C)).astype(np.float32)
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.5).astype(
        np.float32)
    bias = table[relative_position_index(ws, ws).reshape(-1)].reshape(
        N, N, heads).transpose(2, 0, 1)
    mask = (shifted_window_attention_mask(H, W, ws, ws // 2) if masked
            else np.zeros((1, N, N), np.float32))
    return dict(qkv=qkv, bias=bias, mask=mask, bias_t=np.tile(bias, (1, T, T)),
                mask_t=np.tile(mask, (1, T, T)), heads=heads,
                scale=(C // heads) ** -0.5, ws=ws, G=rng.standard_normal(
                    (B, T, H, W, C)).astype(np.float32))


def _qkv_windows(case):
    """The row-11 inputs of a case: its qkv partitioned as the JAX model
    does (`models/swin.py:270-275`), (Bw, heads, TN, hd) each."""
    qkv, heads, ws = case["qkv"], case["heads"], case["ws"]
    B, T, H, W, C3 = qkv.shape
    xw = qkv.reshape(B, T, H // ws, ws, W // ws, ws, C3)
    xw = xw.transpose(0, 2, 4, 1, 3, 5, 6).reshape(
        -1, T * ws * ws, 3, heads, C3 // 3 // heads)
    q, k, v = np.ascontiguousarray(xw.transpose(2, 0, 3, 1, 4))
    return q, k, v


@pytest.mark.parametrize("masked", [True, False], ids=["sw", "w"])
def test_row10_forward_and_backward_match_jax(rng, masked):
    c = _attn_case(rng, masked)
    args = (c["heads"], c["scale"], c["ws"])

    def jloss(qkv, bias):
        out = jpba.windowed_attention_image(qkv, bias, jnp.asarray(c["mask_t"]),
                                            *args, True)
        return jnp.sum(out * c["G"]), out
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(c["qkv"]), jnp.asarray(c["bias_t"]))

    masks = [T_(c["mask_t"])] + ([] if masked else [None])
    for mask in masks:  # the W-MSA marker and None are one case
        qkv = T_(c["qkv"]).requires_grad_()
        bias = T_(c["bias_t"]).requires_grad_()
        out = windowed_attention_image(qkv, bias, mask, *args)
        (out * T_(c["G"])).sum().backward()
        assert _rel(out.detach(), want) <= OP_TOL
        for got, jg in zip((qkv.grad, bias.grad), jgrads):
            assert _rel(got, jg) <= OP_TOL
        with torch.no_grad():  # the forward without the autograd Function
            plain = windowed_attention_image(qkv, bias, mask, *args)
        assert _rel(plain, want) <= OP_TOL


@pytest.mark.parametrize("masked", [True, False], ids=["sw", "w"])
def test_row11_forward_and_backward_match_jax(rng, masked):
    """The backward is the port of JAX's `_bwd`: held against `jax.grad`
    through the interpreted kernel, whose VJP that `_bwd` is."""
    c = _attn_case(rng, masked)
    q, k, v = _qkv_windows(c)
    G = rng.standard_normal(q.shape).astype(np.float32)
    mask_j = jnp.asarray(c["mask_t"])

    def jloss(q, k, v, bias):
        out = jpa.fused_window_attention(q, k, v, bias, mask_j, c["scale"],
                                         True)
        return jnp.sum(out * G), out
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v, c["bias_t"])))

    masks = [T_(c["mask_t"])] + ([] if masked else [None])
    for mask in masks:
        leaves = [T_(a).requires_grad_() for a in (q, k, v, c["bias_t"])]
        out = fused_window_attention(*leaves, mask, c["scale"])
        (out * T_(G)).sum().backward()
        assert _rel(out.detach(), want) <= OP_TOL
        for leaf, jg in zip(leaves, jgrads):
            assert _rel(leaf.grad, jg) <= OP_TOL

    # the untiled entry, against the JAX one
    mask = c["mask"] if masked else None
    want = jpa.space_time_window_attention_fused(
        *map(jnp.asarray, (q, k, v, c["bias"])),
        None if mask is None else jnp.asarray(mask), c["scale"],
        interpret=True)
    got = space_time_window_attention_fused(
        *map(T_, (q, k, v, c["bias"])), None if mask is None else T_(mask),
        c["scale"])
    assert _rel(got, want) <= OP_TOL


def test_resolve_attn_impl():
    assert resolve_attn_impl("auto") == "pallas_full"
    for name in ("pallas_full", *ROUTES):
        assert resolve_attn_impl(name) == name
    with pytest.raises(ValueError, match="unknown attn_impl"):
        resolve_attn_impl("flash")


# 16x24 keeps both stages above their windows (8 at stage 1, 4 at stage 2),
# so every SW block really shifts; depths (2, 2) run both pair schedules
RES, DIM, HEADS, DEPTHS = (16, 24), 32, 4, (2, 2)


@pytest.fixture(scope="module")
def stack_case():
    x = np.random.default_rng(0).standard_normal(
        (2, 5, *RES, DIM)).astype(np.float32)
    stack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                   depths=DEPTHS, attn_impl="einsum")
    variables = jax.jit(stack.init)(jax.random.key(0), jnp.asarray(x[:, :4]))
    return x, variables


@pytest.mark.parametrize("route", ROUTES)
def test_stack_matches_jax(stack_case, jax_tpu_routing, route):
    """Each route's stack on the weights of one JAX variable tree (every
    route shares it) against the JAX stack on the same route: rolls around
    the attention, the unshifted epilogue."""
    x, variables = stack_case
    s1_j, s2_j = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                        depths=DEPTHS, attn_impl=route).apply(
        variables, jnp.asarray(x[:, :4]))
    port = SwinTemporalStack(DIM, RES, HEADS, depths=DEPTHS, attn_impl=route)
    load_from_jax(port, variables)
    with torch.no_grad():
        s1, s2 = port(T_(x[:, :4]))
    assert s1.shape == (2, 4, *RES, DIM)
    assert s2.shape == (2, 4, RES[0] // 2, RES[1] // 2, 2 * DIM)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=STACK_TOL,
                               atol=STACK_TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), rtol=STACK_TOL,
                               atol=STACK_TOL)


@pytest.mark.parametrize("route", ROUTES)
def test_stack_modes_and_functions_on_each_route(stack_case, route):
    """On each route: `final_pair_only` keeps the live outputs, the
    layer-0 cache reproduces the full stack (what `StreamingSegmenter`
    serves through), the autograd Functions of the kernel route
    (`kernels=True`, their CPU forms) give the plain route's gradients,
    and every parameter gets one."""
    x, _ = stack_case
    xt = T_(x)
    full = init_weights(SwinTemporalStack(DIM, RES, HEADS, depths=DEPTHS,
                                          attn_impl=route),
                        torch.Generator().manual_seed(0))
    lean = SwinTemporalStack(DIM, RES, HEADS, depths=DEPTHS,
                             final_pair_only=True, attn_impl=route)
    lean.load_state_dict(full.state_dict())
    with torch.no_grad():
        s1_f, s2_f = full(xt[:, 1:5])
        s1_l, s2_l = lean(xt[:, 1:5])
        g_a = lean(xt[:, 1:3], layer0_only=True)
        s1_c, s2_c, _ = lean(xt[:, 1:5], layer0_cached=g_a)
    torch.testing.assert_close(s1_l, s1_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2_l[:, -1], s2_f[:, -1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1_c, s1_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2_c[:, -1], s2_f[:, -1], rtol=1e-5, atol=1e-5)

    grads = []
    for kern in (False, True):
        m = SwinTemporalStack(DIM, RES, HEADS, depths=DEPTHS, attn_impl=route,
                              kernels=kern)
        m.load_state_dict(full.state_dict())
        s1, s2 = m(xt[:, :4])
        (s1.square().mean() + s2.square().mean()).backward()
        named = dict(m.named_parameters())
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in named.values())
        grads.append({n: p.grad for n, p in named.items()})
    for n, g in grads[0].items():
        # row 11's backward is JAX's formula (fp32 q scaled before the
        # product, a dividing softmax), not autograd of the forward
        torch.testing.assert_close(grads[1][n], g, rtol=1e-4, atol=1e-6,
                                   msg=n)


HW, NC = (128, 128), 5


def _configs(route):
    return (ModelConfig(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                        attn_impl=route, dtype="float32"),
            DataConfig(dataset="synthetic", crop_hw=HW))


@pytest.mark.parametrize("route", ("auto",) + ROUTES)
def test_build_model_matches_jax(jax_interpret, route):
    """`build_model` of each route against the JAX `build_model` of the
    same configs, on the JAX model's own initialised variables (its CPU
    route: the exact-erf GELU; 'auto' there is 'einsum', here
    'pallas_full', the same function)."""
    model_cfg, data_cfg = _configs(route)
    jm, jnc = jcommon.build_model(model_cfg, data_cfg)
    clip = np.random.default_rng(1).standard_normal(
        (1, 4, *HW, 3)).astype(np.float32)
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(clip))
    want = jax.jit(functools.partial(jm.apply, train=False,
                                     head_res_logits=True))(
        variables, jnp.asarray(clip))
    port, nc = build_model(model_cfg, data_cfg, device="cpu")
    assert nc == jnc == NC
    load_from_jax(port, variables)
    with torch.no_grad():
        got = port.eval()(T_(clip), head_res_logits=True)
    assert got.shape == (1, NC, HW[0] // 8, HW[1] // 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_pallas_variables_load_without_leftovers(jax_interpret):
    """All routes share one JAX variable tree: the variables of an
    `attn_impl='pallas'` TswinPlus place every leaf in the port's model."""
    model_cfg, data_cfg = _configs("pallas")
    jm, _ = jcommon.build_model(model_cfg, data_cfg)
    variables = jax.eval_shape(functools.partial(jm.init, train=False),
                               jax.random.key(0),
                               jnp.zeros((1, 4, *HW, 3), jnp.float32))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables)
    port, _ = build_model(model_cfg, data_cfg, device="cpu")
    sd, unmatched = state_dict_from_jax(variables, port)
    assert unmatched == []
    assert set(sd) == set(port.state_dict())


def test_build_model_takes_the_cadis_class_count():
    from stswincl_tpu.data.cadis import CADIS_CLASS_NUM
    model_cfg, _ = _configs("pallas")
    for tag in ("1", "3"):
        data_cfg = DataConfig(dataset="cadis", tag=tag, crop_hw=HW)
        port, nc = build_model(model_cfg, data_cfg, device="cpu")
        assert nc == CADIS_CLASS_NUM[tag] == port.num_classes
        assert nc == jcommon.build_model(model_cfg, data_cfg)[1]


def test_build_model_refuses_what_is_not_ported():
    """An unknown arch and an unknown attn_impl raise ValueError (every
    arch and option of the JAX `build_model` is ported)."""
    model_cfg, data_cfg = _configs("pallas")
    model_cfg.arch = "swinPlus_v2"
    with pytest.raises(ValueError, match="unknown arch"):
        build_model(model_cfg, data_cfg, device="cpu")
    model_cfg, _ = _configs("flash")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        build_model(model_cfg, data_cfg, device="cpu")


def test_train_step_on_the_pallas_route_matches_jax(jax_interpret):
    """One stage-1 step, 'pallas' on both sides: the port through the
    row-10 Function (`kernels=True`; its CPU form), JAX through the
    interpreted kernel and its custom VJP; the bounds of
    `tests/test_torch_train.py`."""
    check_train_step_matches_jax("pallas", kernels=True)
