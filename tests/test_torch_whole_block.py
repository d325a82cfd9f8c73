"""The whole-block route (Pallas row 16, `whole_block=True`) of the port
against the JAX package on the CPU, fp32: row 16's twin and its backward
against `fused_whole_swin_block` in interpret mode; a `whole_block` stack
in each of its modes (full, `final_pair_only`, `layer0_only`,
`layer0_cached`) against the JAX stack on the same routing; one stage-1
train step against the JAX `make_seg_train_step` on that routing; and the
variable tree of that routing loading with no leaf left over.

The JAX package takes row 16 only on its TPU routing with
`STSWIN_WHOLE_BLOCK=1` (`models/swin.py:346-369`). The fixture below sets
both for this file only, as `tests/test_pallas_swin_block.py:98-125` does,
and runs every Pallas kernel that routing reaches (row 16, the shifted K1
and both epilogues) in interpret mode, as
`tests/test_torch_attn_routes.py:65-90` does for its routes."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu.models import SwinTemporalStack as JStack  # noqa: E402
from stswincl_tpu.ops import pallas_swin_block as jwb  # noqa: E402
from stswincl_tpu.ops.window import relative_position_index  # noqa: E402
from stswincl_tpu.pipelines import common as jcommon  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax, state_dict_from_jax  # noqa: E402
from stswincl_tpu_torch.models import SwinTemporalStack  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock  # noqa: E402
from stswincl_tpu_torch.ops import swin_block  # noqa: E402
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from tests.test_torch_train import check_train_step_matches_jax  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

# Row 16's twin and its backward against the interpreted kernel and its
# custom VJP, fp32: the same formula in another summation order,
# ||port - jax|| / ||jax|| <= 1e-4 for the output and every gradient.
OP_TOL = 1e-4
# The stacks, fp32 on both sides with the same GELU polynomial, as
# `tests/test_torch_swin.py` holds the 'pallas_full' route: 1e-4.
STACK_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture
def jax_whole_block(monkeypatch):
    """The JAX package routed as on the TPU with `STSWIN_WHOLE_BLOCK=1`,
    its Pallas kernels interpreted; yields the list the row-16 kernel
    appends to on each call."""
    import stswincl_tpu.ops.pallas_add_ln_mlp as palm
    import stswincl_tpu.ops.pallas_attention as pa
    import stswincl_tpu.ops.pallas_block_attention as pba

    monkeypatch.setattr(pa, "_is_tpu_backend", lambda: True)
    monkeypatch.setenv("STSWIN_WHOLE_BLOCK", "1")
    calls = []
    whole = jwb.fused_whole_swin_block

    def interp(*a):
        calls.append(1)
        # the model passes 15 tensors, heads, scale, ws, gelu_exact
        return whole(*a[:19], 1e-5, True)
    monkeypatch.setattr(jwb, "fused_whole_swin_block", interp)
    attn = pba.fused_swin_block_attention
    monkeypatch.setattr(pba, "fused_swin_block_attention",
                        lambda *a, **kw: attn(*a[:11], True))
    epi = palm.fused_swin_block_epilogue
    monkeypatch.setattr(palm, "fused_swin_block_epilogue",
                        lambda *a, **kw: epi(*a[:11], 1e-5, True))
    epis = palm.fused_swin_block_epilogue_shifted
    monkeypatch.setattr(palm, "fused_swin_block_epilogue_shifted",
                        lambda *a, **kw: epis(*a[:13], 1e-5, True))
    yield calls


def _row16_case(rng, B=2, T=2, H=8, W=16, C=32, heads=2, ws=4):
    """Row 16's inputs in the JAX layout ((in, out) weights), fp32."""
    N, TN, hidden = ws * ws, T * ws * ws, 4 * C
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    table = f((2 * ws - 1) ** 2, heads, k=0.5)
    bias = table[relative_position_index(ws, ws).reshape(-1)].reshape(
        N, N, heads).transpose(2, 0, 1)
    return [f(B, T, H, W, C), f(C, 3 * C, k=0.1), f(3 * C, k=0.1),
            f(C, C, k=0.1), f(C, k=0.1), np.tile(bias, (1, T, T)),
            np.zeros((1, TN, TN), np.float32), f(C, k=0.1) + 1.0, f(C, k=0.1),
            f(C, hidden, k=0.1), f(hidden, k=0.1), f(hidden, C, k=0.1),
            f(C, k=0.1), f(C, k=0.1) + 1.0, f(C, k=0.1)], \
        (heads, (C // heads) ** -0.5, ws)


_MATRICES = (1, 3, 9, 11)  # wqkv, wproj, w1, w2: transposed between layouts


def test_row16_twin_and_backward_match_jax(rng):
    """The twin (autograd) and `WholeBlockFn` (its backward: the pair's
    Functions on their CPU twins), against the interpreted kernel and
    `jax.grad` through its custom VJP."""
    args, cfg = _row16_case(rng)
    G = rng.standard_normal(args[0].shape).astype(np.float32)
    diff = [i for i in range(15) if i != 6]  # the mask takes no gradient

    def jloss(*a):
        out = jwb.fused_whole_swin_block(*a, *cfg, True, 1e-5, True)
        return jnp.sum(out * G), out
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(diff),
                                           has_aux=True)(
        *map(jnp.asarray, args))

    torch_args = [T_(np.ascontiguousarray(a.T)) if i in _MATRICES else T_(a)
                  for i, a in enumerate(args)]
    for fn in (swin_block.whole_swin_block, swin_block.whole_swin_block_ref):
        leaves = [t.clone().requires_grad_() for t in torch_args]
        out = fn(*leaves, *cfg)
        (out * T_(G)).sum().backward()
        assert _rel(out.detach(), want) <= OP_TOL, fn.__name__
        for i, jg in zip(diff, jgrads):
            got = leaves[i].grad.numpy()
            assert _rel(got.T if i in _MATRICES else got, jg) <= OP_TOL, \
                (fn.__name__, i)
    with torch.no_grad():  # the forward without the autograd Function
        plain = swin_block.whole_swin_block(*torch_args, *cfg)
    assert _rel(plain, want) <= OP_TOL
    mask = torch_args[6]
    with torch.no_grad():  # None and the W-MSA zero marker are one case
        no_mask = swin_block.whole_swin_block(*torch_args[:6], None,
                                              *torch_args[7:], *cfg)
    torch.testing.assert_close(no_mask, plain, rtol=0, atol=0)
    assert mask.shape[0] == 1


RES, DIM, HEADS = (16, 24), 32, 4


@pytest.fixture(scope="module")
def stack_case():
    x = np.random.default_rng(0).standard_normal(
        (2, 5, *RES, DIM)).astype(np.float32)
    stack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                   attn_impl="einsum")
    variables = jax.jit(stack.init)(jax.random.key(0), jnp.asarray(x[:, :4]))
    return x, variables


_JAX_STACK = {}  # mode -> the JAX stack's outputs, shared by both port paths


def _jax_stack_outputs(mode, x, variables, calls):
    """The JAX stack's outputs in `mode`, under `jax_whole_block` (whose
    row-16 calls land in `calls`); for 'layer0_cached' also, last, the
    `layer0_only` output it was fed."""
    if mode not in _JAX_STACK:
        jstack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                        attn_impl="pallas_full",
                        final_pair_only=mode != "full")
        xj = jnp.asarray(x)
        if mode == "layer0_only":
            out = [jstack.apply(variables, xj[:, 1:3], layer0_only=True)]
        elif mode == "layer0_cached":
            g_a = jstack.apply(variables, xj[:, 1:3], layer0_only=True)
            out = list(jstack.apply(variables, xj[:, 1:5],
                                    layer0_cached=g_a)) + [g_a]
        else:
            out = list(jstack.apply(variables, xj[:, :4]))
        assert calls, "the JAX stack did not take row 16"
        _JAX_STACK[mode] = [np.array(o) for o in out]
    return _JAX_STACK[mode]


@pytest.mark.parametrize("mode", ["full", "final_pair_only", "layer0_only",
                                  "layer0_cached"])
@pytest.mark.parametrize("kernels", [None, True], ids=["twin", "function"])
def test_whole_block_stack_matches_jax(stack_case, jax_whole_block, mode,
                                       kernels):
    """A `whole_block` stack against the JAX stack on its TPU routing with
    `STSWIN_WHOLE_BLOCK=1`, in each streaming mode; the port through its
    twins (`kernels` None on the CPU) and through the autograd Functions'
    CPU forms (`kernels=True`, with a gradient asked for)."""
    x, variables = stack_case
    lean = mode != "full"
    port = SwinTemporalStack(DIM, RES, HEADS, final_pair_only=lean,
                             kernels=kernels, whole_block=True)
    load_from_jax(port, variables)
    want = _jax_stack_outputs(mode, x, variables, jax_whole_block)
    xt = T_(x)
    grad = torch.enable_grad() if kernels else torch.no_grad()
    with grad:
        if mode == "layer0_only":
            got = [port(xt[:, 1:3], layer0_only=True)]
        elif mode == "layer0_cached":
            got = port(xt[:, 1:5], layer0_cached=T_(want[3]))
        else:
            got = port(xt[:, :4])
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w).reshape(g.shape)
        if lean and g.ndim == 5 and g.shape[-1] == 2 * DIM:
            g, w = g[:, -1], w[:, -1]  # stage 2: only the last frame lives
        np.testing.assert_allclose(g, w, rtol=STACK_TOL, atol=STACK_TOL)


def test_whole_block_train_step_matches_jax(jax_whole_block):
    """One stage-1 step with the W-MSA blocks on row 16, on both sides:
    the port through `WholeBlockFn` and the K1 / K2 Functions
    (`kernels=True`; their CPU forms), JAX through the interpreted
    kernels and their custom VJPs; the bounds of
    `tests/test_torch_train.py`."""
    check_train_step_matches_jax("pallas_full", kernels=True,
                                 whole_block=True)
    assert jax_whole_block


def test_whole_block_variables_load_without_leftovers(jax_whole_block):
    """The JAX variable tree of the whole-block routing (its W blocks
    declare their parameters through `raw_params`, `_NormParams` and
    `_MlpParams`) places every leaf in the port's model."""
    HW = (128, 128)
    model_cfg = ModelConfig(num_classes=5, swin_dim=64, swin_depths=(1, 1),
                            attn_impl="pallas_full", dtype="float32")
    data_cfg = DataConfig(dataset="synthetic", crop_hw=HW)
    jm, _ = jcommon.build_model(model_cfg, data_cfg)
    variables = jax.eval_shape(functools.partial(jm.init, train=False),
                               jax.random.key(0),
                               jnp.zeros((1, 4, *HW, 3), jnp.float32))
    assert jax_whole_block, "the JAX model did not take row 16"
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables)
    port, _ = build_model(model_cfg, data_cfg, device="cpu")
    sd, unmatched = state_dict_from_jax(variables, port)
    assert unmatched == []
    assert set(sd) == set(port.state_dict())


def test_whole_block_routing(monkeypatch):
    """Row 16 takes a block only with `whole_block`, shift 0, no
    `out_frame`, on 'pallas_full'; every other block keeps its route."""
    x = torch.randn(1, 2, *RES, DIM)
    calls = []
    forward = swin_block._forward
    monkeypatch.setattr(swin_block, "_forward",
                        lambda *a: calls.append(1) or forward(*a))
    for impl, shift, whole, out_frame, taken in (
            ("pallas_full", 0, True, None, True),
            ("auto", 0, True, None, True),
            ("pallas_full", 0, False, None, False),
            ("pallas_full", 4, True, None, False),
            ("pallas_full", 0, True, 1, False),
            ("pallas", 0, True, None, False)):
        blk = init_weights(
            SpaceTimeSwinBlock(DIM, RES, HEADS, 8, shift, kernels=True,
                               attn_impl=impl, whole_block=whole),
            torch.Generator().manual_seed(0))
        calls.clear()
        with torch.no_grad():
            out = blk(x, out_frame)
        assert bool(calls) == taken, (impl, shift, whole, out_frame)
        assert out.shape == (1, 2 if out_frame is None else 1, *RES, DIM)
