"""Row 16 (`whole_block=True`) at every shape K1 + K2 take, against the
JAX package on the CPU: the row-16 twin (`whole_swin_block` on CPU
tensors, through `WholeBlockFn` when a gradient is asked for: its backward
runs the pair's twins) forward and backward against the interpreted
`fused_whole_swin_block` and its custom VJP, at channel widths off 128
and past 1024 (C 32, 96, 1280, 2560 over 4 heads: hd 8, 24, 320, 640),
hidden 4C, and windows that do not tile 128 rows (TN 48: T 3, ws 4) or
pass them (TN 144: T 4, ws 6; TN 176: T 11, ws 4), in fp32 and bf16; and
a `whole_block` stack at `swin_dim` 96 against the JAX stack on its TPU
routing with `STSWIN_WHOLE_BLOCK=1` (`test_torch_whole_block.py`'s
`jax_whole_block` fixture).

Tolerances, ||port - jax|| / ||jax|| for the output and every gradient:
fp32 1e-4, as `test_torch_whole_block.py` holds row 16 (the same formula
summed in another order); bf16 BF16_REL 1e-2: both sides round q, k, v,
P, each head's output, y, LN2(s), h and m to bf16 at the same points from
fp32 sums taken in other orders, so an element may sit one bf16 step
(2^-8 relative) off and carry it into the next product, as
`test_torch_widths.py` bounds K1 + K2; the backward runs autograd of
XLA's bf16 reference on the JAX side (its custom VJP in interpret mode)
against the port's K5 and K6 twins. The largest seen on these cases is
4.2e-3 (dbqkv at C 1280). The JAX side runs under `jax.jit`: op by op,
its interpreter's first call at each shape and dtype took 5-9 s."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import SwinTemporalStack as JStack  # noqa: E402
from stswincl_tpu.ops import pallas_swin_block as jwb  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.models import SwinTemporalStack  # noqa: E402
from stswincl_tpu_torch.ops import swin_block  # noqa: E402
from tests.test_torch_whole_block import (  # noqa: E402,F401
    _MATRICES, _row16_case, jax_whole_block)

torch.set_num_threads(1)
T_ = torch.from_numpy

OP_TOL = 1e-4
BF16_REL = 1e-2
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

# label -> (B, T, H, W, C, heads, ws): one or two windows each
CASES = {
    "C32 hd8 TN48": (1, 3, 8, 8, 32, 4, 4),
    "C96 hd24 TN144": (1, 4, 6, 12, 96, 4, 6),
    "C1280 hd320 TN176": (1, 11, 4, 4, 1280, 4, 4),
    "C2560 hd640 TN48": (1, 3, 4, 4, 2560, 4, 4),
}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_row16_twin_and_backward_match_jax(case, dtype):
    """`whole_swin_block` on CPU tensors (`WholeBlockFn`: the twin forward,
    the pair's twins backward) against the interpreted row-16 kernel and
    `jax.grad` through its custom VJP; x and the four matrices in the
    dtype, the vectors fp32; the plan takes the shape in both forms."""
    B, T, H, W, C, heads, ws = CASES[case]
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sorted(CASES).index(case))
    args, cfg = _row16_case(rng, B, T, H, W, C, heads, ws)
    for i in (0, *_MATRICES):  # values both packages hold in the dtype
        args[i] = T_(args[i]).to(tdt).float().numpy()
    G = rng.standard_normal(args[0].shape).astype(np.float32)
    G = T_(G).to(tdt).float().numpy()
    diff = [i for i in range(15) if i != 6]  # the mask takes no gradient
    for dt in (torch.bfloat16, torch.float32):
        plan = swin_block.whole_block_plan(B, T, H, W, C, 4 * C, heads, ws,
                                           dt)
        assert plan.window_tokens == T * ws * ws

    jargs = [jnp.asarray(a, jdt) if i in (0, *_MATRICES) else jnp.asarray(a)
             for i, a in enumerate(args)]

    def jloss(*a):
        out = jwb.fused_whole_swin_block(*a, *cfg, True, 1e-5, True)
        return jnp.sum(out.astype(jnp.float32) * G), out
    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(diff), has_aux=True))(*jargs)

    leaves = [T_(np.ascontiguousarray(a.T) if i in _MATRICES else a)
              for i, a in enumerate(args)]
    leaves = [t.to(tdt) if i in (0, *_MATRICES) else t
              for i, t in enumerate(leaves)]
    leaves = [t.requires_grad_() for t in leaves]
    out = swin_block.whole_swin_block(*leaves, *cfg)
    assert out.dtype == tdt and out.shape == leaves[0].shape
    (out.float() * T_(G)).sum().backward()
    bound = OP_TOL if dtype == "fp32" else BF16_REL
    assert _rel(_np(out), _np(want)) <= bound, _rel(_np(out), _np(want))
    for i, jg in zip(diff, jgrads):
        got = _np(leaves[i].grad)
        rel = _rel(got.T if i in _MATRICES else got, _np(jg))
        assert rel <= bound, (i, rel)


RES, DIM, HEADS = (16, 24), 96, 4  # swin_dim 96's stage 1: hd 24, TN 128
_JAX_STACK = {}  # the JAX stack's input, variables and outputs


def _jax_stack(calls):
    """x, the JAX variables and the JAX stack's outputs (computed once, under
    `jax_whole_block`, whose row-16 calls land in `calls`)."""
    if not _JAX_STACK:
        x = np.random.default_rng(0).standard_normal(
            (2, 4, *RES, DIM)).astype(np.float32)
        stack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                       attn_impl="einsum")
        variables = jax.jit(stack.init)(jax.random.key(0), jnp.asarray(x))
        jstack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                        attn_impl="pallas_full")
        out = jax.jit(jstack.apply)(variables, jnp.asarray(x))
        assert calls, "the JAX stack did not take row 16"
        _JAX_STACK.update(x=x, variables=variables,
                          want=[np.array(o) for o in out])
    return _JAX_STACK["x"], _JAX_STACK["variables"], _JAX_STACK["want"]


@pytest.mark.parametrize("kernels", [None, True], ids=["twin", "function"])
def test_whole_block_stack_at_swin_dim_96_matches_jax(jax_whole_block,
                                                      kernels):
    """A `whole_block` stack at C 96 over 4 heads (hd 24, windows of 8 x 8
    x 2) against the JAX stack on its TPU routing with
    `STSWIN_WHOLE_BLOCK=1`, row 16 interpreted, fp32: the port through its
    twins (`kernels` None on the CPU) and through the autograd Functions'
    CPU forms (`kernels=True`, a gradient asked for). Row 16's plan takes
    the stack's W-MSA blocks in both forms."""
    x, variables, want = _jax_stack(jax_whole_block)
    for dt in (torch.bfloat16, torch.float32):
        swin_block.whole_block_plan(2, 2, *RES, DIM, 4 * DIM, HEADS, 8, dt)
    port = SwinTemporalStack(DIM, RES, HEADS, kernels=kernels,
                             whole_block=True)
    load_from_jax(port, variables)
    grad = torch.enable_grad() if kernels else torch.no_grad()
    with grad:
        got = port(T_(x))
    if kernels:
        sum(g.sum() for g in got).backward()
        assert all(p.grad is not None for p in port.parameters())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) <= OP_TOL
