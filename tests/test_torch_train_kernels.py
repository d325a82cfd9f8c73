"""The backward kernels' plain twins (K5 for Pallas row 6, K6 for rows 7
and 9, K2's m output for row 8) against the JAX package's Pallas kernels
run in interpret mode, fp32 on the CPU; and each autograd Function of the
port (attention, epilogue, patch merge) on a CPU tensor against autograd
through its forward twin. The CUDA kernels themselves are held against
the twins on a card by `tests/test_torch_cuda.py`.

Tolerances: rtol = atol = 2e-4 against the Pallas kernels, as the JAX
package's own tests hold those kernels against their references (fp32
sums in another order; the same erf polynomial and its derivative on
both sides). The Functions run the twins themselves on the CPU, so they
must agree to fp32 rounding (1e-6).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import pallas_add_ln_mlp as jepi  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jattn  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ops import add_ln_mlp, block_attention  # noqa: E402
from stswincl_tpu_torch.ops import patch_merge  # noqa: E402
from stswincl_tpu_torch.ops.attention import MAX_WINDOW_TOKENS  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy
TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _attn_case(rng, shift, B=2, T=2, H=8, W=12, C=32, heads=2, ws=4):
    """Inputs in the JAX layout (dense kernels (in, out)) plus the output
    gradient g."""
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    N, TN = ws * ws, T * ws * ws
    table = f((2 * ws - 1) ** 2, heads, k=0.1)
    idx = relative_position_index(ws, ws)
    bias = np.tile(table[idx.reshape(-1)].reshape(N, N, heads)
                   .transpose(2, 0, 1), (1, T, T))
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, shift), (1, T, T))
            if shift else None)
    return dict(x=f(B, T, H, W, C, k=0.3), g=f(B, T, H, W, C, k=0.3),
                wqkv=f(C, 3 * C, k=0.1), bqkv=f(3 * C, k=0.1),
                wproj=f(C, C, k=0.1), bproj=f(C, k=0.1), bias=bias,
                mask=mask, heads=heads, scale=(C // heads) ** -0.5, ws=ws,
                shift=shift, TN=TN)


def _attn_port_args(c):
    return (T_(c["x"]), T_(c["wqkv"].T.copy()), T_(c["bqkv"]),
            T_(c["wproj"].T.copy()), T_(c["bproj"]), T_(c["bias"]),
            None if c["mask"] is None else T_(c["mask"]))


@pytest.mark.parametrize("shift", [0, 2])
def test_attention_bwd_twin_matches_pallas(rng, shift):
    """K5's twin == `fused_swin_block_attention_bwd` (interpret) routed as
    `_fsba_bwd` routes it: x rolled into the shifted layout first, dx
    rolled back; shift 0 is the W-MSA (no mask) case, shift 2 the SW-MSA
    (per-window mask) case."""
    c = _attn_case(rng, shift)
    mask = (jnp.zeros((1, c["TN"], c["TN"]), jnp.float32)
            if c["mask"] is None else jnp.asarray(c["mask"]))
    xs = jnp.roll(jnp.asarray(c["x"]), (-shift, -shift), axis=(2, 3))
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = \
        jattn.fused_swin_block_attention_bwd(
            xs, jnp.asarray(c["wqkv"]), jnp.asarray(c["bqkv"]),
            jnp.asarray(c["wproj"]), jnp.asarray(c["bias"]), mask,
            jnp.asarray(c["g"]), c["heads"], c["scale"], c["ws"],
            interpret=True)
    dx = jnp.roll(dx, (shift, shift), axis=(2, 3))
    got = block_attention.swin_block_attention_bwd_ref(
        *_attn_port_args(c), T_(c["g"]), c["heads"], c["scale"], c["ws"],
        shift)
    want = (dx, np.asarray(dwqkv).T, dbqkv, np.asarray(dwproj).T, dbproj,
            dbias)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                           "dbias"), got, want):
        _close(a.numpy(), b, f"{name} (shift={shift})")


def _epi_case(rng, lead, C=32):
    hidden = 4 * C
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(
        np.float32)
    return dict(x=f(*lead, C), y=f(*lead, C), g=f(*lead, C),
                s2=f(C, k=0.1, o=1.0), b2=f(C, k=0.1),
                w1=f(C, hidden, k=0.1), b1=f(hidden, k=0.1),
                w2=f(hidden, C, k=0.1), bw2=f(C, k=0.1),
                s1=f(C, k=0.1, o=1.0), b1n=f(C, k=0.1))


PARAMS = ("s2", "b2", "w1", "b1", "w2", "bw2", "s1", "b1n")


def _epi_port(c):
    """(x, y, params...) as torch tensors in the port's layout."""
    return [T_(c["x"]), T_(c["y"])] + [
        T_(np.ascontiguousarray(c[k].T if k in ("w1", "w2") else c[k]))
        for k in PARAMS]


def _epi_jax(c, *keys):
    return [jnp.asarray(c[k]) for k in keys]


def _compare_epi_grads(got, ds, dy, jgrads):
    """got: the port twin's (dx, dy, ds2, db2, dw1, db1, dw2, dbw2, ds1,
    db1n); jgrads: the Pallas kernels' (ds2, db2, dw1, db1, dw2, dbw2, ds1,
    db1n), dense weights in the JAX layout."""
    _close(got[0].numpy(), ds, "dx")
    _close(got[1].numpy(), dy, "dy")
    for name, a, b in zip(PARAMS, got[2:], jgrads):
        b = np.asarray(b)
        _close(a.numpy(), b.T if name in ("w1", "w2") else b, name)


@pytest.mark.parametrize("shift", [0, 2])
def test_epilogue_bwd_twin_matches_pallas(rng, shift):
    """K6's twin without m == `fused_epilogue_bwd` (interpret, Pallas
    row 7), routed as `_epis_bwd` routes the shifted case: y rolled back
    before the kernel, its gradient rolled into the shifted layout after."""
    lead = (2, 2, 8, 12) if shift else (48,)
    c = _epi_case(rng, lead)
    x, y, g = _epi_jax(c, "x", "y", "g")
    y_un = jnp.roll(y, (shift, shift), axis=(2, 3)) if shift else y
    s2, b2, w1, b1, w2, bw2, s1 = _epi_jax(c, *PARAMS[:7])
    ds, ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n = jepi.fused_epilogue_bwd(
        x, y_un, s2, b2, w1, b1, w2, bw2, s1, g, True, 1e-5, True)
    dy = jnp.roll(ds, (-shift, -shift), axis=(2, 3)) if shift else ds
    got = add_ln_mlp.swin_block_epilogue_bwd_ref(
        *_epi_port(c), T_(c["g"]), True, shift, 4 if shift else None)
    _compare_epi_grads(got, ds, dy,
                       (ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n))


def test_epilogue_with_m_twins_match_pallas(rng):
    """The m-forward twin == `_fused_epilogue_fwd_with_m` (interpret,
    Pallas row 8) for the output and m; K6's twin given that m ==
    `fused_epilogue_bwd_streamed` (interpret, Pallas row 9)."""
    c = _epi_case(rng, (48,))
    jargs = _epi_jax(c, "x", "y", *PARAMS)
    out, m = jepi._fused_epilogue_fwd_with_m(*jargs, True, 1e-5, True)
    got_out, got_m = add_ln_mlp.swin_block_epilogue_with_m_ref(*_epi_port(c))
    _close(got_out.numpy(), out, "out")
    _close(got_m.numpy(), m, "m")
    x, y = jargs[:2]
    ds, ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n = \
        jepi.fused_epilogue_bwd_streamed(x, y, *jargs[2:9],
                                         jnp.asarray(c["g"]), m, True, 1e-5,
                                         2, True)
    got = add_ln_mlp.swin_block_epilogue_bwd_ref(*_epi_port(c), T_(c["g"]))
    _compare_epi_grads(got, ds, ds, (ds2, db2, dw1, db1, dw2, dbw2, ds1, db1n))


FN_TOL = dict(rtol=1e-6, atol=1e-6)


def _grads_both_ways(fn, twin, inputs, rest, g):
    """Gradients of fn(*inputs, *rest) and twin(*inputs, *rest) against g."""
    out = []
    for f in (fn, twin):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out.append(torch.autograd.grad(f(*leaves, *rest), leaves, g))
    return out


@pytest.mark.parametrize("shift", [0, 2])
def test_attention_function_matches_twin_autograd_on_cpu(rng, shift):
    c = _attn_case(rng, shift)
    args = _attn_port_args(c)
    rest = (args[6], c["heads"], c["scale"], c["ws"], shift)
    n = (block_attention.swin_block_attention.launches,
         block_attention.swin_block_attention_bwd.launches)
    got, want = _grads_both_ways(block_attention.swin_block_attention,
                                 block_attention.swin_block_attention_ref,
                                 args[:6], rest, T_(c["g"]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **FN_TOL)
    assert (block_attention.swin_block_attention.launches,
            block_attention.swin_block_attention_bwd.launches) == n


@pytest.mark.parametrize("shift", [0, 2])
def test_epilogue_function_matches_twin_autograd_on_cpu(rng, shift):
    c = _epi_case(rng, (2, 2, 8, 12))
    rest = (True, shift, 4 if shift else None)
    n = (add_ln_mlp.swin_block_epilogue.launches,
         add_ln_mlp.swin_block_epilogue_bwd.launches)
    got, want = _grads_both_ways(add_ln_mlp.swin_block_epilogue,
                                 add_ln_mlp.swin_block_epilogue_ref,
                                 _epi_port(c), rest, T_(c["g"]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **FN_TOL)
    assert (add_ln_mlp.swin_block_epilogue.launches,
            add_ln_mlp.swin_block_epilogue_bwd.launches) == n


def test_patch_merge_function_matches_twin_autograd_on_cpu(rng):
    C = 32
    f = lambda *s, k=1.0, o=0.0: T_((rng.standard_normal(s) * k + o).astype(
        np.float32))
    inputs = (f(3, 8, 12, C), f(4 * C, k=0.1, o=1.0), f(4 * C, k=0.1),
              f(2 * C, 4 * C, k=0.05))
    g = f(3, 4, 6, 2 * C)
    n = patch_merge.patch_merge.launches
    got, want = _grads_both_ways(patch_merge.patch_merge,
                                 patch_merge.patch_merge_ref, inputs, (), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **FN_TOL)
    assert patch_merge.patch_merge.launches == n


def test_backward_routing_predicates():
    """Which windows K5's bf16 attention backward takes: those K1's
    forward takes (`check_backward_window`, which the forward of a trained
    block runs before K1), its one-pass slot kernel where the slot fits
    (`bwd_smem`: q, dO, k / v then P / dS, the fp32 dbias table; at most 8
    key tiles of 16), its two passes elsewhere. Both training windows
    (stage 1 TN 128 x hd 128, stage 2 TN 32 x hd 256) take the slot;
    TN 128 x hd 256 and a window past 8 key tiles (TN 144 x hd 64), which
    K1 takes, now train on the two passes, as do head dims past K1's
    resident pair (TN 128 x hd 304, TN 176 x hd 224, TN 32 x hd 2048: the
    query pass streams k and v); what K1 refuses is refused: an oversize
    window (TN 288) and a head dim off 8; and where the epilogue saves m:
    the JAX package's 20 MiB resident-size line, stage 1 recomputes, stage 2
    saves."""
    limit = kernels.SMEM_LIMIT
    assert block_attention._attn_bwd_smem_bytes(128, 128) <= limit
    assert block_attention._attn_bwd_smem_bytes(32, 256) <= limit
    assert block_attention._attn_bwd_smem_bytes(128, 256) > limit
    slot = block_attention._attn_bwd_slot_takes
    assert slot(128, 128) and slot(32, 256) and slot(128, 144)
    assert not (slot(128, 160) or slot(128, 256) or slot(144, 64))
    check = block_attention.check_backward_window

    def bz(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)
    check("k5", bz(1, 2, 8, 8, 512), 4, 8)    # TN 128, hd 128
    check("k5", bz(1, 2, 4, 4, 1024), 4, 4)   # TN 32, hd 256
    assert 144 <= MAX_WINDOW_TOKENS  # K1's forward takes TN 144
    check("k5", bz(1, 2, 8, 8, 512), 2, 8)    # TN 128, hd 256
    check("k5", bz(1, 1, 12, 12, 128), 2, 12)  # TN 144, hd 64
    check("k5", bz(1, 11, 4, 4, 1664), 8, 4)   # TN 176, hd 208
    check("k5", bz(1, 2, 8, 8, 1152), 4, 8)    # TN 128, hd 288
    check("k5", bz(1, 2, 8, 8, 2432), 8, 8)    # TN 128, hd 304
    check("k5", bz(1, 11, 4, 4, 1792), 8, 4)   # TN 176, hd 224
    check("k5", bz(1, 2, 4, 4, 2048), 1, 4)    # TN 32, hd 2048
    for shape, heads, ws in (((1, 2, 12, 12, 128), 2, 12),  # TN 288
                             ((1, 2, 8, 8, 2440), 8, 8),    # hd 305
                             ((1, 11, 4, 4, 1800), 8, 4)):  # hd 225
        with pytest.raises(ValueError):
            check("k5", bz(*shape), heads, ws)
    x = torch.zeros((1, 2, 12, 12, 128))  # ws 12 below: TN 288
    with pytest.raises(ValueError):
        block_attention.swin_block_attention_bwd(
            x, x, None, None, torch.zeros((384, 128)),
            torch.zeros((128, 128)), torch.zeros((2, 288, 288)), None, 2,
            0.1, 12, 0)
    bf = torch.bfloat16
    assert not add_ln_mlp.mlp_output_saved(512, 2048, bf)
    assert add_ln_mlp.mlp_output_saved(1024, 4096, bf)
    assert not add_ln_mlp.mlp_output_saved(32, 128, torch.float32)
