"""The four kernel modules of the port (K1-K4): each plain twin against the
JAX reference and against the Pallas kernel run in interpret mode, fp32 on
the CPU; and the wrappers' CPU route. The CUDA kernels themselves are
tested on a card by `tests/test_torch_cuda.py`."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import pallas_add_ln_mlp as jepi  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jattn  # noqa: E402
from stswincl_tpu.ops import pallas_patch_merge as jpm  # noqa: E402
from stswincl_tpu.ops import pallas_upsample_argmax as jua  # noqa: E402
from stswincl_tpu.ops import resize as jresize  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu_torch.ops import add_ln_mlp, block_attention  # noqa: E402
from stswincl_tpu_torch.ops import patch_merge, upsample_argmax  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy


def _attn_case(rng, shift, B=2, T=2, H=8, W=12, C=32, heads=2, ws=4):
    """Inputs in the JAX layout (dense kernels (in, out))."""
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    N, TN = ws * ws, T * ws * ws
    table = f((2 * ws - 1) ** 2, heads, k=0.02)
    idx = relative_position_index(ws, ws)
    bias = np.tile(table[idx.reshape(-1)].reshape(N, N, heads)
                   .transpose(2, 0, 1), (1, T, T))
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, shift), (1, T, T))
            if shift else None)
    return dict(x=f(B, T, H, W, C), wqkv=f(C, 3 * C, k=0.1),
                bqkv=f(3 * C, k=0.1), wproj=f(C, C, k=0.1),
                bproj=f(C, k=0.1), bias=bias, mask=mask, heads=heads,
                scale=(C // heads) ** -0.5, ws=ws, shift=shift, TN=TN)


def _attn_port(c, fn):
    return fn(T_(c["x"]), T_(c["wqkv"].T.copy()), T_(c["bqkv"]),
              T_(c["wproj"].T.copy()), T_(c["bproj"]), T_(c["bias"]),
              None if c["mask"] is None else T_(c["mask"]), c["heads"],
              c["scale"], c["ws"], c["shift"]).numpy()


@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_twin_matches_jax(rng, shift):
    c = _attn_case(rng, shift)
    mask = (jnp.zeros((1, c["TN"], c["TN"]), jnp.float32)
            if c["mask"] is None else jnp.asarray(c["mask"]))
    jargs = tuple(jnp.asarray(c[k]) for k in
                  ("x", "wqkv", "bqkv", "wproj", "bproj", "bias"))
    want_ref = jattn.fused_swin_block_attention_ref(
        *jargs, mask, c["heads"], c["scale"], c["ws"], shift)
    want_pallas = jattn.fused_swin_block_attention(
        *jargs, mask, c["heads"], c["scale"], c["ws"], shift, True)
    got = _attn_port(c, block_attention.swin_block_attention_ref)
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=1e-5,
                               atol=1e-5)


def _epi_case(rng, C=64, hidden=256):
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(
        np.float32)
    return (f(C, k=0.1, o=1.0), f(C, k=0.1), f(C, hidden, k=0.05),
            f(hidden, k=0.05), f(hidden, C, k=0.05), f(C, k=0.05),
            f(C, k=0.1, o=1.0), f(C, k=0.1))


def _epi_port(x, y, p, exact, shift=0, ws=None, fn=None):
    s2, b2, w1, b1, w2, bw2, s1, b1n = (T_(np.ascontiguousarray(a))
                                         for a in p)
    fn = fn or add_ln_mlp.swin_block_epilogue_ref
    return fn(T_(x), T_(y), s2, b2, w1.T.contiguous(), b1, w2.T.contiguous(),
              bw2, s1, b1n, gelu_exact=exact, shift=shift, ws=ws).numpy()


@pytest.mark.parametrize("exact", [True, False])
def test_epilogue_twin_matches_jax(rng, exact):
    p = _epi_case(rng)
    x, y = (rng.standard_normal((2, 96, 64)).astype(np.float32)
            for _ in range(2))
    jp = tuple(jnp.asarray(a) for a in p)
    want_ref = jepi.swin_block_epilogue_ref(jnp.asarray(x), jnp.asarray(y),
                                            *jp, exact)
    want_pallas = jepi.fused_swin_block_epilogue(
        jnp.asarray(x), jnp.asarray(y), *jp, exact, 1e-5, True)
    got = _epi_port(x, y, p, exact)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("T", [2, 1])
def test_epilogue_shifted_twin_matches_jax(rng, T):
    """The SW-block epilogue reads y through the inverse cyclic shift; the
    T=1 case is the `final_pair_only` frame slice."""
    p = _epi_case(rng, C=32, hidden=128)
    x, y = (rng.standard_normal((2, T, 8, 12, 32)).astype(np.float32)
            for _ in range(2))
    jp = tuple(jnp.asarray(a) for a in p)
    want_ref = jepi.swin_block_epilogue_shifted_ref(
        jnp.asarray(x), jnp.asarray(y), *jp, 2, True)
    want_pallas = jepi.fused_swin_block_epilogue_shifted(
        jnp.asarray(x), jnp.asarray(y), *jp, 2, 4, True, 1e-5, True)
    got = _epi_port(x, y, p, True, shift=2, ws=4)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_patch_merge_twin_matches_jax(rng):
    C = 32
    x = rng.standard_normal((3, 8, 12, C)).astype(np.float32)
    s = (rng.standard_normal(4 * C) * 0.1 + 1.0).astype(np.float32)
    b = (rng.standard_normal(4 * C) * 0.1).astype(np.float32)
    w = (rng.standard_normal((4 * C, 2 * C)) * 0.05).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (x, s, b, w))
    got = patch_merge.patch_merge_ref(T_(x), T_(s), T_(b),
                                      T_(w.T.copy())).numpy()
    assert got.shape == (3, 4, 6, 2 * C)
    for want in (jpm.patch_merge_ref(*jargs),
                 jpm.fused_patch_merge(*jargs, 1e-5, True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _ua_case(rng, planes=None):
    x = (rng.standard_normal((2, 5, 16, 24)).astype(np.float32)
         if planes is None else planes)
    h, w = x.shape[2:]  # head res -> 2x model upsample -> eval resize
    mh = np.asarray(jresize._align_corners_matrix(2 * h, 32)
                    @ jresize._half_pixel_matrix(h, 2 * h))
    mw = np.asarray(jresize._align_corners_matrix(2 * w, 48)
                    @ jresize._half_pixel_matrix(w, 2 * w))
    return x, mh.astype(np.float32), mw.astype(np.float32)


@pytest.mark.parametrize("exact", [True, False])
def test_upsample_argmax_twin_matches_jax(rng, exact):
    """exact: equal to the JAX einsum branch and to the Pallas kernel's
    fp32 mode on every pixel; bf16: equal to the Pallas kernel's bf16
    matmul inputs on every pixel."""
    x, mh, mw = _ua_case(rng)
    got = upsample_argmax.upsample_argmax_ref(T_(x), T_(mh), T_(mw), exact)
    assert got.dtype == torch.int32 and got.shape == (2, 32, 48)
    want = jua.upsample_argmax_pallas(jnp.asarray(x), jnp.asarray(mh),
                                      jnp.asarray(mw), interpret=True,
                                      exact=exact)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if exact:
        y = jnp.einsum("pw,bcow->bcop", jnp.asarray(mw),
                       jnp.einsum("oh,bchw->bcow", jnp.asarray(mh),
                                  jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.argmax(y, axis=1)))


@pytest.mark.parametrize("exact", [True, False])
def test_upsample_argmax_ties_take_first_class(rng, exact):
    plane = rng.standard_normal((1, 1, 8, 16)).astype(np.float32)
    low = plane - 1.0
    x, mh, mw = _ua_case(rng, np.concatenate([low, plane, plane], axis=1))
    got = upsample_argmax.upsample_argmax(T_(x), T_(mh), T_(mw), exact)
    assert (got.numpy() == 1).all()


def test_wrappers_run_their_twin_on_cpu_without_counting(rng):
    """On a CPU tensor each wrapper returns its twin's result and leaves
    its launch count alone (the count is of kernel launches)."""
    c = _attn_case(rng, 2)
    before = block_attention.swin_block_attention.launches
    np.testing.assert_array_equal(
        _attn_port(c, block_attention.swin_block_attention),
        _attn_port(c, block_attention.swin_block_attention_ref))
    assert block_attention.swin_block_attention.launches == before

    p = _epi_case(rng, C=32, hidden=128)
    x, y = (rng.standard_normal((1, 2, 8, 12, 32)).astype(np.float32)
            for _ in range(2))
    before = add_ln_mlp.swin_block_epilogue.launches
    np.testing.assert_array_equal(
        _epi_port(x, y, p, True, 2, 4, add_ln_mlp.swin_block_epilogue),
        _epi_port(x, y, p, True, 2, 4))
    assert add_ln_mlp.swin_block_epilogue.launches == before

    xm = T_(rng.standard_normal((1, 4, 6, 8)).astype(np.float32))
    pm = (torch.ones(32), torch.zeros(32), torch.ones(16, 32) * 0.1)
    before = patch_merge.patch_merge.launches
    torch.testing.assert_close(patch_merge.patch_merge(xm, *pm),
                               patch_merge.patch_merge_ref(xm, *pm),
                               rtol=0, atol=0)
    assert patch_merge.patch_merge.launches == before

    x, mh, mw = _ua_case(rng)
    before = upsample_argmax.upsample_argmax.launches
    torch.testing.assert_close(
        upsample_argmax.upsample_argmax(T_(x), T_(mh), T_(mw), True),
        upsample_argmax.upsample_argmax_ref(T_(x), T_(mh), T_(mw), True))
    assert upsample_argmax.upsample_argmax.launches == before
