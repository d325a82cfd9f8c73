"""Port ops (plain PyTorch) against the JAX package, fp32 on the CPU:
window constants, cyclic shift, window attention, the GELU polynomial
and the resize matrices."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import attention as jattn  # noqa: E402
from stswincl_tpu.ops import pallas_mlp as jmlp  # noqa: E402
from stswincl_tpu.ops import resize as jresize  # noqa: E402
from stswincl_tpu.ops import window as jwin  # noqa: E402
from stswincl_tpu_torch.ops import attention, mlp, resize, window  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("H,W,ws,ss", [(16, 24, 8, 4), (8, 12, 4, 2),
                                       (64, 80, 8, 4), (32, 40, 4, 2)])
def test_window_constants_match_jax(H, W, ws, ss):
    np.testing.assert_array_equal(window.relative_position_index(ws, ws),
                                  jwin.relative_position_index(ws, ws))
    np.testing.assert_array_equal(
        window.shifted_window_attention_mask(H, W, ws, ss),
        jwin.shifted_window_attention_mask(H, W, ws, ss))


@pytest.mark.parametrize("reverse", [False, True])
def test_cyclic_shift_matches_jax(rng, reverse):
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = window.cyclic_shift(torch.from_numpy(x), 2, reverse).numpy()
    want = np.asarray(jwin.cyclic_shift(jnp.asarray(x), 2, reverse))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_space_time_window_attention_matches_jax(rng, with_mask):
    # 2 images x 2 windows of a 4x8 map, ws 4, T 2, 2 heads of 8
    Bw, heads, N, T, hd = 4, 2, 16, 2, 8
    q, k, v = (rng.standard_normal((Bw, heads, T * N, hd)).astype(np.float32)
               for _ in range(3))
    rel = (rng.standard_normal((heads, N, N)) * 0.02).astype(np.float32)
    mask = (jwin.shifted_window_attention_mask(4, 8, 4, 2)
            if with_mask else None)
    got = attention.space_time_window_attention(
        *(torch.from_numpy(a) for a in (q, k, v, rel)),
        None if mask is None else torch.from_numpy(mask), hd ** -0.5)
    want = jattn.space_time_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, rel)),
        None if mask is None else jnp.asarray(mask), hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
def test_gelu_matches_jax_kernel_gelu(monkeypatch, exact):
    monkeypatch.delenv("STSWIN_FAST_ERF", raising=False)  # the default
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    np.testing.assert_allclose(
        mlp.erf_poly_fast(torch.from_numpy(x)).numpy(),
        np.asarray(jmlp._erf_poly_fast(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mlp.gelu(torch.from_numpy(x), exact).numpy(),
        np.asarray(jmlp._gelu(jnp.asarray(x), exact)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(8, 32), (16, 40), (64, 512),
                                        (80, 640), (512, 1024), (5, 1)])
def test_resize_matrices_match_jax(n_in, n_out):
    np.testing.assert_allclose(
        resize._half_pixel_matrix(n_in, n_out).numpy(),
        np.asarray(jresize._half_pixel_matrix(n_in, n_out)), atol=1e-7)
    np.testing.assert_allclose(
        resize._align_corners_matrix(n_in, n_out).numpy(),
        np.asarray(jresize._align_corners_matrix(n_in, n_out)), atol=1e-7)


def test_resize_bilinear_matches_jax(rng):
    x = rng.standard_normal((2, 8, 10, 5)).astype(np.float32)
    got = resize.resize_bilinear(torch.from_numpy(x), 16, 20).numpy()
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), 16, 20))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("align_out,out_hw", [(True, (96, 160)),
                                              (False, (68, 120))])
def test_composed_upsample_argmax_matches_jax(rng, align_out, out_hw):
    lcf = rng.standard_normal((2, 5, 8, 10)).astype(np.float32)
    got = resize.composed_upsample_argmax_cf(
        torch.from_numpy(lcf), (64, 80), out_hw, align_out=align_out,
        exact=True)
    want = jresize.composed_upsample_argmax_cf(
        jnp.asarray(lcf), (64, 80), out_hw, align_out=align_out, exact=True)
    assert got.dtype == torch.int32 and got.shape == (2, *out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
