"""The port's SwinTemporalStack (plain twins, fp32, CPU) against the JAX
stack forced onto its TPU kernel route with interpreted Pallas kernels,
on the same weights; and the port's dead-compute and streaming modes
against its own full forward."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import SwinTemporalStack as JStack  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.models import SwinTemporalStack  # noqa: E402

torch.set_num_threads(1)

# 16x24 keeps both stages above their windows (8 at stage 1, 4 at stage 2),
# so every SW block really shifts
RES, DIM, HEADS = (16, 24), 32, 4


@pytest.fixture(scope="module")
def stack_case():
    x = np.random.default_rng(0).standard_normal(
        (2, 5, *RES, DIM)).astype(np.float32)
    stack = JStack(dim=DIM, input_resolution=RES, num_heads=HEADS,
                   attn_impl="einsum")
    variables = jax.jit(stack.init)(jax.random.key(0), jnp.asarray(x[:, :4]))
    return x, variables


def _port(variables, **kw):
    m = SwinTemporalStack(DIM, RES, HEADS, **kw)
    return load_from_jax(m, variables).eval()


def test_stack_matches_jax_kernel_route(stack_case, monkeypatch):
    """The JAX route the port mirrors: roll-free SW blocks (attention with
    the shift inside, shifted epilogue), W blocks with the plain epilogue."""
    import stswincl_tpu.ops.pallas_add_ln_mlp as palm
    import stswincl_tpu.ops.pallas_attention as pa
    import stswincl_tpu.ops.pallas_block_attention as pba

    x, variables = stack_case
    monkeypatch.setattr(pa, "_is_tpu_backend", lambda: True)
    attn = pba.fused_swin_block_attention
    monkeypatch.setattr(pba, "fused_swin_block_attention",
                        lambda *a, **kw: attn(*a[:11], True))
    epi = palm.fused_swin_block_epilogue
    monkeypatch.setattr(palm, "fused_swin_block_epilogue",
                        lambda *a, **kw: epi(*a[:11], 1e-5, True))
    epis = palm.fused_swin_block_epilogue_shifted
    monkeypatch.setattr(palm, "fused_swin_block_epilogue_shifted",
                        lambda *a, **kw: epis(*a[:13], 1e-5, True))
    s1_j, s2_j = jax.jit(JStack(dim=DIM, input_resolution=RES,
                                num_heads=HEADS, attn_impl="pallas_full"
                                ).apply)(variables, jnp.asarray(x[:, :4]))

    with torch.no_grad():
        s1, s2 = _port(variables)(torch.from_numpy(x[:, :4]))
    assert s1.shape == (2, 4, *RES, DIM)
    assert s2.shape == (2, 4, RES[0] // 2, RES[1] // 2, 2 * DIM)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("depths", [(3, 3), (2, 2)])
def test_final_pair_only_keeps_the_live_outputs(stack_case, depths):
    """The elisions of `final_pair_only` change stage2 frames 0-2 only."""
    x, _ = stack_case
    full = SwinTemporalStack(DIM, RES, HEADS, depths=depths)
    from stswincl_tpu_torch.models.init import init_weights
    init_weights(full, torch.Generator().manual_seed(0))
    lean = SwinTemporalStack(DIM, RES, HEADS, depths=depths,
                             final_pair_only=True)
    lean.load_state_dict(full.state_dict())
    with torch.no_grad():
        s1_f, s2_f = full(torch.from_numpy(x[:, :4]))
        s1_l, s2_l = lean(torch.from_numpy(x[:, :4]))
    torch.testing.assert_close(s1_l, s1_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2_l[:, -1], s2_f[:, -1], rtol=1e-5,
                               atol=1e-5)


def test_layer0_cache_reproduces_the_full_stack(stack_case):
    """Clip B = frames 1..4 of a stream; its layer-0 (0, 1) group is the
    `layer0_only` output of frames (1, 2), computed while they sat at
    positions (1, 2) of clip A."""
    x, variables = stack_case
    m = _port(variables, final_pair_only=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        g_a = m(xt[:, 1:3], layer0_only=True)
        s1, s2, g_new = m(xt[:, 1:5], layer0_cached=g_a)
        s1_f, s2_f = m(xt[:, 1:5])
        g_want = m(xt[:, 3:5], layer0_only=True)
    torch.testing.assert_close(s1, s1_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2[:, -1], s2_f[:, -1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_new, g_want, rtol=0, atol=0)
