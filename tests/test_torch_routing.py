"""What the port routes where, checked on the CPU: `build_model`'s choice
of kernels or plain twins by compute dtype, the attention core's envelope
(the shapes K1 and rows 10-11 take), the Hopper GEMM's row maps against
the window partition, the weight-gradient GEMM's twin against an explicit
roll + window partition + matmul, and row 15's twin at the widths of the
kernel's wide-row path against torch's float64 LayerNorm (the JAX comparison at
those widths is in test_torch_offpath_kernels.py)."""

import numpy as np
import pytest
import torch

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.configs import DataConfig, ModelConfig
from stswincl_tpu_torch.ops import attention, gemm, layernorm, mlp
from stswincl_tpu_torch.ops.window import partition_qkv
from stswincl_tpu_torch.pipelines.common import build_model


@pytest.mark.parametrize("dtype,want", [("float32", False),
                                        ("bfloat16", None)])
def test_build_model_routes_fp32_to_the_twins(dtype, want):
    model, classes = build_model(ModelConfig(swin_dim=64, swin_depths=(1, 1),
                                             dtype=dtype),
                                 DataConfig(crop_hw=(64, 96)), device="cpu")
    assert model.kernels is want
    blocks = [m for m in model.modules() if hasattr(m, "kernels")]
    assert len(blocks) >= 4 and all(m.kernels is want for m in blocks)
    assert classes == 12


def test_fp32_model_launches_no_kernel_on_the_cpu():
    """The fp32 model's forward runs its twins: finite logits of the right
    shape, and no kernel's launch count moves."""
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops import add_ln_mlp, block_attention

    model, classes = build_model(ModelConfig(swin_dim=64, swin_depths=(1, 1),
                                             dtype="float32"),
                                 DataConfig(crop_hw=(128, 128)), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    counted = (block_attention.swin_block_attention,
               add_ln_mlp.swin_block_epilogue, gemm.linear_sm90)
    before = [fn.launches for fn in counted]
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, 4, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        out = model.eval()(x, head_res_logits=True)
    assert out.shape == (1, classes, 16, 16) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert [fn.launches for fn in counted] == before


def _old_core_smem_bytes(TN, hd):
    """The first attention core's shared memory (q, k, v, fp32 scores,
    bf16 P, row offsets), which bounded the windows K1 and rows 10-11
    took before the register-resident core, and row 16's until it moved
    to that core."""
    a = attention._align
    return (3 * a(TN * (hd + 8) * 2) + a(TN * max(TN + 4, hd + 4) * 4)
            + a(TN * (TN + 8) * 2) + a(TN * 8))


def _old_envelope():
    return [(TN, hd) for TN in range(16, 512, 16) for hd in range(16, 2048, 16)
            if _old_core_smem_bytes(TN, hd) <= kernels.SMEM_LIMIT]


def _check(TN, hd, heads=2):
    bias = torch.zeros((heads, TN, TN))
    return attention.check_attention_core("t", torch.device("cpu"), bias,
                                          None, heads, TN, hd)


def test_attention_envelope_keeps_every_shape_the_old_core_took():
    shapes = _old_envelope()
    assert (128, 128) in shapes and (32, 256) in shapes  # the two stages
    assert max(TN for TN, _ in shapes) == attention.MAX_WINDOW_TOKENS
    for TN, hd in shapes:
        assert attention._attn_smem_bytes(TN, hd) <= kernels.SMEM_LIMIT
        assert _check(TN, hd) == (None, 0)
    # stage 1 takes two blocks an SM: each under half the shared memory
    assert 2 * attention._attn_smem_bytes(128, 128) <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("TN,hd", [(192, 64), (128, 1024), (16, 4096),
                                   (120, 64), (128, 72)])
def test_attention_envelope_refuses_oversize_and_ragged_windows(TN, hd):
    with pytest.raises(ValueError):
        _check(TN, hd)


@pytest.mark.parametrize("shift", [0, 2])
def test_gemm_row_map_is_the_window_partition(shift):
    """`window_rows` (the GEMM's `map_row`) gathers the rolled image in
    the window order of `partition_qkv`, and the GEMM's twin scatters back
    to the image layout."""
    B, T, H, W, ws, C = 2, 2, 8, 12, 4, 16
    M = B * T * H * W
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, T, H, W, 3 * C))
                         .astype(np.float32))
    xs = torch.roll(x, (-shift, -shift), dims=(2, 3))
    q, _, _ = partition_qkv(xs, 1, ws)  # (Bw, 1, TN, C), windows minor
    rows = gemm.window_rows(M, (T, H, W, ws, shift))
    assert torch.equal(x.reshape(M, 3 * C)[rows, :C], q.reshape(M, C))
    wt = torch.eye(3 * C)
    out = gemm.linear_sm90_ref(x.reshape(M, 3 * C)[rows], wt, epi="f32",
                               c_map=(T, H, W, ws, 0),
                               out=torch.zeros(M, 3 * C))
    back = torch.roll(out.reshape(B, T, H, W, 3 * C), (shift, shift),
                      dims=(2, 3))
    assert torch.equal(back, x)


STAGE_WINDOWS = {"stage1": (2, 16, 24, 8), "stage2": (2, 8, 12, 4)}


@pytest.mark.parametrize("stage", sorted(STAGE_WINDOWS))
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("gathered", ["a", "b", "both"])
def test_wgrad_twin_is_the_partitioned_product(stage, shifted, gathered):
    """`wgrad_sm90_ref`'s row-mapped reduction == torch.roll into the
    SW-MSA layout, the window partition of `partition_qkv`, then a^T b, at
    both stages' window geometry (TN 128 at ws 8, TN 32 at ws 4), with and
    without the shift, either operand (or both) gathered: K5's dwqkv
    gathers x, its dwproj g."""
    T, H, W, ws = STAGE_WINDOWS[stage]
    shift = ws // 2 if shifted else 0
    B, Ca, Cb = 2, 8, 4
    M = B * T * H * W
    rng = np.random.default_rng(3)
    a_img = torch.from_numpy(rng.standard_normal((B, T, H, W, Ca))
                             .astype(np.float32))
    b_img = torch.from_numpy(rng.standard_normal((B, T, H, W, Cb))
                             .astype(np.float32))

    def windows(img, C):
        rolled = torch.roll(img, (-shift, -shift), dims=(2, 3))
        part, _, _ = partition_qkv(torch.cat([rolled] * 3, -1), 1, ws)
        return part.reshape(M, C)

    rmap = (T, H, W, ws, shift)
    a_map = rmap if gathered in ("a", "both") else None
    b_map = rmap if gathered in ("b", "both") else None
    a_rows = windows(a_img, Ca) if a_map else a_img.reshape(M, Ca)
    b_rows = windows(b_img, Cb) if b_map else b_img.reshape(M, Cb)
    got = gemm.wgrad_sm90_ref(a_img.reshape(M, Ca), b_img.reshape(M, Cb),
                              a_map, b_map)
    torch.testing.assert_close(got, a_rows.t() @ b_rows, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(gemm.wgrad_sm90(a_img.reshape(M, Ca),
                                       b_img.reshape(M, Cb), a_map, b_map),
                       got)


def test_gelu_bwd_twin_matches_the_autograd_of_gelu():
    """K6's fused pair twin: dpre = dh * gelu'(pre) with gelu' the
    derivative of `ops.mlp.gelu` (the erf polynomial), h = gelu(pre), db1
    the column sums of the fp32 dpre."""
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
    n2, dm, w1, w2_t, b1 = f(20, 16), f(20, 16), f(24, 16), f(24, 16), f(24)
    dpre, h, db1 = gemm.gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1)
    pre = (n2 @ w1.t() + b1).requires_grad_()
    y = mlp.gelu(pre, True)
    dh = dm @ w2_t.t()
    (want,) = torch.autograd.grad(y, pre, dh)
    # autograd carries dh through each op of the polynomial, the twin
    # multiplies once: fp32 rounding apart
    torch.testing.assert_close(dpre, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, y.detach(), rtol=0, atol=0)
    torch.testing.assert_close(db1, want.sum(0), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_row7_ways_to_dpre_agree(act):
    """K6 with m recomputed takes gelu' through device memory: fc1's
    "gelu_grad" epilogue (h, gelu') then dh's "dgelu" epilogue (dpre, db1)
    compute what the fused pair (m saved) does, on the twins."""
    rng = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
    n2, dm, w1, w2_t, b1 = f(30, 16), f(30, 16), f(24, 16), f(24, 16), f(24)
    h, d = gemm.linear_sm90(n2, w1, b1, act, epi="gelu_grad")
    dpre, db1 = gemm.linear_sm90(dm, w2_t, epi="dgelu", aux=d)
    want = gemm.gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1, act)
    for got, w in zip((dpre, h, db1), want):
        torch.testing.assert_close(got, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("C", [100, 2050, 3072])
def test_layer_norm_twin_at_any_width(C):
    """Row 15's twin at the widths the wide-row path takes, against a
    float64 LayerNorm."""
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.standard_normal((5, C)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(C).astype(np.float32))
    got = layernorm.fused_layer_norm(x, s, b)
    want = torch.nn.functional.layer_norm(x.double(), (C,), s.double(),
                                          b.double(), 1e-5)
    assert torch.allclose(got.double(), want, atol=1e-4, rtol=1e-4)
