"""The fp32 forms of the rows on no model path, on the CPU: row 17's
schedule (`ops.conv.tap_rows`, the tap map the fp32 form reads x through,
and `pack_weights_f32`, its tap-major weight layout) written out in torch
as an im2col product with the form's epilogue, and the fp32 twins of rows
12-15 at widths off the model's (C 96, 100 and 2050), each against the
JAX package's Pallas kernel interpreted in fp32, forward and backward
(the twins' gradients through the port's autograd Functions, JAX's
through the kernels' custom VJPs); and K5 fp32's plan at head dim 32,
which lets `ModelConfig(swin_dim=128, dtype="float32")` train on the
card.

Tolerances, ||port - jax|| / ||jax||: row 17 1e-5 (the same products in
fp32 in another summation order, about 1e-7 measured); rows 12-15 1e-4
as in tests/test_torch_offpath_kernels.py (the same formulas in another
order; row 12's GELU the same erf polynomial)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import pallas_conv as jconv  # noqa: E402
from stswincl_tpu.ops import pallas_layernorm as jln  # noqa: E402
from stswincl_tpu.ops import pallas_mlp as jpm  # noqa: E402
from stswincl_tpu.ops.pallas_add_layernorm import (  # noqa: E402
    fused_add_layer_norm)
from stswincl_tpu.ops.pallas_add_ln_mlp import fused_add_ln_mlp  # noqa: E402
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ckpt.from_jax import to_jax_layout  # noqa: E402
from stswincl_tpu_torch.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock  # noqa: E402
from stswincl_tpu_torch.ops import (add_layernorm, add_ln_mlp,  # noqa: E402
                                    attention, block_attention, conv,
                                    layernorm, mlp)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy
CONV_TOL = 1e-5
TOL = 1e-4


def _rel(got, want):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _f(rng):
    return lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k
                                     + o).astype(np.float32)


# ---- row 17: the fp32 form's schedule -------------------------------------

def conv_as_the_form_reads_it(x, w, scale, shift, dilation, relu, residual):
    """Row 17 as `stswin_conv3x3_bn_act_f32` computes it: A row m holds,
    tap after tap (k = tap * Cin + c), the channels of the pixel
    `tap_rows` names (zeros in the padding); acc = A @ Wt^T with Wt =
    `pack_weights_f32(w)`; then acc * scale, + shift, + residual, ReLU."""
    N, H, W, cin = x.shape
    rows = conv.tap_rows(N, H, W, dilation)
    assert rows.shape == (N * H * W, 9)
    xf = torch.cat([x.reshape(-1, cin), x.new_zeros(1, cin)])
    a = xf[torch.where(rows < 0, N * H * W, rows)].reshape(N * H * W,
                                                           9 * cin)
    wt = conv.pack_weights_f32(w)
    assert wt.shape == (w.shape[0], 9 * cin) and cin % 4 == 0
    y = (a @ wt.t()) * scale + shift
    if residual is not None:
        y = y + residual.reshape(y.shape)
    if relu:
        y = y.clamp_min(0.0)
    return y.reshape(N, H, W, -1)


@pytest.mark.parametrize("dilation", [1, 2, 4, 12])
@pytest.mark.parametrize("relu,with_res", [(True, False), (False, False),
                                           (True, True)],
                         ids=["relu", "linear", "relu-residual"])
def test_row17_fp32_schedule_matches_jax(rng, dilation, relu, with_res):
    """The tap map and the packing against the interpreted Pallas kernel
    in fp32 (HWIO w, as `from_jax` maps the port's OIHW), at dilation 12
    with most taps past the 16 x 32 image; the twin agrees too."""
    f = _f(rng)
    N, H, W, cin, cout = 2, 16, 32, 64, 96
    x = f(N, H, W, cin)
    w = f(cout, cin, 3, 3, k=(9 * cin) ** -0.5)
    scale, shift = f(cout, k=0.2, o=1.0), f(cout, k=0.2)
    res = f(N, H, W, cout) if with_res else None
    want = jconv.conv3x3_bn_act(
        jnp.asarray(x), jnp.asarray(to_jax_layout("conv.weight", w)),
        jnp.asarray(scale), jnp.asarray(shift), dilation=dilation,
        relu=relu, residual=None if res is None else jnp.asarray(res),
        interpret=True)
    args = (T_(x), T_(w), T_(scale), T_(shift))
    r = None if res is None else T_(res)
    got = conv_as_the_form_reads_it(*args, dilation, relu, r)
    assert got.shape == (N, H, W, cout)
    assert _rel(got, want) <= CONV_TOL
    twin = conv.conv3x3_bn_act_ref(*args, dilation=dilation, relu=relu,
                                   residual=r)
    assert _rel(twin, want) <= CONV_TOL


def test_row17_tap_rows_are_the_dilated_taps():
    """`tap_rows` against the padded image: tap (ky, kx) of pixel (n, h, w)
    is pixel (h + d (ky - 1), w + d (kx - 1)) of image n, -1 exactly where
    that lies in the padding; the centre tap is the pixel itself."""
    N, H, W, d = 2, 5, 7, 2
    rows = conv.tap_rows(N, H, W, d)
    ids = torch.arange(N * H * W).reshape(N, H, W)
    padded = torch.nn.functional.pad(ids, (d, d, d, d), value=-1)
    for ky in range(3):
        for kx in range(3):
            want = padded[:, ky * d: ky * d + H, kx * d: kx * d + W]
            assert torch.equal(rows[:, 3 * ky + kx], want.reshape(-1))
    assert torch.equal(rows[:, 4], ids.reshape(-1))


# ---- rows 12-15: the fp32 twins at other widths ----------------------------

WIDTHS = [96, 100, 2050]


def _mlp_case(rng, C, hidden=256):
    """16 rows (the Pallas grid takes whole row tiles) and a hidden width
    the Pallas kernel takes whole at every C here."""
    f = _f(rng)
    x, g = f(2, 8, C), f(2, 8, C)
    w1, b1 = f(C, hidden, k=C ** -0.5), f(hidden, k=0.05)  # JAX layout
    w2, b2 = f(hidden, C, k=hidden ** -0.5), f(C, k=0.05)
    return f, x, g, (w1, b1, w2, b2)


def _port_mlp(w1, b1, w2, b2):
    return [T_(np.ascontiguousarray(w1.T)), T_(b1),
            T_(np.ascontiguousarray(w2.T)), T_(b2)]


def _grads(fn, leaves, grads_out):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * g).sum() for o, g in zip(outs, grads_out)
               if o is not None)
    return outs, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("C", WIDTHS)
def test_row12_fp32_twin_matches_jax(rng, C):
    _, x, g, w = _mlp_case(rng, C)

    def jloss(*a):
        out = jpm.fused_mlp(*a, True, True)
        return jnp.sum(out * g), out
    (_, want), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(
        *map(jnp.asarray, (x, *w)))
    leaves = [t.requires_grad_() for t in [T_(x)] + _port_mlp(*w)]
    (out,), grads = _grads(lambda *a: mlp.fused_mlp(*a, True), leaves,
                           (T_(g),))
    assert out.dtype == torch.float32 and _rel(out, want) <= TOL
    for i, (a, b) in enumerate(zip(grads, jg)):
        assert _rel(a.t() if i in (1, 3) else a, b) <= TOL, i


@pytest.mark.parametrize("C", WIDTHS)
def test_row13_fp32_twin_matches_jax(rng, C):
    f, x, g, w = _mlp_case(rng, C)
    y, gs = f(*x.shape), f(*x.shape)
    scale, bias = f(C, k=0.1, o=1.0), f(C, k=0.1)

    def jloss(*a):
        s, m = fused_add_ln_mlp(*a, False, 1e-5, True)
        return jnp.sum(s * gs) + jnp.sum(m * g), (s, m)
    (_, want), jg = jax.value_and_grad(jloss, argnums=tuple(range(8)),
                                       has_aux=True)(
        *map(jnp.asarray, (x, y, scale, bias, *w)))
    leaves = [t.requires_grad_() for t in
              [T_(x), T_(y), T_(scale), T_(bias)] + _port_mlp(*w)]
    outs, grads = _grads(lambda *a: add_ln_mlp.add_ln_mlp(*a, False), leaves,
                         (T_(gs), T_(g)))
    for got, ref in zip(outs, want):
        assert _rel(got, ref) <= TOL
    for i, (a, b) in enumerate(zip(grads, jg)):
        assert _rel(a.t() if i in (4, 6) else a, b) <= TOL, i


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("return_sum", [True, False])
def test_row14_fp32_twin_matches_jax(rng, C, return_sum):
    f = _f(rng)
    x, y, gs, gn = (f(3, 4, C) for _ in range(4))
    scale, bias = f(C, k=0.5, o=1.0), f(C, k=0.5)

    def jloss(*a):
        s, n = fused_add_layer_norm(*a, 1e-5, return_sum, True)
        return (jnp.sum(n * gn) + (jnp.sum(s * gs) if return_sum else 0.0),
                (s, n))
    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *map(jnp.asarray, (x, y, scale, bias)))
    leaves = [T_(a).requires_grad_() for a in (x, y, scale, bias)]
    outs, grads = _grads(
        lambda *a: add_layernorm.add_layer_norm(*a, return_sum=return_sum),
        leaves, (T_(gs), T_(gn)))
    assert (outs[0] is None) == (not return_sum)
    for got, ref in zip(outs, want):
        if ref is not None:
            assert _rel(got, ref) <= TOL
    for a, b in zip(grads, jg):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("C", WIDTHS)
def test_row15_fp32_twin_matches_jax(rng, C):
    f = _f(rng)
    x, g = f(3, 4, C), f(3, 4, C)
    scale, bias = f(C, k=0.5, o=1.0), f(C, k=0.5)

    def jloss(*a):
        out = jln.fused_layer_norm(*a, 1e-5, True)
        return jnp.sum(out * g), out
    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *map(jnp.asarray, (x, scale, bias)))
    leaves = [T_(a).requires_grad_() for a in (x, scale, bias)]
    (out,), grads = _grads(layernorm.fused_layer_norm, leaves, (T_(g),))
    assert _rel(out, want) <= TOL
    for a, b in zip(grads, jg):
        assert _rel(a, b) <= TOL


# ---- K5 fp32 at head dim 32 ------------------------------------------------

def test_k5_fp32_plan_takes_head_dim_32():
    """K5 fp32's attention backward at hd 32, the head dim of `swin_dim`
    128 at both stages: TN 128 (stage 1) and TN 32 (stage 2) are taken,
    in 55,296 and 18,432 bytes of shared memory (the query pass's k, v and
    q / dO in rows of hd + 4; the key pass at TN 32, k, v and two 16-query
    chunks of q and dO, is the larger); so are the head dims of 8 below
    the limits (`swin_dim` 96's 24 and 48, 64's 16), and those past 128
    at TN 128 (160, 296 and 2048 among them), on the streamed passes;
    head dims off 8, and windows past 176 tokens, stay refused."""
    takes = block_attention._attn_f32_bwd_takes
    plan = block_attention._attn_f32_bwd_smem_bytes
    assert takes(128, 32) and takes(32, 32) and takes(64, 32)
    assert plan(128, 32) == 4 * 3 * 128 * 36 == 55296
    assert plan(32, 32) == 4 * (2 * 32 + 2 * 16 * 2) * 36 == 18432
    assert takes(128, 48) and takes(32, 16) and takes(128, 24)
    assert takes(32, 8) and takes(32, 48)
    assert not takes(128, 44) and not takes(32, 12) and not takes(192, 32)
    assert takes(128, 160) and takes(128, 288) and takes(128, 296)
    assert takes(128, 2048) and plan(128, 2048) == plan(128, 296)


def test_swin_dim_128_fp32_model_trains_on_k5():
    """Every swin block of `build_model(ModelConfig(swin_dim=128,
    dtype="float32"))` passes `check_backward_window` on its training
    window (stage 1: TN 128 at hd 32; stage 2: TN 32 at hd 64): the step
    is no longer refused before its forward."""
    model, _ = build_model(ModelConfig(swin_dim=128, dtype="float32"),
                           DataConfig(), device="meta")
    blocks = [m for m in model.modules()
              if isinstance(m, SpaceTimeSwinBlock)]
    hds = set()
    for blk in blocks:
        H, W = blk.input_resolution
        C = blk.norm1.weight.shape[0]
        x = torch.empty((1, 2, H, W, C), dtype=torch.float32, device="meta")
        block_attention.check_backward_window("k5", x, blk.num_heads,
                                              blk.window_size)
        hds.add(C // blk.num_heads)
    assert blocks and hds == {32, 64}
    assert kernels.SMEM_LIMIT >= block_attention._attn_f32_bwd_smem_bytes(
        128, 32)


@pytest.mark.parametrize("fields,hds", [
    (dict(num_heads=2), {256, 512}), (dict(swin_dim=768), {192, 384})],
    ids=["num_heads=2", "swin_dim=768"])
def test_fp32_models_past_the_resident_pair_route_to_the_fp32_forms(
        monkeypatch, fields, hds):
    """Every swin block of `build_model(ModelConfig(num_heads=2,
    dtype="float32"))` (hd 256 / 512) and of `swin_dim=768` (hd 192 /
    384) passes `check_backward_window` on its training window, and its
    K1 and K5 run their fp32 forms: on meta tensors that report `is_cuda`,
    with the library's launches recorded, K1's wrapper launches
    `stswin_block_attention_f32` and K5's `stswin_block_attention_bwd_f32`,
    no bf16 entry. Their windows lie past K5 fp32's resident passes, and
    at stage 1 (TN 128) past the forward's resident pair: the streamed
    instances (forward: 864 TN bytes; backward: the streamed passes) run
    them."""
    model, _ = build_model(ModelConfig(**fields, dtype="float32"),
                           DataConfig(), device="meta")
    blocks = [m for m in model.modules()
              if isinstance(m, SpaceTimeSwinBlock)]
    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: launched.append(name))
    monkeypatch.setattr(kernels, "query", lambda name, *a: 16)
    monkeypatch.setattr(kernels, "use_device", lambda dev: 0)
    meta = dict(dtype=torch.float32, device="meta")
    seen = set()
    for blk in blocks:
        H, W = blk.input_resolution
        C, heads, ws = blk.norm1.weight.shape[0], blk.num_heads, \
            blk.window_size
        T, hd = 2, C // blk.num_heads
        TN = T * ws * ws
        x = torch.empty((1, T, H, W, C), **meta)
        block_attention.check_backward_window("k5", x, heads, ws)
        # stage 1 (TN 128) streams its forward; stage 2's (TN 32) q, k, v
        # fit the resident pair
        fwd = block_attention._attn_f32_smem_bytes(TN, hd)
        assert fwd == (864 * TN if TN == 128
                       else attention._attn_f32_resident_bytes(TN, hd))
        assert not block_attention._attn_f32_bwd_resident(TN, hd)
        w = (torch.empty((3 * C, C), **meta), torch.empty(3 * C, **meta),
             torch.empty((C, C), **meta), torch.empty(C, **meta))
        bias = torch.empty((heads, TN, TN), **meta)
        launched.clear()
        _, qkv, attn = block_attention._forward_f32(
            x, *w, bias, None, heads, hd ** -0.5, ws, 0)
        block_attention.swin_block_attention_bwd_f32(
            x, x, qkv, attn, w[0], w[2], bias, None, heads, hd ** -0.5, ws,
            0)
        assert launched == ["stswin_block_attention_f32",
                            "stswin_block_attention_bwd_f32"], launched
        seen.add(hd)
    assert blocks and seen == hds
