"""The port's CUDA kernels against their plain twins, bf16, on a CUDA card.

These tests import neither JAX nor the JAX package, and skip without a
card. On the machine with the card (which has no JAX, while
`tests/conftest.py` imports it) run them without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small but within what the kernels take (C a multiple of 128);
their row counts are not multiples of the GEMM's 128-row tile, so the
ragged edges run too. The backward kernels (K5, K6) are held against
autograd of their twins at mid sizes that keep the stage-1 and stage-2
window shapes (TN 128 / hd 64, TN 32 / hd 128). The standalone attention
kernels of the 'pallas' and 'pallas_windows' routes (Pallas rows 10 and
11) run at both stages' full window shapes (TN 128 / hd 128, TN 32 /
hd 256), on six windows an image and two images, with and without the
SW-MSA mask. The whole-block kernel (Pallas row 16) runs at both stages'
window shapes (TN 128, TN 32), with a last tile of fewer windows too,
forward, against the K1 + K2 pair to the bit and through its Function;
rows 13 and 14 on row counts that are not multiples of anything the
kernels tile by, row 13 at C 72 too. Rows 12 (MLP), 15 (LayerNorm) and 17
(conv) run at the JAX tests' narrow widths, off the multiples of 32 and
at the model's, with
ragged row counts, forward and (rows 12, 15) through their Functions and
their modules; rows 14 and 15 also on more rows than their persistent
grid holds; row 17 at dilations 1, 2, 4 and 18 (most taps in the
padding), with and without the residual, and at its envelope's edges
(Cin 32 and 96, Cout 8, the ASPP's d 18 on 32x40) with the library's
count of its GEMM form. The Hopper GEMM of K1 and K2
runs alone against torch.matmul at ragged M, N and K with each epilogue,
and with K1's row maps (both gathers, the scatter); K6's fused dh / pre
pair (dpre, h, db1) against its twin at a ragged row count; the
weight-gradient GEMM against torch.matmul in fp32 at K5's and K6's
shapes, windows the shift wraps and ragged row counts included; K5 and K6
at both training stages' full shapes, with the GEMM launches the library
counts inside them; a window K5 does not take refused before a trained
block's forward; the fp32 model serves and takes a train step on the
plain twins with no kernel launched.
"""

import pytest
import torch

from stswincl_tpu_torch.ops import (add_layernorm, add_ln_mlp, attention,
                                    block_attention, conv, gemm, layernorm,
                                    mlp, patch_merge, swin_block,
                                    upsample_argmax)
from stswincl_tpu_torch.ops.resize import composed_matrices
from stswincl_tpu_torch.ops.window import (partition_qkv,
                                           relative_position_index,
                                           shifted_window_attention_mask)

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
TOL = 1e-2  # ||kernel - twin|| / ||twin||: bf16 outputs, fp32 sums


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _close(got, want, same_dtype=True):
    assert got.shape == want.shape
    assert got.dtype == want.dtype or not same_dtype
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL, rel


def _attn_args(dev, gen, shift, B=2, T=2, H=8, W=12, C=128, heads=2, ws=4,
               gain_qkv=1.0, gain_proj=1.0, bias_k=0.02):
    r = lambda *s, k=1.0, dt=BF: (torch.randn(s, generator=gen, device=dev)
                                  * k).to(dt)
    N, TN = ws * ws, T * ws * ws
    table = r((2 * ws - 1) ** 2, heads, k=bias_k, dt=torch.float32)
    idx = torch.from_numpy(relative_position_index(ws, ws)).long().to(dev)
    bias = table[idx.reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)
    mask = None
    if shift:
        mask = torch.from_numpy(shifted_window_attention_mask(
            H, W, ws, shift)).repeat(1, T, T).to(dev)
    return [r(B, T, H, W, C), r(3 * C, C, k=gain_qkv * C ** -0.5),
            r(3 * C, k=0.1, dt=torch.float32),
            r(C, C, k=gain_proj * C ** -0.5),
            r(C, k=0.1, dt=torch.float32),
            bias.repeat(1, T, T).contiguous(), mask, heads,
            (C // heads) ** -0.5, ws, shift]


@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_kernel(dev, gen, shift):
    args = _attn_args(dev, gen, shift)
    n = block_attention.swin_block_attention.launches
    got = block_attention.swin_block_attention(*args)
    assert block_attention.swin_block_attention.launches == n + 1
    _close(got, block_attention.swin_block_attention_ref(*args))


def _epi_params(dev, gen, C=128, hidden=512):
    f = lambda *s, k=1.0, o=0.0: torch.randn(s, generator=gen,
                                             device=dev) * k + o
    return [f(C, k=0.1, o=1.0), f(C, k=0.1), f(hidden, C, k=C ** -0.5).to(BF),
            f(hidden, k=0.05), f(C, hidden, k=hidden ** -0.5).to(BF),
            f(C, k=0.05), f(C, k=0.1, o=1.0), f(C, k=0.1)]


@pytest.mark.parametrize("shift,T", [(0, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("exact", [True, False])
def test_epilogue_kernel(dev, gen, shift, T, exact):
    p = _epi_params(dev, gen)
    x, y = (torch.randn((1, T, 8, 12, 128), generator=gen,
                        device=dev).to(BF) for _ in range(2))
    kw = dict(gelu_exact=exact, shift=shift, ws=4)
    _close(add_ln_mlp.swin_block_epilogue(x, y, *p, **kw),
           add_ln_mlp.swin_block_epilogue_ref(x, y, *p, **kw))


def test_patch_merge_kernel(dev, gen):
    x = torch.randn((3, 8, 12, 128), generator=gen, device=dev).to(BF)
    p = (1.0 + 0.1 * torch.randn(512, generator=gen, device=dev),
         0.1 * torch.randn(512, generator=gen, device=dev),
         (torch.randn((256, 512), generator=gen, device=dev)
          * 512 ** -0.5).to(BF))
    _close(patch_merge.patch_merge(x, *p), patch_merge.patch_merge_ref(x, *p))


def _pm_params(dev, gen, C):
    f = lambda *s, k=1.0, o=0.0: torch.randn(s, generator=gen,
                                             device=dev) * k + o
    return (f(4 * C, k=0.1, o=1.0), f(4 * C, k=0.1),
            f(2 * C, 4 * C, k=(4 * C) ** -0.5).to(BF))


@pytest.mark.parametrize("C", [64, 512, 640])
def test_patch_merge_kernel_widths(dev, gen, C):
    """The LayerNorm pass with the row in registers (C <= 512, lanes past C
    idle at 64) and read twice (640), ragged GEMM rows (3 * 4 * 5 = 60); one
    bf16-form Hopper GEMM launch a call in the library's count."""
    x = torch.randn((3, 8, 10, C), generator=gen, device=dev).to(BF)
    p = _pm_params(dev, gen, C)
    gemm.launch_counts(reset=True)
    got = patch_merge.patch_merge(x, *p)
    torch.cuda.synchronize()
    assert gemm.launch_counts() == dict.fromkeys(gemm.FORMS, 0) | {"bf16": 1}
    _close(got, patch_merge.patch_merge_ref(x, *p))


def test_patch_merge_backward_bf16(dev, gen):
    """PatchMergeFn on bf16 x and w (an fp32 w, cast for the product, as the
    model's parameters are): its gradients against autograd of the fp32
    twin on the same values, each within 1e-2 (bf16 rounding of dn, dW and
    the recomputed n)."""
    C = 128
    x = torch.randn((3, 8, 10, C), generator=gen, device=dev).to(BF)
    s, b, w = _pm_params(dev, gen, C)
    w = w.float()
    g = torch.randn((3, 4, 5, 2 * C), generator=gen, device=dev).to(BF)
    leaves = [t.clone().requires_grad_() for t in (x, s, b, w)]
    got = torch.autograd.grad(patch_merge.patch_merge(*leaves), leaves, g)
    ref = [t.detach().float().requires_grad_() for t in (x, s, b, w)]
    want = torch.autograd.grad(patch_merge.patch_merge_ref(*ref), ref,
                               g.float())
    for a, t in zip(got, (x, s, b, w)):
        assert a.dtype == t.dtype
    for a, r in zip(got, want):
        _close(a, r, same_dtype=False)


@pytest.mark.parametrize("exact", [True, False])
def test_upsample_argmax_kernel(dev, gen, exact):
    x = torch.randn((2, 5, 16, 24), generator=gen, device=dev)
    mh, mw = (m.to(dev) for m in composed_matrices(16, 24, (128, 192),
                                                   (200, 300)))
    got = upsample_argmax.upsample_argmax(x, mh, mw, exact)
    want = upsample_argmax.upsample_argmax_ref(x, mh, mw, exact)
    assert got.shape == (2, 200, 300) and got.dtype == torch.int32
    assert (got == want).float().mean().item() >= 0.999
    # class 0 below class 1 everywhere, classes 1 and 2 tied: 1 must win
    ties = torch.cat([x[:, 1:2] - 1.0, x[:, 1:2], x[:, 1:2]], dim=1)
    assert (upsample_argmax.upsample_argmax(ties.contiguous(), mh, mw,
                                            exact) == 1).all()


def _k4_pairs(dev, gen):
    """(name, x, mh, mw) cases off the banded common case: a dense random
    pair, an all-zero row and column, spans that are not monotone, the
    CaDIS protocol's matrices (67 x 84 head, align_out False)."""
    x = torch.randn((2, 5, 16, 24), generator=gen, device=dev)
    mh, mw = (m.to(dev) for m in composed_matrices(16, 24, (128, 192),
                                                   (200, 300)))
    zh, zw = mh.clone(), mw.clone()
    zh[7], zw[130] = 0.0, 0.0
    perm_h = torch.randperm(200, generator=gen, device=dev)
    perm_w = torch.randperm(300, generator=gen, device=dev)
    xc = torch.randn((1, 12, 67, 84), generator=gen, device=dev)
    ch, cw = (m.to(dev) for m in composed_matrices(
        67, 84, (536, 672), (540, 960), align_out=False))
    return [("dense", x, torch.rand((70, 16), generator=gen, device=dev),
             torch.rand((150, 24), generator=gen, device=dev)),
            ("zero row", x, zh, zw),
            ("not monotone", x, mh[perm_h], mw[perm_w]),
            ("cadis", xc, ch, cw)]


@pytest.mark.parametrize("exact", [True, False])
def test_upsample_argmax_kernel_off_band(dev, gen, exact):
    """The banded kernel on matrices whose spans are full, empty or out of
    order, and at the CaDIS shapes: within 99.9 % of pixels of its twin,
    and the same with the spans given as computed."""
    for name, x, mh, mw in _k4_pairs(dev, gen):
        n = upsample_argmax.upsample_argmax.launches
        got = upsample_argmax.upsample_argmax(x, mh, mw, exact)
        want = upsample_argmax.upsample_argmax_ref(x, mh, mw, exact)
        share = (got == want).float().mean().item()
        assert share >= 0.999, (name, share)
        spans = (upsample_argmax.interp_spans(mh),
                 upsample_argmax.interp_spans(mw))
        assert torch.equal(upsample_argmax.upsample_argmax(
            x, mh, mw, exact, spans=spans), got), name
        assert upsample_argmax.upsample_argmax.launches == n + 2


BWD_CASES = {  # (T, H, W, C, heads, ws): stage-1-like and stage-2-like
    "s1": (2, 16, 24, 128, 2, 8),
    "s2": (2, 8, 12, 256, 2, 4),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
@pytest.mark.parametrize("shifted", [False, True])
def test_block_attention_bwd_kernel(dev, gen, case, shifted):
    """K1 + K5 through the autograd Function (fp32 weights, as the model
    hands them) against autograd of the twin on the bf16 weights."""
    T, H, W, C, heads, ws = BWD_CASES[case]
    args = _attn_args(dev, gen, ws // 2 if shifted else 0, B=2, T=T, H=H,
                      W=W, C=C, heads=heads, ws=ws)
    args[1], args[3] = args[1].float(), args[3].float()
    leaves = [a.detach().requires_grad_() for a in args[:6]]
    n_fwd = block_attention.swin_block_attention.launches
    n_bwd = block_attention.swin_block_attention_bwd.launches
    out = block_attention.swin_block_attention(*leaves, *args[6:])
    g = torch.randn(out.shape, generator=gen, device=dev).to(BF)
    got = torch.autograd.grad(out, leaves, g)
    assert block_attention.swin_block_attention.launches == n_fwd + 1
    assert block_attention.swin_block_attention_bwd.launches == n_bwd + 1
    twin_args = [args[0], args[1].to(BF), args[2], args[3].to(BF)] + args[4:]
    want = block_attention.swin_block_attention_bwd_ref(
        *twin_args[:7], g, *twin_args[7:])
    for a, gr, w in zip(args, got, want):
        assert gr.dtype == a.dtype
        _close(gr, w, same_dtype=False)


def _epi_case(dev, gen, T, C, shift, ws):
    p = _epi_params(dev, gen, C=C, hidden=4 * C)
    x, y, g = (torch.randn((2, T, 8, 12, C), generator=gen, device=dev).to(BF)
               for _ in range(3))
    return p, x, y, g, dict(gelu_exact=True, shift=shift, ws=ws)


@pytest.mark.parametrize("shift,T", [(0, 2), (2, 2), (2, 1)])
@pytest.mark.parametrize("C", [128, 256])
def test_epilogue_bwd_kernel(dev, gen, shift, T, C):
    """K2 + K6 through the autograd Function (fp32 weights) against
    autograd of the twin; C 128 recomputes m, C 256 takes it saved
    (through the wrapper, at sizes the Function would recompute)."""
    p, x, y, g, kw = _epi_case(dev, gen, T, C, shift, 4)
    p[2], p[4] = p[2].float(), p[4].float()
    leaves = [t.detach().requires_grad_() for t in [x, y] + p]
    n = add_ln_mlp.swin_block_epilogue_bwd.launches
    out = add_ln_mlp.swin_block_epilogue(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, g)
    assert add_ln_mlp.swin_block_epilogue_bwd.launches == n + 1
    tw = [x, y] + p[:2] + [p[2].to(BF), p[3], p[4].to(BF)] + p[5:]
    want = add_ln_mlp.swin_block_epilogue_bwd_ref(*tw, g, **kw)
    for a, gr, w in zip([x, y] + p, got, want):
        assert gr.dtype == a.dtype
        _close(gr, w, same_dtype=False)
    if C == 256:
        out_m, m = add_ln_mlp._forward_kernel(*tw, **kw, eps=1e-5,
                                              with_m=True)
        want_out, want_m = add_ln_mlp.swin_block_epilogue_with_m_ref(*tw,
                                                                     **kw)
        _close(out_m, want_out)
        _close(m, want_m)
        got_m = add_ln_mlp.swin_block_epilogue_bwd(
            x, y, g, m, *tw[2:9], **kw)
        for gr, w in zip(got_m, want):
            _close(gr, w, same_dtype=False)


def test_backward_rejects_unsupported_shapes(dev, gen):
    """K5 refuses a window whose backward does not fit shared memory
    (TN 128 x hd 256), K6 a width its row kernels have no variant for."""
    x = torch.zeros((1, 2, 8, 8, 512), device=dev, dtype=BF)
    w = torch.zeros((1536, 512), device=dev, dtype=BF)
    bias = torch.zeros((2, 128, 128), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        block_attention.swin_block_attention_bwd(
            x, x, torch.zeros((128, 1536), device=dev, dtype=BF),
            torch.zeros((128, 512), device=dev, dtype=BF), w,
            w[:512], bias, None, 2, 0.1, 8, 0)
    p = _epi_params(dev, gen, C=384, hidden=1536)
    xe = torch.zeros((4, 384), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="C must be"):
        add_ln_mlp.swin_block_epilogue_bwd(xe, xe, xe, None, *p[:7])


ROW_CASES = {  # (T, H, W, C, heads, ws): stage 1 and stage 2 windows
    "s1": (2, 16, 24, 512, 4, 8),
    "s2": (2, 8, 12, 1024, 4, 4),
}


def _row_args(dev, gen, case, masked):
    """(qkv (2, T, H, W, 3C) bf16, bias_tiled, mask_tiled or None, heads,
    scale, ws) of a stage's window shape."""
    T, H, W, C, heads, ws = ROW_CASES[case]
    a = _attn_args(dev, gen, ws // 2 if masked else 0, B=1, T=T, H=H, W=W,
                   C=128, heads=heads, ws=ws)
    qkv = torch.randn((2, T, H, W, 3 * C), generator=gen, device=dev).to(BF)
    return qkv, a[5], a[6], heads, (C // heads) ** -0.5, ws


def _grads_close(fn, twin, leaves, rest):
    """fn's gradients (through its autograd Function) against autograd of
    the twin, for the same output gradient."""
    leaves = [t.detach().requires_grad_() for t in leaves]
    out = fn(*leaves, *rest)
    g = torch.randn(out.shape, device=out.device).to(out.dtype)
    got = torch.autograd.grad(out, leaves, g)
    twin_leaves = [t.detach().requires_grad_() for t in leaves]
    want = torch.autograd.grad(twin(*twin_leaves, *rest), twin_leaves, g)
    for gr, w in zip(got, want):
        _close(gr, w)


@pytest.mark.parametrize("case", sorted(ROW_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_image_kernel(dev, gen, case, masked):
    """Row 10 on the image-layout qkv, forward and its Function."""
    qkv, bias, mask, heads, scale, ws = _row_args(dev, gen, case, masked)
    fn = block_attention.windowed_attention_image
    twin = block_attention.windowed_attention_image_ref
    n = fn.launches
    _close(fn(qkv, bias, mask, heads, scale, ws),
           twin(qkv, bias, mask, heads, scale, ws))
    assert fn.launches == n + 1
    _grads_close(fn, twin, [qkv, bias], (mask, heads, scale, ws))
    assert fn.launches == n + 2


@pytest.mark.parametrize("case", sorted(ROW_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_heads_kernel(dev, gen, case, masked):
    """Row 11 on partitioned q, k, v (windows minor, mask b % nW),
    forward and its Function (backward: the port of JAX's `_bwd`)."""
    qkv, bias, mask, heads, scale, ws = _row_args(dev, gen, case, masked)
    q, k, v = partition_qkv(qkv, heads, ws).contiguous()
    fn = attention.fused_window_attention
    masks = [mask] if masked else [None, torch.zeros_like(bias[:1])]
    for m in masks:  # None and the W-MSA zero marker
        n = fn.launches
        _close(fn(q, k, v, bias, m, scale),
               attention.attend_tiled(q, k, v, bias, m, scale))
        assert fn.launches == n + 1
    _grads_close(fn, attention.attend_tiled, [q, k, v, bias], (mask, scale))


def test_fp32_activations_are_refused(dev, gen):
    args = _attn_args(dev, gen, 0)
    args[0] = args[0].float()
    with pytest.raises(NotImplementedError):
        block_attention.swin_block_attention(*args)
    qkv, bias, _, heads, scale, ws = _row_args(dev, gen, "s2", False)
    with pytest.raises(NotImplementedError):
        block_attention.windowed_attention_image(qkv.float(), bias, None,
                                                 heads, scale, ws)
    q = partition_qkv(qkv, heads, ws)[0].float().contiguous()
    with pytest.raises(NotImplementedError):
        attention.fused_window_attention(q, q, q, bias, None, scale)


def test_attention_kernels_refuse_windows_beyond_shared_memory(dev):
    """TN 128 x hd 512 does not fit one block's shared memory (q, k and v
    of the window, 399 KB); TN 128 x hd 256, which the first core refused,
    fits the register-resident one (202 KB) and agrees with its twin."""
    q = torch.zeros((2, 2, 128, 512), device=dev, dtype=BF)
    bias = torch.zeros((2, 128, 128), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        attention.fused_window_attention(q, q, q, bias, None, 0.1)
    qkv = torch.zeros((1, 2, 8, 8, 3 * 1024), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="shared memory"):
        block_attention.windowed_attention_image(qkv, bias, None, 2, 0.1, 8)
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 2, 128, 256), generator=g, device=dev)
               .to(BF) for _ in range(3))
    _close(attention.fused_window_attention(q, k, v, bias, None, 0.0625),
           attention.attend_tiled(q, k, v, bias, None, 0.0625))


def test_small_model_routes_agree(dev):
    """TswinPlus at swin_dim 128 in bf16: the kernel route against the
    plain route, and streaming against the full clip."""
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    kw = dict(num_classes=5, swin_dim=128, swin_depths=(2, 2),
              dtype=BF, input_hw=(128, 192))
    model = TswinPlus(**kw)
    init_weights(model, torch.Generator().manual_seed(0))
    plain = TswinPlus(**kw, kernels=False)
    plain.load_state_dict(model.state_dict())
    model.to(dev).eval()
    plain.to(dev).eval()
    frames = torch.rand((1, 5, 128, 192, 3),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 2 - 1
    with torch.inference_mode():
        lk = model(frames[:, 1:5], head_res_logits=True)
        lp = plain(frames[:, 1:5], head_res_logits=True)
    rel = ((lk - lp).norm() / lp.norm()).item()
    assert rel <= TOL, rel
    seg = StreamingSegmenter(model, out_hw=(256, 384))
    cache, _ = seg.init_and_predict(frames[:, 0:4])
    _, pred = seg.predict_next(cache, frames[:, 4])
    full = composed_upsample_argmax_cf(lk, (128, 192), (256, 384))
    assert (pred == full).float().mean().item() >= 0.999


@pytest.mark.parametrize("route", ["pallas", "pallas_windows"])
def test_small_model_new_routes_agree(dev, route):
    """TswinPlus at swin_dim 128 in bf16 on the 'pallas' and
    'pallas_windows' routes: each launches its attention kernel, agrees
    with its plain route and with the 'pallas_full' route, and streams
    as the full clip."""
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    kw = dict(num_classes=5, swin_dim=128, swin_depths=(2, 2),
              dtype=BF, input_hw=(128, 192))
    full = TswinPlus(**kw)
    init_weights(full, torch.Generator().manual_seed(0))
    model = TswinPlus(**kw, attn_impl=route)
    plain = TswinPlus(**kw, attn_impl=route, kernels=False)
    for m in (model, plain):
        m.load_state_dict(full.state_dict())
    for m in (full, model, plain):
        m.to(dev).eval()
    frames = torch.rand((1, 5, 128, 192, 3),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 2 - 1
    fn = (block_attention.windowed_attention_image if route == "pallas"
          else attention.fused_window_attention)
    n = fn.launches
    with torch.inference_mode():
        lk = model(frames[:, 1:5], head_res_logits=True)
        assert fn.launches > n
        lp = plain(frames[:, 1:5], head_res_logits=True)
        lf = full(frames[:, 1:5], head_res_logits=True)
    for other in (lp, lf):
        rel = ((lk - other).norm() / other.norm()).item()
        assert rel <= TOL, rel
    seg = StreamingSegmenter(model, out_hw=(256, 384))
    cache, _ = seg.init_and_predict(frames[:, 0:4])
    _, pred = seg.predict_next(cache, frames[:, 4])
    want = composed_upsample_argmax_cf(lk, (128, 192), (256, 384))
    assert (pred == want).float().mean().item() >= 0.999


WHOLE_CASES = {  # (B, T, H, W, C, heads, ws): stage-1 and stage-2 windows
    "s1": (2, 2, 16, 24, 128, 2, 8),
    "s2": (2, 2, 8, 12, 256, 2, 4),
    # 6 windows of 32 tokens: a last tile of two windows
    "s2_ragged": (1, 2, 8, 12, 256, 2, 4),
}


def _whole_args(dev, gen, case):
    """Row 16's arguments: x, the attention and epilogue parameters with
    fp32 weights (as the model hands them to the Function). The qkv and
    proj weights and the relative bias are drawn large enough that the
    attention branch y is about as large as x and the softmax is peaked,
    so that a fault in the attention phases moves the block's output past
    TOL (at unit gains and a 0.02 bias, y is a few % of x)."""
    B, T, H, W, C, heads, ws = WHOLE_CASES[case]
    a = _attn_args(dev, gen, 0, B=B, T=T, H=H, W=W, C=C, heads=heads, ws=ws,
                   gain_qkv=1.75, gain_proj=1.2, bias_k=1.0)
    p = _epi_params(dev, gen, C=C, hidden=4 * C)
    wqkv, wproj, w1, w2 = a[1].float(), a[3].float(), p[2].float(), p[4].float()
    return ([a[0], wqkv, a[2], wproj, a[4], a[5], None, p[0], p[1], w1, p[3],
             w2, p[5], p[6], p[7]], (heads, (C // heads) ** -0.5, ws))


@pytest.mark.parametrize("case", sorted(WHOLE_CASES))
def test_whole_block_kernel(dev, gen, case):
    """Row 16, one launch, against its rounded-m twin on the bf16 weights;
    then through `WholeBlockFn`: its backward (the pair's Functions, so K1,
    K2, K6 and K5) against autograd of the twin."""
    tensors, cfg = _whole_args(dev, gen, case)
    fn = swin_block.whole_swin_block
    bf_w = [t.to(BF) if i in (1, 3, 9, 11) else t
            for i, t in enumerate(tensors)]
    n = fn.launches
    want = swin_block.whole_swin_block_ref(*bf_w, *cfg)
    _close(fn(*bf_w, *cfg), want)
    assert fn.launches == n + 1
    # the bound tells an attention fault from rounding: the twin without
    # its relative bias lies far outside it
    no_bias = list(bf_w)
    no_bias[5] = torch.zeros_like(bf_w[5])
    moved = swin_block.whole_swin_block_ref(*no_bias, *cfg).float() - want
    assert moved.norm() / want.float().norm() > 10 * TOL
    idx = [i for i, t in enumerate(tensors) if t is not None]
    leaves = [tensors[i].detach().requires_grad_() for i in idx]

    def call(f, ls):
        args = list(tensors)
        for i, t in zip(idx, ls):
            args[i] = t
        return f(*args, *cfg)
    n5 = block_attention.swin_block_attention_bwd.launches
    n6 = add_ln_mlp.swin_block_epilogue_bwd.launches
    out = call(fn, leaves)
    g = torch.randn(out.shape, generator=gen, device=dev).to(BF)
    got = torch.autograd.grad(out, leaves, g)
    assert fn.launches == n + 2
    assert block_attention.swin_block_attention_bwd.launches == n5 + 1
    assert add_ln_mlp.swin_block_epilogue_bwd.launches == n6 + 1
    twin_leaves = [t.detach().requires_grad_() for t in leaves]
    want = torch.autograd.grad(call(swin_block.whole_swin_block_ref,
                                    twin_leaves), twin_leaves, g)
    for leaf, gr, w in zip(leaves, got, want):
        assert gr.dtype == leaf.dtype
        _close(gr, w)


@pytest.mark.parametrize("case", sorted(WHOLE_CASES))
def test_whole_block_carries_the_pairs_bits(dev, gen, case):
    """Row 16 sums every product in the order of the Hopper GEMM, runs
    K1's attention core and K2's LayerNorm order: its output equals the K1
    + K2 pair's with m rounded (K2's `m_out` form) to the bit, and it
    launches no GEMM of the library's own."""
    tensors, cfg = _whole_args(dev, gen, case)
    heads, scale, ws = cfg
    bf_w = [t.to(BF) if i in (1, 3, 9, 11) else t
            for i, t in enumerate(tensors)]
    gemm.launch_counts(reset=True)
    got = swin_block.whole_swin_block(*bf_w, *cfg)
    torch.cuda.synchronize()
    assert gemm.launch_counts() == dict.fromkeys(gemm.FORMS, 0)
    want = swin_block.whole_swin_block_pair(*bf_w, *cfg, m_out=True)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("TN, hd", [(16, 16), (32, 128), (64, 64),
                                    (128, 64), (128, 128), (128, 256)])
def test_whole_block_layout_is_the_plans(dev, TN, hd):
    """The shared memory and attention pairs the kernel launches with
    (`stswin_whole_block_layout`) are those of the Python plan, which the
    CPU tests check phase by phase."""
    heads = max(1, 128 // hd)  # C a multiple of 128
    T, ws = {16: (1, 4), 32: (2, 4), 64: (1, 8), 128: (2, 8)}[TN]
    plan = swin_block.whole_block_plan(1, T, 2 * ws, 2 * ws, hd * heads,
                                       4 * hd * heads, heads, ws)
    assert swin_block._layout(TN, hd) == (plan.attention_group,
                                          plan.smem_bytes)


def test_whole_block_refuses_what_it_does_not_take(dev, gen):
    tensors, (heads, scale, ws) = _whole_args(dev, gen, "s2")
    bf_w = [t.to(BF) if i in (1, 3, 9, 11) else t
            for i, t in enumerate(tensors)]
    x = bf_w[0]
    mask = torch.from_numpy(shifted_window_attention_mask(
        8, 12, ws, 2)).repeat(1, 2, 2).to(dev)
    with pytest.raises(ValueError, match="W-MSA"):
        swin_block.whole_swin_block(x, *bf_w[1:6], mask, *bf_w[7:], heads,
                                    scale, ws)
    with pytest.raises(NotImplementedError):
        swin_block.whole_swin_block(x.float(), *bf_w[1:], heads, scale, ws)
    # three frames: windows of 48 tokens, which do not tile 128 rows
    x3 = torch.zeros((1, 3, 8, 12, x.shape[-1]), device=dev, dtype=BF)
    bias3 = torch.zeros((heads, 48, 48), device=dev)
    with pytest.raises(ValueError, match="tile"):
        swin_block.whole_swin_block(x3, *bf_w[1:5], bias3, None, *bf_w[7:],
                                    heads, scale, ws)


@pytest.mark.parametrize("C", [72, 256, 512])
def test_add_ln_mlp_kernel(dev, gen, C):
    """Row 13: (s, m) against the twin (C 72: off the first kernel's
    multiples of 128), two launches of the Hopper GEMM's bf16 form a
    call, and its Function's gradients (autograd of the twin, as JAX's
    `_bwd`) against autograd of the twin."""
    p = _epi_params(dev, gen, C=C, hidden=4 * C)
    x, y = (torch.randn((3, 50, C), generator=gen, device=dev).to(BF)
            for _ in range(2))
    args = (p[0], p[1], p[2], p[3], p[4], p[5])
    fn = add_ln_mlp.add_ln_mlp
    n = fn.launches
    gemm.launch_counts(reset=True)
    got, want = fn(x, y, *args), add_ln_mlp.add_ln_mlp_ref(x, y, *args)
    assert fn.launches == n + 1
    torch.cuda.synchronize()
    assert gemm.launch_counts() == dict.fromkeys(gemm.FORMS, 0) | {"bf16": 2}
    for a, b in zip(got, want):
        _close(a, b)

    def first(f):
        return lambda *a: sum(o.float().square().sum() for o in f(*a))
    leaves = [t.detach().requires_grad_() for t in (x, y) + args]
    g_k = torch.autograd.grad(first(fn)(*leaves), leaves)
    twin = [t.detach().requires_grad_() for t in (x, y) + args]
    g_t = torch.autograd.grad(first(add_ln_mlp.add_ln_mlp_ref)(*twin), twin)
    for a, b in zip(g_k, g_t):
        _close(a, b)


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
@pytest.mark.parametrize("return_sum", [True, False])
def test_add_layer_norm_kernel(dev, gen, C, return_sum):
    """Row 14 against its twin, and its Function's backward (the formula
    of `_faln_bwd`) against autograd of the twin."""
    x, y = (torch.randn((7, 33, C), generator=gen, device=dev).to(BF)
            for _ in range(2))
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device=dev)
    bias = 0.1 * torch.randn(C, generator=gen, device=dev)
    fn = add_layernorm.add_layer_norm
    n = fn.launches
    s, out = fn(x, y, scale, bias, return_sum=return_sum)
    s_t, out_t = add_layernorm.add_layer_norm_ref(x, y, scale, bias,
                                                  return_sum=return_sum)
    assert fn.launches == n + 1
    _close(out, out_t)
    assert (s is None) == (not return_sum)
    if return_sum:
        assert torch.equal(s, s_t)

    def loss(f, ls):
        s, o = f(*ls, return_sum=return_sum)
        return o.float().square().sum() + (0 if s is None else
                                           s.float().sum())
    leaves = [t.detach().requires_grad_() for t in (x, y, scale, bias)]
    got = torch.autograd.grad(loss(fn, leaves), leaves)
    twin = [t.detach().requires_grad_() for t in (x, y, scale, bias)]
    want = torch.autograd.grad(loss(add_layernorm.add_layer_norm_ref, twin),
                               twin)
    for a, b in zip(got, want):
        _close(a, b)


def test_small_model_whole_block_agrees(dev):
    """TswinPlus at swin_dim 128 in bf16 with `whole_block`: row 16 runs
    once per W-MSA block call, the kernel route agrees with its plain
    route and with the model without it, and streams as the full clip."""
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.ops.resize import composed_upsample_argmax_cf
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter

    kw = dict(num_classes=5, swin_dim=128, swin_depths=(2, 2),
              dtype=BF, input_hw=(128, 192))
    pair = init_weights(TswinPlus(**kw), torch.Generator().manual_seed(0))
    model = TswinPlus(**kw, whole_block=True)
    plain = TswinPlus(**kw, whole_block=True, kernels=False)
    for m in (model, plain):
        m.load_state_dict(pair.state_dict())
    for m in (pair, model, plain):
        m.to(dev).eval()
    frames = torch.rand((1, 5, 128, 192, 3),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev) * 2 - 1
    fn = swin_block.whole_swin_block
    n, n1 = fn.launches, block_attention.swin_block_attention.launches
    with torch.inference_mode():
        lk = model(frames[:, 1:5], head_res_logits=True)
        # depths (2, 2): two W-MSA block calls a stage, each paired with
        # an SW-MSA block call on K1
        assert fn.launches - n == 4
        assert block_attention.swin_block_attention.launches - n1 == 4
        lp = plain(frames[:, 1:5], head_res_logits=True)
        lf = pair(frames[:, 1:5], head_res_logits=True)
    for other in (lp, lf):
        rel = ((lk - other).norm() / other.norm()).item()
        assert rel <= TOL, rel
    seg = StreamingSegmenter(model, out_hw=(256, 384))
    cache, _ = seg.init_and_predict(frames[:, 0:4])
    _, pred = seg.predict_next(cache, frames[:, 4])
    want = composed_upsample_argmax_cf(lk, (128, 192), (256, 384))
    assert (pred == want).float().mean().item() >= 0.999


def _normal(dev, gen):
    return lambda *s, k=1.0: torch.randn(s, generator=gen, device=dev) * k


def _mlp_params(dev, gen, C, hidden, dt=BF):
    f = _normal(dev, gen)
    return [f(hidden, C, k=C ** -0.5).to(dt), f(hidden, k=0.1),
            f(C, hidden, k=hidden ** -0.5).to(dt), f(C, k=0.1)]


@pytest.mark.parametrize("C,hidden", [(32, 512), (64, 256), (512, 2048),
                                      (40, 200), (8, 24)])
@pytest.mark.parametrize("exact", [True, False])
def test_mlp_kernel(dev, gen, C, hidden, exact):
    """Row 12 against its twin (C below the GEMM's 128-column tile and its
    64-deep k tile too, and off the first kernel's multiples of 32), two
    launches of the Hopper GEMM's bf16 form a call, and through `MlpFn`
    with fp32 weights (as `Mlp` hands them): its gradients against
    autograd of the twin on the same weights."""
    p = _mlp_params(dev, gen, C, hidden)
    x = torch.randn((3, 50, C), generator=gen, device=dev).to(BF)
    fn = mlp.fused_mlp
    n = fn.launches
    gemm.launch_counts(reset=True)
    _close(fn(x, *p, exact), mlp.mlp_ref(x, *p, exact))
    assert fn.launches == n + 1
    torch.cuda.synchronize()
    assert gemm.launch_counts() == dict.fromkeys(gemm.FORMS, 0) | {"bf16": 2}
    p32 = [t.float() for t in p]
    leaves = [t.detach().requires_grad_() for t in [x] + p32]
    out = fn(*leaves, exact)
    assert fn.launches == n + 2
    g = torch.randn(out.shape, generator=gen, device=dev).to(BF)
    got = torch.autograd.grad(out, leaves, g)
    twin = [t.detach().requires_grad_() for t in [x] + p32]
    want = torch.autograd.grad(mlp.mlp_ref(*twin, exact), twin, g)
    for leaf, a, b in zip(leaves, got, want):
        assert a.dtype == leaf.dtype
        _close(a, b)


@pytest.mark.parametrize("C", [8, 32, 36, 64, 96, 100, 256, 264, 512, 1024,
                               2048, 2050, 2056, 3072])
def test_layer_norm_kernel(dev, gen, C):
    """Row 15 against its twin at the JAX tests' widths (lanes past C
    idle), the model's, and the wide-row path's (C > 2048 or C % 8 != 0:
    a block a row, a scalar tail), and `LayerNormFn`'s backward (the
    formula of `_fln_bwd`) against autograd of the twin."""
    x = torch.randn((7, 33, C), generator=gen, device=dev).to(BF)
    scale = 1.0 + 0.5 * torch.randn(C, generator=gen, device=dev)
    bias = 0.5 * torch.randn(C, generator=gen, device=dev)
    fn = layernorm.fused_layer_norm
    n = fn.launches
    want = layernorm.layer_norm_ref(x, scale, bias)
    _close(fn(x, scale, bias), want)
    assert fn.launches == n + 1
    # the bound tells a missing affine from rounding
    moved = layernorm.layer_norm_ref(x, scale, torch.zeros_like(bias))
    assert ((moved.float() - want.float()).norm()
            / want.float().norm()).item() > 10 * TOL
    _grads_close(fn, layernorm.layer_norm_ref, [x, scale, bias], ())


@pytest.mark.parametrize("dilation", [1, 2, 4, 18])
@pytest.mark.parametrize("with_res", [False, True])
def test_conv_kernel(dev, gen, dilation, with_res):
    """Row 17 against its twin on 1728 output pixels (13.5 row tiles) and
    96 output channels (a part-filled column tile); at dilation 18 on
    24x36 most taps read padding. A twin with the dilation one off (and,
    with the residual, one without it) misses the bound tenfold."""
    r = _normal(dev, gen)
    x = r(2, 24, 36, 64).to(BF)
    w = r(96, 64, 3, 3, k=(9 * 64) ** -0.5).to(BF)
    scale, shift = 0.5 + r(96).abs(), 0.5 * r(96)
    res = r(2, 24, 36, 96).to(BF) if with_res else None
    fn = conv.conv3x3_bn_act
    n = fn.launches
    kw = dict(dilation=dilation, relu=True, residual=res)
    want = conv.conv3x3_bn_act_ref(x, w, scale, shift, **kw)
    got = fn(x, w, scale, shift, **kw)
    assert fn.launches == n + 1
    _close(got, want)
    faults = [dict(kw, dilation=dilation + 1)]
    if with_res:
        faults.append(dict(kw, residual=None))
    for fault in faults:
        moved = conv.conv3x3_bn_act_ref(x, w, scale, shift, **fault)
        assert ((moved.float() - want.float()).norm()
                / want.float().norm()).item() > 10 * TOL
    # 128 -> 256 channels: whole tiles, no ReLU
    x2, w2 = r(1, 16, 20, 128).to(BF), r(256, 128, 3, 3, k=0.03).to(BF)
    s2, b2 = 0.5 + r(256).abs(), 0.5 * r(256)
    _close(fn(x2, w2, s2, b2, dilation=dilation, relu=False),
           conv.conv3x3_bn_act_ref(x2, w2, s2, b2, dilation=dilation,
                                   relu=False))


@pytest.mark.parametrize("C", [8, 64, 256, 264, 512, 1024, 2048])
def test_layer_norm_kernels_walk_every_row(dev, gen, C):
    """Rows 15 and (C a multiple of 256) 14 on more rows than the
    persistent grid holds at once, a count off every rows-a-block multiple
    (8 warps x 1-4 rows): every row of the grid-stride loop normalised."""
    R = 90001
    x, y = (torch.randn((R, C), generator=gen, device=dev).to(BF)
            for _ in range(2))
    scale = 1.0 + 0.5 * torch.randn(C, generator=gen, device=dev)
    bias = 0.5 * torch.randn(C, generator=gen, device=dev)
    def rows_close(got, want):  # each row to TOL, not only the whole
        d = (got.float() - want.float()).norm(dim=-1)
        assert (d <= TOL * want.float().norm(dim=-1)).all()
    rows_close(layernorm.fused_layer_norm(x, scale, bias),
               layernorm.layer_norm_ref(x, scale, bias))
    if C % 256 == 0:
        s, n = add_layernorm.add_layer_norm(x, y, scale, bias)
        s_t, n_t = add_layernorm.add_layer_norm_ref(x, y, scale, bias)
        assert torch.equal(s, s_t)
        rows_close(n, n_t)


@pytest.mark.parametrize("case", [
    (2, 32, 40, 1024, 512, 18, False),  # the ASPP's shape: d past H / 2
    (3, 20, 36, 32, 8, 2, True),        # Cin 32, Cout 8, W off bw
    (2, 17, 50, 96, 40, 5, True),       # Cin 96: a half-filled k tile
    (1, 64, 80, 256, 256, 2, False),    # the ResNet's tiling, 8 x 16
])
def test_conv_kernel_edge_shapes(dev, gen, case):
    """Row 17 on the Hopper GEMM at its envelope's edges, held against the
    twin, with one launch of the library's "conv" form a call and no
    other GEMM form; a twin with w flipped along kx (every tap's box at
    the mirror offset) misses the bound tenfold."""
    N, H, W, cin, cout, d, with_res = case
    r = _normal(dev, gen)
    x = r(N, H, W, cin).to(BF)
    w = r(cout, cin, 3, 3, k=(9 * cin) ** -0.5).to(BF)
    scale, shift = 0.5 + r(cout).abs(), 0.5 * r(cout)
    res = r(N, H, W, cout).to(BF) if with_res else None
    kw = dict(dilation=d, relu=True, residual=res)
    gemm.launch_counts(reset=True)
    got = conv.conv3x3_bn_act(x, w, scale, shift, **kw)
    forms = gemm.launch_counts(reset=True)
    assert forms == dict.fromkeys(gemm.FORMS, 0) | {"conv": 1}
    want = conv.conv3x3_bn_act_ref(x, w, scale, shift, **kw)
    _close(got, want)
    moved = conv.conv3x3_bn_act_ref(x, w.flip(-1), scale, shift, **kw)
    assert ((moved.float() - want.float()).norm()
            / want.float().norm()).item() > 10 * TOL


def test_offpath_kernels_refuse_what_they_do_not_take(dev, gen):
    """fp32 activations and shapes outside each kernel's rule raise."""
    p = _mlp_params(dev, gen, 64, 256)
    x = torch.zeros((4, 64), device=dev, dtype=BF)
    with pytest.raises(NotImplementedError):
        mlp.fused_mlp(x.float(), *p)
    p44 = _mlp_params(dev, gen, 44, 256)
    with pytest.raises(ValueError, match="multiples of 8"):
        mlp.fused_mlp(torch.zeros((4, 44), device=dev, dtype=BF), *p44)
    p52 = _epi_params(dev, gen, C=52, hidden=208)
    x52 = torch.zeros((4, 52), device=dev, dtype=BF)
    with pytest.raises(ValueError, match="multiples of 8"):
        add_ln_mlp.add_ln_mlp(x52, x52, *p52[:6])
    s, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(NotImplementedError):
        layernorm.fused_layer_norm(x.float(), s, b)
    with pytest.raises(ValueError, match="scale"):  # scale of another width
        layernorm.fused_layer_norm(torch.zeros((4, 36), device=dev, dtype=BF),
                                   s, b)
    xi = torch.zeros((1, 8, 8, 64), device=dev, dtype=BF)
    w = torch.zeros((64, 64, 3, 3), device=dev, dtype=BF)
    with pytest.raises(NotImplementedError):
        conv.conv3x3_bn_act(xi.float(), w, s, b)
    for xs, ws in (((1, 8, 8, 48), (64, 48, 3, 3)),  # Cin off 32
                   ((1, 8, 8, 64), (64, 64, 1, 1))):  # 1x1
        with pytest.raises(ValueError, match="Cin a multiple of 32"):
            conv.conv3x3_bn_act(torch.zeros(xs, device=dev, dtype=BF),
                                torch.zeros(ws, device=dev, dtype=BF), s, b)


def test_offpath_modules_route_to_their_kernels(dev, gen):
    """`Mlp` and `FusedLayerNorm` on a CUDA input launch rows 12 and 15
    once a forward, agree with their plain routes (`kernels=False`), and
    their parameters' gradients agree too."""
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.models.swin import Mlp

    x = torch.randn((2, 2, 8, 12, 128), generator=gen, device=dev).to(BF)
    m = init_weights(Mlp(128, 512, 128, dtype=BF),
                     torch.Generator().manual_seed(0)).to(dev)
    plain = Mlp(128, 512, 128, dtype=BF, kernels=False).to(dev)
    plain.load_state_dict(m.state_dict())
    ln = layernorm.FusedLayerNorm(128).to(dev)
    with torch.no_grad():
        ln.weight.add_(0.5 * torch.randn(128, generator=gen, device=dev))
        ln.bias.add_(0.5 * torch.randn(128, generator=gen, device=dev))
    ln_plain = layernorm.FusedLayerNorm(128, kernels=False).to(dev)
    ln_plain.load_state_dict(ln.state_dict())
    for mod, twin, fn in ((m, plain, mlp.fused_mlp),
                          (ln, ln_plain, layernorm.fused_layer_norm)):
        n = fn.launches
        out = mod(x)
        assert fn.launches == n + 1
        ref = twin(x)
        _close(out, ref)
        g = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        out.backward(g)
        ref.backward(g)
        for (name, a), b in zip(mod.named_parameters(), twin.parameters()):
            assert a.grad.dtype == torch.float32, name
            _close(a.grad, b.grad)


def _counted_wrappers():
    """Every kernel wrapper that counts its launches."""
    return [block_attention.swin_block_attention,
            block_attention.swin_block_attention_bwd,
            block_attention.windowed_attention_image,
            attention.fused_window_attention,
            add_ln_mlp.swin_block_epilogue,
            add_ln_mlp.swin_block_epilogue_bwd, add_ln_mlp.add_ln_mlp,
            patch_merge.patch_merge, upsample_argmax.upsample_argmax,
            swin_block.whole_swin_block, add_layernorm.add_layer_norm,
            mlp.fused_mlp, layernorm.fused_layer_norm,
            conv.conv3x3_bn_act, gemm.linear_sm90, gemm.gelu_bwd_sm90,
            gemm.wgrad_sm90]


def test_fp32_model_runs_on_the_twins(dev):
    """`build_model` with dtype "float32" serves one `init_and_predict` +
    `predict_next` and takes one stage-1 train step on the card, on the
    plain twins: predictions in [0, classes), a finite loss, and no kernel
    launched."""
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.models.init import init_weights
    from stswincl_tpu_torch.pipelines.common import build_model
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.pipelines.streaming import StreamingSegmenter
    from stswincl_tpu_torch.train.train_seg import make_seg_train_step

    mc = ModelConfig(swin_dim=128, swin_depths=(2, 2), dtype="float32")
    dc = DataConfig(dataset="synthetic", crop_hw=(128, 192), batch_size=2)
    model, classes = build_model(mc, dc, device=dev)
    assert model.kernels is False
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    before = [fn.launches for fn in _counted_wrappers()]
    g = torch.Generator(device=dev).manual_seed(2)
    frames = torch.rand((2, 5, 128, 192, 3), generator=g, device=dev) * 2 - 1
    seg = StreamingSegmenter(model.eval(), out_hw=(256, 384))
    cache, _ = seg.init_and_predict(frames[:, 0:4])
    _, pred = seg.predict_next(cache, frames[:, 4])
    assert pred.shape == (2, 256, 384)
    assert 0 <= int(pred.min()) and int(pred.max()) < classes
    cfg = SegTrainConfig(model=mc, data=dc)
    opt, schedule = make_tx(cfg, 1, model)
    step = make_seg_train_step(model, opt, schedule, cfg.loss,
                               ohem_thresh=cfg.ohem_thresh)
    labels = torch.randint(-1, classes, (2, 128, 192), generator=g,
                           device=dev)
    loss = float(step(frames[:, 0:4], labels)["loss"])
    assert loss == loss and abs(loss) < float("inf")
    assert [fn.launches for fn in _counted_wrappers()] == before


@pytest.mark.parametrize("M,N,K", [(300, 384, 512), (1000, 136, 200),
                                   (384, 1536, 512), (64, 2048, 1024)])
@pytest.mark.parametrize("epi,act", [("bf16", "none"), ("bf16", "erf"),
                                     ("bf16", "tanh"), ("resid_f32", "none"),
                                     ("f32", "none")])
def test_gemm_sm90_kernel(dev, gen, M, N, K, epi, act):
    """The Hopper GEMM (wgmma + TMA) against torch.matmul in fp32 at ragged
    M, N and K (a part-filled last tile in each), with each epilogue."""
    r = _normal(dev, gen)
    a, wt = r(M, K).to(BF), r(N, K, k=K ** -0.5).to(BF)
    bias = r(N, k=0.1) if act != "none" or M % 2 else None
    out = r(M, N) if epi != "bf16" else None
    fn = gemm.linear_sm90
    n = fn.launches
    got = fn(a, wt, bias, act, out=None if out is None else out.clone(),
             epi=epi)
    assert fn.launches == n + 1
    want = a.float() @ wt.float().t()
    if bias is not None:
        want = want + bias
    if act != "none":
        want = mlp.gelu(want, act == "erf")
    if epi == "bf16":
        want = want.to(BF)
    elif epi == "resid_f32":
        want = want + out
    _close(got, want)
    _close(got, gemm.linear_sm90_ref(a, wt, bias, act, out=out, epi=epi))


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("ws", [2, 4])
def test_gemm_sm90_row_maps(dev, gen, shift, ws):
    """K1's two uses: A rows gathered through the window partition and the
    cyclic shift (T 2: a TMA box per window, cp.async for the tiles whose
    windows the shift wraps; T 3 with ws 2: windows of 12 tokens, all by
    cp.async), and C rows scattered back to the image layout, on 4.5 or
    more row tiles and a ragged k tile."""
    B, H, W = 3, 8, 12
    T = 2 if ws == 4 else 3
    M, N, K = B * T * H * W, 264, 136
    r = _normal(dev, gen)
    a, wt, bias = r(M, K).to(BF), r(N, K, k=K ** -0.5).to(BF), r(N, k=0.1)
    grid = (T, H, W, ws)
    for a_map, c_map in (((*grid, shift), None), (None, (*grid, 0)),
                         ((*grid, shift), (*grid, 0))):
        got = gemm.linear_sm90(a, wt, bias, a_map=a_map, c_map=c_map)
        want = gemm.linear_sm90_ref(a, wt, bias, a_map=a_map, c_map=c_map)
        _close(got, want)
        rows_a = gemm.window_rows(M, a_map, dev)
        rows_c = gemm.window_rows(M, c_map, dev)
        mm = torch.empty_like(want)
        mm[rows_c] = (torch.matmul(a[rows_a].float(), wt.float().t())
                      + bias).to(BF)
        _close(got, mm)


@pytest.mark.parametrize("M,N,K", [(300, 512, 128), (1000, 256, 256)])
@pytest.mark.parametrize("act,with_h", [("erf", True), ("erf", False),
                                        ("tanh", True)])
def test_gelu_bwd_sm90_kernel(dev, gen, M, N, K, act, with_h):
    """K6's fused pair (pre = n2 w1^T + b1 and dh = dm w2 in one tile) at
    a ragged row count: dpre, h and the db1 column sums against the
    twin."""
    r = _normal(dev, gen)
    n2, dm = r(M, K).to(BF), r(M, K).to(BF)
    w1, w2_t = r(N, K, k=K ** -0.5).to(BF), r(N, K, k=K ** -0.5).to(BF)
    b1 = r(N, k=0.1)
    fn = gemm.gelu_bwd_sm90
    n = fn.launches
    got = fn(n2, dm, w1, w2_t, b1, act, with_h)
    assert fn.launches == n + 1
    want = gemm.gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1, act, with_h)
    assert (got[1] is None) == (not with_h)
    for a, b in zip(got, want):
        if b is not None:
            _close(a, b)


@pytest.mark.parametrize("M,N,K", [(300, 512, 128), (1000, 256, 256)])
def test_gemm_sm90_gelu_through_memory(dev, gen, M, N, K):
    """K6's products when m is recomputed (Pallas row 7): fc1 writing h
    and gelu' (epilogue "gelu_grad"), then dh times that gelu' with the
    db1 column sums ("dgelu"), at a ragged row count, against the twins
    and against the fused pair's twin on the same operands."""
    r = _normal(dev, gen)
    n2, dm = r(M, K).to(BF), r(M, K).to(BF)
    w1, w2_t = r(N, K, k=K ** -0.5).to(BF), r(N, K, k=K ** -0.5).to(BF)
    b1 = r(N, k=0.1)
    fn = gemm.linear_sm90
    n = fn.launches
    h, d = fn(n2, w1, b1, "erf", epi="gelu_grad")
    want_h, want_d = gemm.linear_sm90_ref(n2, w1, b1, "erf", epi="gelu_grad")
    _close(h, want_h)
    _close(d, want_d)
    dpre, db1 = fn(dm, w2_t, epi="dgelu", aux=d)
    assert fn.launches == n + 2
    want = gemm.gelu_bwd_sm90_ref(n2, dm, w1, w2_t, b1)
    _close(dpre, want[0])
    _close(h, want[1])
    _close(db1, want[2])


WGRAD_CASES = {  # (R or grid (B, T, H, W, ws, shift), M, N, a gathered,
    # b gathered): K6's identity products at ragged R, K5's dwqkv (x
    # through the shifted window partition: frames of a window by 4-D
    # boxes at ws 8, whole windows at ws 4, the wrapped ones by cp.async;
    # 12-token windows all by cp.async) and dwproj (g through the window
    # partition)
    "k6 dw1 ragged": (3000, 512, 128, False, False),
    "k6 dw2 ragged": (1000, 128, 512, False, False),
    "k5 dwqkv s1 w": ((2, 2, 16, 24, 8, 0), 384, 128, False, True),
    "k5 dwqkv s1 sw": ((2, 2, 16, 24, 8, 4), 384, 128, False, True),
    "k5 dwqkv s2 sw": ((3, 2, 8, 12, 4, 2), 768, 256, False, True),
    "k5 dwqkv ws2 sw": ((2, 3, 8, 12, 2, 1), 384, 128, False, True),
    "k5 dwproj s1": ((2, 2, 16, 24, 8, 0), 128, 128, True, False),
    "k5 dwproj s2": ((3, 2, 8, 12, 4, 0), 256, 256, True, False),
}


@pytest.mark.parametrize("case", sorted(WGRAD_CASES))
def test_wgrad_sm90_kernel(dev, gen, case):
    """The weight-gradient GEMM (MN-major wgmma, split reduction, 16-byte
    reductions) against torch.matmul in fp32 on the gathered rows."""
    geo, M, N, a_gather, b_gather = WGRAD_CASES[case]
    rmap = None
    if isinstance(geo, tuple):
        B, T, H, W, ws, shift = geo
        R, rmap = B * T * H * W, (T, H, W, ws, shift)
    else:
        R = geo
    r = _normal(dev, gen)
    a, b = r(R, M).to(BF), r(R, N).to(BF)
    a_map, b_map = (rmap if a_gather else None), (rmap if b_gather else None)
    fn = gemm.wgrad_sm90
    n = fn.launches
    got = fn(a, b, a_map, b_map)
    assert fn.launches == n + 1
    ra = gemm.window_rows(R, a_map, dev)
    rb = gemm.window_rows(R, b_map, dev)
    want = torch.matmul(a[ra].float().t(), b[rb].float())
    assert got.dtype == torch.float32
    _close(got, want)
    _close(got, gemm.wgrad_sm90_ref(a, b, a_map, b_map))


TRAIN_SHAPES = {  # (x shape, heads, ws): the batch-8 block shapes
    "stage1": ((16, 2, 64, 80, 512), 4, 8),
    "stage2": ((16, 2, 32, 40, 1024), 4, 4),
}


@pytest.mark.parametrize("stage", sorted(TRAIN_SHAPES))
@pytest.mark.parametrize("shifted", [False, True])
def test_backward_kernels_at_training_shapes(dev, gen, stage, shifted):
    """K5 and K6 against their twins at the full training shapes of both
    stages (K6 with m recomputed at stage 1, saved at stage 2, as the
    Function routes it), and the Hopper GEMM launches the library counts
    inside K1, K2, K5 and K6, by form."""
    shape, heads, ws = TRAIN_SHAPES[stage]
    B, T, H, W, C = shape
    shift = ws // 2 if shifted else 0
    args = _attn_args(dev, gen, shift, B=B, T=T, H=H, W=W, C=C, heads=heads,
                      ws=ws)
    g = torch.randn(shape, generator=gen, device=dev).to(BF)
    gemm.launch_counts(reset=True)
    _, qkv, attn = block_attention._forward_kernel(*args)
    got = block_attention.swin_block_attention_bwd(
        args[0], g, qkv, attn, args[1], args[3], *args[5:])
    del qkv, attn
    forms = gemm.launch_counts(reset=True)
    # K1: qkv, proj; K5: dattn, dx, dwqkv, dwproj
    assert forms == dict.fromkeys(gemm.FORMS, 0) | {"bf16": 4, "wgrad": 2}
    want = block_attention.swin_block_attention_bwd_ref(*args[:7], g,
                                                        *args[7:])
    for a, b in zip(got, want):
        _close(a, b, same_dtype=False)
    del got, want
    p = _epi_params(dev, gen, C=C, hidden=4 * C)
    y = torch.randn(shape, generator=gen, device=dev).to(BF)
    kw = dict(gelu_exact=True, shift=shift, ws=ws)
    m = None
    saved = add_ln_mlp.mlp_output_saved(C, 4 * C, BF)
    assert saved == (stage == "stage2")
    if saved:
        m = add_ln_mlp._forward_kernel(args[0], y, *p, **kw, eps=1e-5,
                                       with_m=True)[1]
    got = add_ln_mlp.swin_block_epilogue_bwd(args[0], y, g, m, *p[:7], **kw)
    # K2 with m: fc1, fc2 (bf16 m); K6: dn2 and dw1, dw2, and with m saved
    # the fused pair, else fc1 + gelu', m and dh * gelu'
    want = (dict(bf16=2, gelu_bwd=1) if saved
            else dict(gelu_grad=1, bf16=1, dgelu=1))
    assert gemm.launch_counts() == (dict.fromkeys(gemm.FORMS, 0) | want
                                    | dict(f32=1, wgrad=2))
    want = add_ln_mlp.swin_block_epilogue_bwd_ref(args[0], y, *p, g, **kw)
    for a, b in zip(got, want):
        _close(a, b, same_dtype=False)


def test_trained_block_refuses_a_window_k5_does_not_take(dev, gen):
    """TN 144 x hd 64: K1's forward takes the window, K5's attention
    backward does not (at most 8 key tiles of 16). Without a gradient K1
    runs it; with one, `BlockAttentionFn` and the whole-block Function
    refuse it before any kernel launches, not in the backward."""
    args = _attn_args(dev, gen, 0, B=1, T=1, H=12, W=12, C=128, heads=2,
                      ws=12)
    fn = block_attention.swin_block_attention
    n = fn.launches
    _close(fn(*args), block_attention.swin_block_attention_ref(*args))
    assert fn.launches == n + 1
    x = args[0].clone().requires_grad_()
    with pytest.raises(ValueError, match="at most 128 tokens"):
        fn(x, *args[1:])
    assert fn.launches == n + 1
    p = _epi_params(dev, gen, C=128, hidden=512)
    whole = swin_block.whole_swin_block
    n = whole.launches
    with pytest.raises(ValueError, match="at most 128 tokens"):
        whole(x, *args[1:7], *p, 2, args[8], 12)
    assert whole.launches == n
