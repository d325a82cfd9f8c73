"""The port's CUDA kernels against their plain twins, bf16, on a CUDA card.

These tests import neither JAX nor the JAX package, and skip without a
card. On the machine with the card (which has no JAX, while
`tests/conftest.py` imports it) run them without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small but within what the kernels take (C a multiple of 128);
their row counts are not multiples of the GEMM's 128-row tile, so the
ragged edges run too. The backward kernels (K5, K6) are held against
autograd of their twins at mid sizes that keep the stage-1 and stage-2
window shapes (TN 128 / hd 64, TN 32 / hd 128).
"""

import pytest
import torch

from stswincl_tpu_torch.ops import add_ln_mlp, block_attention
from stswincl_tpu_torch.ops import patch_merge, upsample_argmax
from stswincl_tpu_torch.ops.resize import composed_matrices
from stswincl_tpu_torch.ops.window import (relative_position_index,
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


def _attn_args(dev, gen, shift, B=2, T=2, H=8, W=12, C=128, heads=2, ws=4):
    r = lambda *s, k=1.0, dt=BF: (torch.randn(s, generator=gen, device=dev)
                                  * k).to(dt)
    N, TN = ws * ws, T * ws * ws
    table = r((2 * ws - 1) ** 2, heads, k=0.02, dt=torch.float32)
    idx = torch.from_numpy(relative_position_index(ws, ws)).long().to(dev)
    bias = table[idx.reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)
    mask = None
    if shift:
        mask = torch.from_numpy(shifted_window_attention_mask(
            H, W, ws, shift)).repeat(1, T, T).to(dev)
    return [r(B, T, H, W, C), r(3 * C, C, k=C ** -0.5),
            r(3 * C, k=0.1, dt=torch.float32), r(C, C, k=C ** -0.5),
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


def test_fp32_activations_are_refused(dev, gen):
    args = _attn_args(dev, gen, 0)
    args[0] = args[0].float()
    with pytest.raises(NotImplementedError):
        block_attention.swin_block_attention(*args)


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
