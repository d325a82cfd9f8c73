"""The port's CUDA kernels against their plain twins, bf16, on a CUDA card.

These tests import neither JAX nor the JAX package, and skip without a
card. On the machine with the card (which has no JAX, while
`tests/conftest.py` imports it) run them without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are small but within what the kernels take (C a multiple of 128);
their row counts are not multiples of the GEMM's 128-row tile, so the
ragged edges run too.
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


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
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
