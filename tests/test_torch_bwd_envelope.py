"""The training backwards' envelope: K5 (Pallas row 6) and K6 (rows 7, 9)
take every window and width their forwards take.

- K5's twin against the JAX package's `fused_swin_block_attention_bwd`
  (interpret mode, fp32 on the CPU) at windows past the old one-pass
  kernel's: 144 and 176 tokens (ws 6 and 4) and head dim 256 (one head);
- K6's twin against `fused_epilogue_bwd` (row 7) and
  `fused_epilogue_bwd_streamed` (row 9), interpreted, at C 384;
- over a grid of (tokens, head dim) and of C, each backward's wrapper
  accepts exactly what its forward's accepts, in both dtypes (and the
  fp32 forms of K1, K5 and rows 10-11 exactly the bf16 K1's windows): the
  wrappers run on meta tensors that report `is_cuda`, with the library's
  launch and queries replaced by recorders (no card needed), so the test
  holds the wrappers' own checks, not a copy of them.

Tolerances: rtol = atol = 2e-4 against the Pallas kernels, as
`tests/test_torch_train_kernels.py` holds the same twins at the
training shapes (fp32 sums in another order).
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
from stswincl_tpu_torch.ops import (add_ln_mlp, attention,  # noqa: E402
                                  block_attention)
from stswincl_tpu_torch.ops.attention import (  # noqa: E402
    MAX_WINDOW_TOKENS, _attn_plan_bytes, _attn_smem_bytes)

torch.set_num_threads(1)
T_ = torch.from_numpy
TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **TOL)


# (T, H, W, C, heads, ws): TN 144 (ws 6, T 4), TN 176 (ws 4, T 11), TN 128
# at hd 256 (ws 8, one head): past the bf16 slot kernel; and, past K5
# fp32's resident passes (its streamed ones), TN 128 at hd 192, TN 32 at
# hd 384 and 512, TN 176 at hd 208
ATTN_CASES = {
    "TN144": (4, 12, 12, 32, 2, 6),
    "TN176": (11, 8, 8, 32, 2, 4),
    "hd256": (2, 16, 8, 256, 1, 8),
    "hd192": (2, 16, 8, 192, 1, 8),
    "TN32 hd384": (2, 8, 4, 384, 1, 4),
    "TN32 hd512": (2, 8, 4, 512, 1, 4),
    "TN176 hd208": (11, 8, 4, 208, 1, 4),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("shifted", [False, True])
def test_attention_bwd_twin_matches_pallas_past_the_slot(rng, case,
                                                         shifted):
    """K5's twin (the CPU path of both forms) == the interpreted Pallas
    row 6 in fp32, routed as `_fsba_bwd` routes it (x rolled into the
    shifted layout, dx rolled back), at the windows the bf16 kernel takes
    through its two passes and those K5 fp32 takes through its streamed
    passes."""
    T, H, W, C, heads, ws = ATTN_CASES[case]
    shift = ws // 2 if shifted else 0
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    N, TN = ws * ws, T * ws * ws
    hd = C // heads
    assert (not block_attention._attn_bwd_slot_takes(TN, hd)
            or not block_attention._attn_f32_bwd_resident(TN, hd))
    table = f((2 * ws - 1) ** 2, heads, k=0.1)
    idx = relative_position_index(ws, ws)
    bias = np.tile(table[idx.reshape(-1)].reshape(N, N, heads)
                   .transpose(2, 0, 1), (1, T, T))
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, shift),
                    (1, T, T)) if shift else None)
    x, g = f(1, T, H, W, C, k=0.3), f(1, T, H, W, C, k=0.3)
    wqkv, bqkv = f(C, 3 * C, k=0.1), f(3 * C, k=0.1)
    wproj, bproj = f(C, C, k=0.1), f(C, k=0.1)
    scale = (C // heads) ** -0.5
    jmask = (jnp.zeros((1, TN, TN), jnp.float32) if mask is None
             else jnp.asarray(mask))
    xs = jnp.roll(jnp.asarray(x), (-shift, -shift), axis=(2, 3))
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = \
        jattn.fused_swin_block_attention_bwd(
            xs, jnp.asarray(wqkv), jnp.asarray(bqkv), jnp.asarray(wproj),
            jnp.asarray(bias), jmask, jnp.asarray(g), heads, scale, ws,
            interpret=True)
    dx = jnp.roll(dx, (shift, shift), axis=(2, 3))
    got = block_attention.swin_block_attention_bwd_ref(
        T_(x), T_(wqkv.T.copy()), T_(bqkv), T_(wproj.T.copy()), T_(bproj),
        T_(bias), None if mask is None else T_(mask), T_(g), heads, scale,
        ws, shift)
    want = (dx, np.asarray(dwqkv).T, dbqkv, np.asarray(dwproj).T, dbproj,
            dbias)
    for name, a, b in zip(NAMES, got, want):
        _close(a.numpy(), np.asarray(b).reshape(a.shape),
               f"{name} ({case}, shift {shift})")


EPI = ("s2", "b2", "w1", "b1", "w2", "bw2", "s1", "b1n")


def _epi_case(rng, C=384, rows=48):
    hidden = 4 * C
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(
        np.float32)
    return dict(x=f(rows, C), y=f(rows, C), g=f(rows, C),
                s2=f(C, k=0.1, o=1.0), b2=f(C, k=0.1),
                w1=f(C, hidden, k=0.05), b1=f(hidden, k=0.1),
                w2=f(hidden, C, k=0.05), bw2=f(C, k=0.1),
                s1=f(C, k=0.1, o=1.0), b1n=f(C, k=0.1))


def _epi_port(c):
    return [T_(c["x"]), T_(c["y"])] + [
        T_(np.ascontiguousarray(c[k].T if k in ("w1", "w2") else c[k]))
        for k in EPI]


@pytest.mark.parametrize("row", ["row7", "row9"])
def test_epilogue_bwd_twin_matches_pallas_at_c384(rng, row):
    """K6's twin == the interpreted `fused_epilogue_bwd` (row 7, m
    recomputed) and `fused_epilogue_bwd_streamed` (row 9, given row 8's
    m) at C 384 (`swin_dim` 384), a width the kernels' row passes took
    no template for before."""
    c = _epi_case(rng)
    j = [jnp.asarray(c[k]) for k in ("x", "y", *EPI)]
    g = jnp.asarray(c["g"])
    if row == "row7":
        grads = jepi.fused_epilogue_bwd(*j[:9], g, True, 1e-5, True)
    else:
        _, m = jepi._fused_epilogue_fwd_with_m(*j, True, 1e-5, True)
        grads = jepi.fused_epilogue_bwd_streamed(*j[:9], g, m, True, 1e-5, 2,
                                                 True)
    ds, *vec = grads
    got = add_ln_mlp.swin_block_epilogue_bwd_ref(*_epi_port(c), T_(c["g"]))
    _close(got[0].numpy(), ds, "dx")
    _close(got[1].numpy(), ds, "dy")
    for name, a, b in zip(EPI, got[2:], vec):
        b = np.asarray(b)
        _close(a.numpy(), b.T if name in ("w1", "w2") else b, name)


@pytest.fixture
def card_free(monkeypatch):
    """Meta tensors take the card's branches: `is_cuda` reports True, the
    library's launches are recorded and its queries answer 16 floats."""
    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: launched.append(name))
    monkeypatch.setattr(kernels, "query", lambda name, *a: 16)
    monkeypatch.setattr(kernels, "use_device", lambda dev: 0)
    return launched


def _accepts(call) -> bool:
    try:
        call()
    except ValueError:
        return False
    return True


def _k1_core_takes(TN, hd):
    """K1's attention core on its own terms (`check_attention_core` with
    K1's shared-memory plan)."""
    from stswincl_tpu_torch.ops.attention import check_attention_core
    bias = torch.empty((1, TN, TN), dtype=torch.float32, device="meta")
    return _accepts(lambda: check_attention_core(
        "k1", torch.device("meta"), bias, None, 1, TN, hd))


# (T, ws): TN = T ws^2 = 16 T at ws 4 (T 1..12 and 18: 288), and two token
# counts off 16 (9 at ws 3, 20 at ws 2); hd 8..2048 (12, 20, 36 and 1212
# off 8)
K5_WINDOWS = [(T, 4) for T in (1, 2, 3, 8, 9, 11, 12, 18)] + [(1, 3), (5, 2)]
K5_HDS = (8, 12, 16, 20, 24, 36, 48, 64, 144, 160, 192, 208, 216, 224, 256,
          288, 296, 304, 320, 440, 512, 640, 1024, 1208, 1212, 1280, 2048)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_takes_exactly_the_windows_k1_takes(card_free, dtype):
    """Over a grid of (tokens, head dim) (C = 4 hd over 4 heads), in both
    dtypes: K5's wrapper (`swin_block_attention_bwd` /
    `swin_block_attention_bwd_f32`, `check_backward_window`), K1's
    (`_forward_kernel` / `_forward_f32`), row 10's and row 11's accept
    exactly the windows K1's bf16 attention core accepts (`_attn_bwd_takes`,
    `check_attention_core`): a token count a multiple of 16 up to 176 and
    a head dim a multiple of 8, whatever its size, through the resident or
    the streamed instances; TN 192 and 288, token counts off 16 and head
    dims off 8 are refused. (128, 304), past the bf16 core's resident
    pair, is taken."""
    meta = dict(dtype=dtype, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    bf = dtype == torch.bfloat16
    fwd = (block_attention._forward_kernel if bf
           else block_attention._forward_f32)
    bwd = (block_attention.swin_block_attention_bwd if bf
           else block_attention.swin_block_attention_bwd_f32)
    rows = []
    for T, ws in K5_WINDOWS:
        for hd in K5_HDS:
            TN, C, heads = T * ws * ws, 4 * hd, 4
            x = torch.empty((1, T, ws, ws, C), **meta)
            w = (torch.empty((3 * C, C), **meta), torch.empty(3 * C, **f32),
                 torch.empty((C, C), **meta), torch.empty(C, **f32))
            bias = torch.empty((heads, TN, TN), **f32)
            scale = hd ** -0.5
            k1 = _accepts(lambda: fwd(x, *w, bias, None, heads, scale, ws, 0))
            qkv = torch.empty((TN, 3 * C), **meta)
            attn = torch.empty((TN, C), **meta)
            k5 = _accepts(lambda: bwd(x, x, qkv, attn, w[0], w[2], bias,
                                      None, heads, scale, ws, 0))
            win = _accepts(lambda: block_attention.check_backward_window(
                "k5", x, heads, ws))
            img = torch.empty((1, T, ws, ws, 3 * C), **meta)
            row10 = _accepts(lambda: block_attention._image_kernel(
                img, bias, None, heads, scale, ws))
            q = torch.empty((1, heads, TN, hd), **meta)
            row11 = _accepts(lambda: attention._heads_kernel(
                q, q, q, bias, None, scale))
            rows.append((TN, hd, k1))
            assert k5 == win, (TN, hd)
            assert k1 == k5 == row10 == row11 == _k1_core_takes(TN, hd), (
                TN, hd, k1, k5, row10, row11)
            assert k5 == block_attention._attn_bwd_takes(TN, hd)
    took = {(TN, hd) for TN, hd, k1 in rows if k1}
    assert took == {(TN, hd) for TN, hd, _ in rows
                    if TN % 16 == 0 and TN <= MAX_WINDOW_TOKENS
                    and hd % 8 == 0}
    assert {(176, 208), (128, 288), (144, 256), (128, 192), (32, 320),
            (128, 304), (176, 224), (128, 2048), (32, 1280), (16, 2048)
            } <= took
    assert {(128, 8), (128, 24), (32, 48), (176, 8)} <= took
    assert not {(192, 64), (288, 64), (9, 64), (20, 64), (128, 1212)} & took
    assert max(TN for TN, _ in took) == MAX_WINDOW_TOKENS
    # past the resident pair the streamed one runs: (128, 304) did not fit
    assert _attn_smem_bytes(128, 304) > kernels.SMEM_LIMIT
    assert all(_attn_plan_bytes(TN, hd) <= kernels.SMEM_LIMIT
               for TN, hd in took)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_takes_exactly_the_widths_k2_takes(card_free, dtype):
    """Over C = 8 .. 2112 (hidden 4C) and three widths off 8: K6's
    wrapper (rows 7 and 9, m recomputed and given) accepts exactly the
    widths K2's forward accepts in the same dtype: every C % 8, so 32, 96,
    192 and 384 among them, where the row passes used to refuse all but
    multiples of 128 (and before those all but 128, 256, 512 and 1024)."""
    meta = dict(dtype=dtype, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    bf = dtype == torch.bfloat16
    took = []
    for C in [12, 100, 516] + list(range(8, 2113, 8)):
        hidden = 4 * C
        x = torch.empty((2, 2, 4, 4, C), **meta)
        p = (torch.empty(C, **f32), torch.empty(C, **f32),
             torch.empty((hidden, C), **meta), torch.empty(hidden, **f32),
             torch.empty((C, hidden), **meta), torch.empty(C, **f32),
             torch.empty(C, **f32), torch.empty(C, **f32))
        kw = dict(gelu_exact=True, shift=2, ws=4)
        if bf:
            k2 = _accepts(lambda: add_ln_mlp._forward_kernel(
                x, x, *p, True, 2, 4, 1e-5, with_m=False))
            k2m = _accepts(lambda: add_ln_mlp._forward_kernel(
                x, x, *p, True, 2, 4, 1e-5, with_m=True))
            bwd = add_ln_mlp.swin_block_epilogue_bwd
        else:
            k2 = _accepts(lambda: add_ln_mlp.swin_block_epilogue_f32(
                x, x, *p, True, 2, 4, 1e-5, m_out=False))
            k2m = _accepts(lambda: add_ln_mlp.swin_block_epilogue_f32(
                x, x, *p, True, 2, 4, 1e-5, m_out=True))
            bwd = add_ln_mlp.swin_block_epilogue_bwd_f32
        row7 = _accepts(lambda: bwd(x, x, x, None, *p[:7], **kw))
        row9 = _accepts(lambda: bwd(x, x, x, x, *p[:7], **kw))
        assert k2 == k2m == row7 == row9, (C, k2, k2m, row7, row9)
        if k2:
            took.append(C)
    assert took == list(range(8, 2113, 8))
