"""Every Swin width the JAX kernels take: the port's CPU path against the
JAX package's Pallas kernels (interpret mode) at channel widths and head
dims off 128 and 32, in fp32 and bf16.

(C, heads) = (32, 4) hd 8, (64, 4) hd 16, (96, 4) hd 24 and (192, 4) hd
48, each at both stages' window shapes, TN 128 (ws 8, T 2) and TN 32 (ws
4, T 2) (and, for K1 and rows 10-11 in fp32, the windows past the fp32
core's resident pair, one head: hd 192 and 256 at TN 128, 384 and 512 at
TN 32, 208 at TN 176):
- K1 (`fused_swin_block_attention`, Pallas row 1), W-MSA and SW-MSA;
- K2's two epilogues (rows 2 and 3) and its m form (row 8);
- K5 (`fused_swin_block_attention_bwd`, row 6);
- K6 (`fused_epilogue_bwd`, row 7, and `fused_epilogue_bwd_streamed`, row
  9, given row 8's m);
- rows 10 (`windowed_attention_image`) and 11 (`fused_window_attention`),
  forward and backward, masked;
and a whole `TswinPlus(swin_dim=96)` against `JTswinPlus` on weights
carried by `ckpt.from_jax`, fp32. On meta tensors that report `is_cuda`
(no card), the guards of `gemm.wgrad_sm90` and of K2's / K6's
`_geometry` take exactly the widths of the new rule: multiples of 8.

Tolerances, fp32, those the existing files use for the same functions:
K1 rtol = atol = 1e-5 (`tests/test_torch_kernels.py`); the epilogues
rtol 1e-4, atol 1e-5 (`tests/test_torch_kernels.py`); K5 and K6 rtol =
atol = 2e-4 (`tests/test_torch_train_kernels.py`); rows 10 and 11
||port - jax|| / ||jax|| <= 1e-5 (`tests/test_torch_attn_routes.py`);
the whole model's logits 1e-5 (`tests/test_torch_model.py`). bf16: both
sides round at the same points (q, k, v, P, the outputs; the MLP hidden
and m) from fp32 sums taken in other orders, so an element may sit one
bf16 step (2^-8 relative) off and a rounded input may carry that step
into the next product: ||port - jax|| / ||jax|| <= 1e-2 for every output
and gradient (the largest seen on these cases is 4.2e-3, K6's at hd 16
and TN 128; K1's 2.2e-4).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.ops import pallas_add_ln_mlp as jepi  # noqa: E402
from stswincl_tpu.ops import pallas_attention as jpa  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jattn  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.ops import add_ln_mlp, block_attention, gemm  # noqa: E402
from stswincl_tpu_torch.ops.attention import fused_window_attention  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

WIDTHS = {"hd8": (32, 4), "hd16": (64, 4), "hd24": (96, 4),
          "hd48": (192, 4)}
WINDOWS = {"tn128": (2, 16, 16, 8), "tn32": (2, 8, 8, 4)}  # (T, H, W, ws)
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_REL = 1e-2
K1_TOL = dict(rtol=1e-5, atol=1e-5)
EPI_TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
ROW_REL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    """A torch tensor or JAX array as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _check(got, want, name, dtype, tol):
    """fp32: elementwise within `tol` (an allclose dict) or, a float, on
    the norm; bf16: within BF16_REL on the norm."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dtype == "bf16" or not isinstance(tol, dict):
        bound = BF16_REL if dtype == "bf16" else tol
        assert _rel(got, want) <= bound, (name, _rel(got, want))
    else:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)


def _round(a, dtype):
    """Values that both packages hold exactly in the compute dtype."""
    return _np(torch.from_numpy(a).to(DTYPES[dtype][0]))


def _attn_case(rng, width, window, dtype, shift):
    C, heads = ALL_WIDTHS[width]
    T, H, W, ws = ALL_WINDOWS[window]
    f = lambda *s, k=1.0: _round(  # noqa: E731
        (rng.standard_normal(s) * k).astype(np.float32), dtype)
    N, TN = ws * ws, T * ws * ws
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.1).astype(
        np.float32)
    idx = relative_position_index(ws, ws)
    bias = np.tile(table[idx.reshape(-1)].reshape(N, N, heads)
                   .transpose(2, 0, 1), (1, T, T))
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, shift),
                    (1, T, T)) if shift else None)
    return dict(x=f(1, T, H, W, C, k=0.5), g=f(1, T, H, W, C, k=0.5),
                wqkv=f(C, 3 * C, k=C ** -0.5), bqkv=f(3 * C, k=0.1),
                wproj=f(C, C, k=C ** -0.5), bproj=f(C, k=0.1),
                bias=np.ascontiguousarray(bias), mask=mask, heads=heads,
                scale=(C // heads) ** -0.5, ws=ws, shift=shift, TN=TN)


def _port_attn_args(c, dtype):
    dt = DTYPES[dtype][0]
    return (T_(c["x"]).to(dt), T_(c["wqkv"].T.copy()).to(dt), T_(c["bqkv"]),
            T_(c["wproj"].T.copy()).to(dt), T_(c["bproj"]), T_(c["bias"]),
            None if c["mask"] is None else T_(c["mask"]))


def _jax_attn_args(c, dtype):
    jdt = DTYPES[dtype][1]
    mask = (jnp.zeros((1, c["TN"], c["TN"]), jnp.float32)
            if c["mask"] is None else jnp.asarray(c["mask"]))
    return (jnp.asarray(c["x"], jdt), jnp.asarray(c["wqkv"], jdt),
            jnp.asarray(c["bqkv"]), jnp.asarray(c["wproj"], jdt),
            jnp.asarray(c["bproj"]), jnp.asarray(c["bias"]), mask)


GRID = [pytest.param(w, win, dt, id=f"{w}-{win}-{dt}")
        for w in WIDTHS for win in WINDOWS for dt in DTYPES]

# The fp32 core's streamed windows (past its resident pair), one head,
# fp32: TN 128 at hd 192 and 256 (`swin_dim` 768's and `num_heads=2`'s
# stage 1), TN 32 at hd 384 and 512 (their stage 2), TN 176 (T 11, ws 4)
# at hd 208, K1's widest window at its widest head dim
ALL_WIDTHS = {**WIDTHS, "hd192": (192, 1), "hd256": (256, 1),
              "hd384": (384, 1), "hd512": (512, 1), "hd208": (208, 1)}
ALL_WINDOWS = {**WINDOWS, "tn176": (11, 8, 8, 4)}
STREAMED = [pytest.param(w, win, "fp32", id=f"{w}-{win}-fp32")
            for w, win in (("hd192", "tn128"), ("hd256", "tn128"),
                           ("hd384", "tn32"), ("hd512", "tn32"),
                           ("hd208", "tn176"))]


@pytest.mark.parametrize("shifted", [False, True], ids=["w", "sw"])
@pytest.mark.parametrize("width,window,dtype", GRID + STREAMED)
def test_block_attention_matches_jax(rng, width, window, dtype, shifted):
    """K1: `swin_block_attention` on the CPU (its twin) against the
    interpreted `fused_swin_block_attention`, the shifted block taking the
    unshifted x and leaving the shifted layout on both sides."""
    ws = ALL_WINDOWS[window][3]
    c = _attn_case(rng, width, window, dtype, ws // 2 if shifted else 0)
    want = jattn.fused_swin_block_attention(
        *_jax_attn_args(c, dtype), c["heads"], c["scale"], ws, c["shift"],
        True)
    got = block_attention.swin_block_attention(
        *_port_attn_args(c, dtype), c["heads"], c["scale"], ws, c["shift"])
    assert got.dtype == DTYPES[dtype][0]
    _check(got, want, "out", dtype, K1_TOL)


@pytest.mark.parametrize("width,window,dtype", GRID)
def test_block_attention_bwd_matches_jax(rng, width, window, dtype):
    """K5: the gradients of the port's CPU path (autograd through
    `BlockAttentionFn`, whose CPU backward is the twin) against the
    interpreted `fused_swin_block_attention_bwd` of an SW-MSA block,
    routed as `_fsba_bwd` routes it (x rolled into the shifted layout,
    dx rolled back)."""
    ws = WINDOWS[window][3]
    shift = ws // 2
    c = _attn_case(rng, width, window, dtype, shift)
    jx, jw, jb, jp, _, jbias, jmask = _jax_attn_args(c, dtype)
    jdt = DTYPES[dtype][1]
    xs = jnp.roll(jx, (-shift, -shift), axis=(2, 3))
    dx, *want = jattn.fused_swin_block_attention_bwd(
        xs, jw, jb, jp, jbias, jmask, jnp.asarray(c["g"], jdt), c["heads"],
        c["scale"], ws, interpret=True)
    want = [jnp.roll(dx, (shift, shift), axis=(2, 3))] + want
    want[1], want[3] = jnp.transpose(want[1]), jnp.transpose(want[3])
    args = _port_attn_args(c, dtype)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    out = block_attention.swin_block_attention(
        *leaves, args[6], c["heads"], c["scale"], ws, shift)
    got = torch.autograd.grad(out, leaves,
                              T_(c["g"]).to(DTYPES[dtype][0]))
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                           "dbias"), got, want):
        _check(a, b, name, dtype, BWD_TOL)


EPI = ("s2", "b2", "w1", "b1", "w2", "bw2", "s1", "b1n")


def _epi_case(rng, width, window, dtype):
    C = WIDTHS[width][0]
    T, H, W, _ = WINDOWS[window]
    hidden = 4 * C
    f = lambda *s, k=1.0, o=0.0: (  # noqa: E731
        rng.standard_normal(s) * k + o).astype(np.float32)
    r = lambda a: _round(a, dtype)  # noqa: E731
    return dict(x=r(f(1, T, H, W, C)), y=r(f(1, T, H, W, C)),
                g=r(f(1, T, H, W, C)), s2=f(C, k=0.1, o=1.0), b2=f(C, k=0.1),
                w1=r(f(C, hidden, k=C ** -0.5)), b1=f(hidden, k=0.1),
                w2=r(f(hidden, C, k=hidden ** -0.5)), bw2=f(C, k=0.1),
                s1=f(C, k=0.1, o=1.0), b1n=f(C, k=0.1))


def _epi_port(c, dtype, keys=("x", "y") + EPI):
    dt = DTYPES[dtype][0]
    out = []
    for k in keys:
        t = T_(np.ascontiguousarray(c[k].T if k in ("w1", "w2") else c[k]))
        out.append(t.to(dt) if k in ("x", "y", "g", "w1", "w2") else t)
    return out


def _epi_jax(c, dtype, keys=("x", "y") + EPI):
    jdt = DTYPES[dtype][1]
    return [jnp.asarray(c[k], jdt) if k in ("x", "y", "g", "w1", "w2")
            else jnp.asarray(c[k]) for k in keys]


@pytest.mark.parametrize("width,window,dtype", GRID)
def test_epilogues_match_jax(rng, width, window, dtype):
    """K2: `swin_block_epilogue` on the CPU against the interpreted
    `fused_swin_block_epilogue` (row 2) and, with y in the shifted layout,
    `fused_swin_block_epilogue_shifted` (row 3); K2's m form (the twin the
    CPU path of `EpilogueFn` runs where m is saved) against
    `_fused_epilogue_fwd_with_m` (row 8), the output and m."""
    ws = WINDOWS[window][3]
    c = _epi_case(rng, width, window, dtype)
    port, jargs = _epi_port(c, dtype), _epi_jax(c, dtype)
    want = jepi.fused_swin_block_epilogue(*jargs, True, 1e-5, True)
    _check(add_ln_mlp.swin_block_epilogue(*port), want, "row 2", dtype,
           EPI_TOL)
    shift = ws // 2
    want = jepi.fused_swin_block_epilogue_shifted(*jargs, shift, ws, True,
                                                  1e-5, True)
    got = add_ln_mlp.swin_block_epilogue(*port, True, shift, ws)
    _check(got, want, "row 3", dtype, EPI_TOL)
    out, m = jepi._fused_epilogue_fwd_with_m(*jargs, True, 1e-5, True)
    got_out, got_m = add_ln_mlp.swin_block_epilogue_with_m_ref(*port)
    assert got_m.dtype == DTYPES[dtype][0]
    _check(got_out, out, "row 8 out", dtype, EPI_TOL)
    _check(got_m, m, "row 8 m", dtype, EPI_TOL)


@pytest.mark.parametrize("width,window,dtype", GRID)
def test_epilogue_bwds_match_jax(rng, width, window, dtype):
    """K6: the gradients of the port's CPU path (autograd through
    `EpilogueFn` with m saved, whose CPU backward is the twin) against the
    interpreted `fused_epilogue_bwd` (row 7, m recomputed and rounded as
    `:216` rounds it) and `fused_epilogue_bwd_streamed` (row 9, given row
    8's m)."""
    c = _epi_case(rng, width, window, dtype)
    jargs = _epi_jax(c, dtype)
    jg = _epi_jax(c, dtype, ("g",))[0]
    row7 = jepi.fused_epilogue_bwd(*jargs[:9], jg, True, 1e-5, True)
    _, m = jepi._fused_epilogue_fwd_with_m(*jargs, True, 1e-5, True)
    row9 = jepi.fused_epilogue_bwd_streamed(*jargs[:9], jg, m, True, 1e-5,
                                            2, True)
    port = _epi_port(c, dtype)
    leaves = [t.clone().requires_grad_() for t in port]
    out = add_ln_mlp.swin_block_epilogue(*leaves, True, 0, None, 1e-5,
                                         m_out=True)
    got = torch.autograd.grad(out, leaves, _epi_port(c, dtype, ("g",))[0])
    # the port's (dx, dy, s2 ...) against JAX's (ds, s2 ... s1); ds is
    # both dx and dy, b1n takes no part in JAX's list
    for row, want in (("row 7", row7), ("row 9", row9)):
        ds, *vec = want
        _check(got[0], ds, f"{row} dx", dtype, BWD_TOL)
        _check(got[1], ds, f"{row} dy", dtype, BWD_TOL)
        for name, a, b in zip(EPI, got[2:], vec):
            b = jnp.transpose(b) if name in ("w1", "w2") else b
            _check(a, b, f"{row} {name}", dtype, BWD_TOL)


@pytest.mark.parametrize("width,window,dtype", GRID + STREAMED)
def test_rows_10_and_11_match_jax(rng, width, window, dtype):
    """Rows 10 (`windowed_attention_image`) and 11
    (`fused_window_attention`) of an SW-MSA block on the CPU against the
    interpreted Pallas kernels: the output, and the gradients of qkv (q,
    k, v) and the bias against `jax.grad` through them."""
    C, heads = ALL_WIDTHS[width]
    T, H, W, ws = ALL_WINDOWS[window]
    dt, jdt = DTYPES[dtype]
    N, TN = ws * ws, T * ws * ws
    qkv = _round(rng.standard_normal((1, T, H, W, 3 * C)).astype(
        np.float32), dtype)
    G = _round(rng.standard_normal((1, T, H, W, C)).astype(np.float32),
               dtype)
    table = (rng.standard_normal(((2 * ws - 1) ** 2, heads)) * 0.5).astype(
        np.float32)
    bias = np.tile(table[relative_position_index(ws, ws).reshape(-1)]
                   .reshape(N, N, heads).transpose(2, 0, 1), (1, T, T))
    mask = np.tile(shifted_window_attention_mask(H, W, ws, ws // 2),
                   (1, T, T))
    scale = (C // heads) ** -0.5
    jmask = jnp.asarray(mask)

    def jloss10(q, b):
        out = jattn.windowed_attention_image(q, b, jmask, heads, scale, ws,
                                             True)
        return jnp.sum(out.astype(jnp.float32) * G), out
    (_, want), jgrads = jax.value_and_grad(jloss10, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(qkv, jdt), jnp.asarray(bias))
    leaves = [T_(qkv).to(dt).requires_grad_(), T_(bias).requires_grad_()]
    out = block_attention.windowed_attention_image(*leaves, T_(mask), heads,
                                                   scale, ws)
    (out.float() * T_(G)).sum().backward()
    _check(out, want, "row 10", dtype, ROW_REL)
    for name, leaf, jg in zip(("dqkv", "dbias"), leaves, jgrads):
        _check(leaf.grad, jg, f"row 10 {name}", dtype, ROW_REL)

    # row 11 on the same qkv, partitioned as the JAX model partitions it
    xw = qkv.reshape(1, T, H // ws, ws, W // ws, ws, 3 * C)
    xw = xw.transpose(0, 2, 4, 1, 3, 5, 6).reshape(-1, TN, 3, heads,
                                                   C // heads)
    q, k, v = np.ascontiguousarray(xw.transpose(2, 0, 3, 1, 4))
    G11 = _round(rng.standard_normal(q.shape).astype(np.float32), dtype)

    def jloss11(q, k, v, b):
        out = jpa.fused_window_attention(q, k, v, b, jmask, scale, True)
        return jnp.sum(out.astype(jnp.float32) * G11), out
    (_, want), jgrads = jax.value_and_grad(jloss11, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(bias))
    leaves = [T_(a).to(dt).requires_grad_() for a in (q, k, v)]
    leaves.append(T_(bias).requires_grad_())
    out = fused_window_attention(*leaves, T_(mask), scale)
    (out.float() * T_(G11)).sum().backward()
    _check(out, want, "row 11", dtype, ROW_REL)
    for name, leaf, jg in zip(("dq", "dk", "dv", "dbias"), leaves, jgrads):
        _check(leaf.grad, jg, f"row 11 {name}", dtype, ROW_REL)


# ---- a whole swin_dim-96 model, fp32 ----------------------------------

# 128 x 192 frames: 16 x 24 (ws 8) and 8 x 12 (ws 4) feature maps, so every
# SW block shifts; the logits bound of `tests/test_torch_model.py` (the JAX
# CPU route's exact erf against the port's polynomial GELU)
HW, NC, LOGIT_TOL = (128, 192), 5, 1e-5


def test_swin_dim_96_model_matches_jax():
    """`TswinPlus(swin_dim=96)` (C 96 hd 24, C 192 hd 48) on the CPU with
    the JAX model's weights (`load_from_jax`) against `JTswinPlus` on the
    same clip: the head-resolution logits."""
    rng = np.random.default_rng(0)
    clip = rng.standard_normal((1, 4, *HW, 3)).astype(np.float32)
    jm = JTswinPlus(num_classes=NC, swin_dim=96, swin_depths=(2, 2))
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(clip))
    port = TswinPlus(NC, swin_dim=96, swin_depths=(2, 2), input_hw=HW)
    load_from_jax(port, variables)
    want = jax.jit(functools.partial(jm.apply, train=False,
                                     head_res_logits=True))(
        variables, jnp.asarray(clip))
    with torch.no_grad():
        got = port.eval()(T_(clip), head_res_logits=True)
    assert got.shape == (1, NC, HW[0] // 8, HW[1] // 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


# ---- the guards of the new rule, card-free ----------------------------

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


SIZES = [4, 8, 12, 24, 32, 60, 64, 96, 100, 128, 136, 192, 288, 384]


def test_wgrad_sm90_takes_every_multiple_of_8(card_free):
    """`wgrad_sm90` (K5's and K6's bf16 weight gradients) takes every (M,
    N) of multiples of 8, its ragged last 128 x 128 tile masked in the
    kernel (dwqkv at C 96 is (288, 96)), and refuses the rest; each call
    it takes launches the library's entry once."""
    meta = dict(dtype=torch.bfloat16, device="meta")
    took = []
    for M in SIZES:
        for N in SIZES:
            a = torch.empty((256, M), **meta)
            b = torch.empty((256, N), **meta)
            if _accepts(lambda: gemm.wgrad_sm90(a, b)):
                took.append((M, N))
    assert took == [(M, N) for M in SIZES for N in SIZES
                    if M % 8 == 0 and N % 8 == 0]
    assert card_free == ["stswin_wgrad_sm90"] * len(took)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epilogue_geometry_takes_every_multiple_of_8(card_free, dtype):
    """K2's and K6's `_geometry` (through K6's wrapper, which runs it
    first) takes C and hidden multiples of 8 and names the rule when it
    refuses."""
    took = []
    for C in SIZES:
        for hidden in (4 * C, 4 * C + 4):
            x = torch.empty((2, 2, 4, 4, C), dtype=dtype, device="meta")
            w1 = torch.empty((hidden, C), dtype=dtype, device="meta")
            try:
                add_ln_mlp._geometry("k6", x, x, w1, 2, 4)
            except ValueError as e:
                assert "multiples of 8" in str(e)
                continue
            took.append((C, hidden))
    assert took == [(C, 4 * C) for C in SIZES if C % 8 == 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_widths_serve_and_train(card_free, dtype):
    """At every (C, heads) of the grid and both windows, K1's and K5's
    wrappers (and K2's and K6's) take the block on the card's branch in
    both dtypes: each launches its C entry once (the fp32 forms theirs)."""
    meta = dict(dtype=dtype, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    bf = dtype == torch.bfloat16
    sfx = "" if bf else "_f32"
    for C, heads in WIDTHS.values():
        for T, H, W, ws in WINDOWS.values():
            TN = T * ws * ws
            x = torch.empty((1, T, H, W, C), **meta)
            w = (torch.empty((3 * C, C), **meta), torch.empty(3 * C, **f32),
                 torch.empty((C, C), **meta), torch.empty(C, **f32))
            bias = torch.empty((heads, TN, TN), **f32)
            fwd = (block_attention._forward_kernel if bf
                   else block_attention._forward_f32)
            bwd = (block_attention.swin_block_attention_bwd if bf
                   else block_attention.swin_block_attention_bwd_f32)
            card_free.clear()
            fwd(x, *w, bias, None, heads, C ** -0.5, ws, ws // 2)
            rows = T * H * W
            bwd(x, x, torch.empty((rows, 3 * C), **meta),
                torch.empty((rows, C), **meta), w[0], w[2], bias, None,
                heads, C ** -0.5, ws, ws // 2)
            p = (torch.empty(C, **f32), torch.empty(C, **f32),
                 torch.empty((4 * C, C), **meta), torch.empty(4 * C, **f32),
                 torch.empty((C, 4 * C), **meta), torch.empty(C, **f32),
                 torch.empty(C, **f32), torch.empty(C, **f32))
            if bf:
                add_ln_mlp._forward_kernel(x, x, *p, True, ws // 2, ws, 1e-5,
                                           with_m=True)
                k6 = add_ln_mlp.swin_block_epilogue_bwd
            else:
                add_ln_mlp.swin_block_epilogue_f32(x, x, *p, True, ws // 2,
                                                   ws, 1e-5, m_out=True)
                k6 = add_ln_mlp.swin_block_epilogue_bwd_f32
            k6(x, x, x, x, *p[:7], shift=ws // 2, ws=ws)
            assert card_free == [
                f"stswin_block_attention{sfx}",
                f"stswin_block_attention_bwd{sfx}",
                f"stswin_block_epilogue{sfx}",
                f"stswin_block_epilogue_bwd{sfx}"], (C, heads, TN)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_whole_block_keeps_its_envelope_at_the_new_widths(card_free,
                                                          monkeypatch, dtype):
    """Row 16 takes the new widths: `whole_swin_block` at C 96 (`swin_dim`
    96 with `whole_block=True`, hd 24) launches its C entry once in each
    form, as K1's wrapper takes the same block; the layout the wrapper
    checks is the plan's (the library's own is held to it on the card,
    `tests/test_torch_cuda.py`)."""
    from stswincl_tpu_torch.ops import swin_block
    meta = dict(dtype=dtype, device="meta")
    f32 = dict(dtype=torch.float32, device="meta")
    C, heads, T, ws = 96, 4, 2, 8

    def layout(TN, hd, dt):
        plan = swin_block.whole_block_plan(1, TN // ws ** 2, ws, ws,
                                           hd * heads, 4 * hd * heads, heads,
                                           ws, dt)
        return plan.attention_group, plan.smem_bytes
    monkeypatch.setattr(swin_block, "_layout", layout)
    monkeypatch.setattr(swin_block, "_slots", lambda *a: 132)
    x = torch.empty((1, T, 16, 16, C), **meta)
    z = lambda *s, kw=f32: torch.empty(s, **kw)  # noqa: E731
    args = (x, z(3 * C, C, kw=meta), z(3 * C), z(C, C, kw=meta), z(C),
            z(heads, T * ws * ws, T * ws * ws), None, z(C), z(C),
            z(4 * C, C, kw=meta), z(4 * C), z(C, 4 * C, kw=meta), z(C),
            z(C), z(C), heads, 0.2, ws)
    with torch.no_grad():
        out = swin_block.whole_swin_block(*args)
    assert out.shape == x.shape and out.dtype == dtype
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    assert card_free == [f"stswin_whole_block{sfx}"]
    fwd = (block_attention._forward_kernel if dtype == torch.bfloat16
           else block_attention._forward_f32)
    fwd(*args[:7], heads, 0.2, ws, 0)
    assert len(card_free) == 2


