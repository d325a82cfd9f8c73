"""Every head dim the JAX attention kernels take: the port's CPU path
against the JAX package's Pallas kernels (interpret mode) at head dims
past the bf16 attention core's resident pair, which the card's kernels
reach through their streamed instances (the bf16 pair past hd 288 at TN
128, K5 bf16's streamed query pass, the fp32 forms' streamed pair and
passes).

Windows of TN 128 (ws 8, T 2): hd 320 (C 640 over 2 heads: `swin_dim`
1280's stage-1 head dim) and hd 512 (C 512 over 1 head: `num_heads=1`'s),
W-MSA and SW-MSA, fp32 and bf16:
- K1 (`fused_swin_block_attention`, Pallas row 1);
- K5 (`fused_swin_block_attention_bwd`, row 6);
- rows 10 (`windowed_attention_image`) and 11 (`fused_window_attention`);
one `SpaceTimeSwinBlock` W/SW pair at C 512 with 1 head against the JAX
blocks, forward and gradients, fp32; and row 16's plan
(`whole_block_plan`) on a grid of shapes: its resident pairs sized by the
resident pair's bytes, as before the streamed pair existed, and every
window whose resident pair does not fit on the streamed pair.

Tolerances, those `tests/test_torch_widths.py` uses for the same
functions: fp32, K1 rtol = atol = 1e-5, K5 rtol = atol = 2e-4, rows 10
and 11 ||port - jax|| / ||jax|| <= 1e-5; bf16, 1e-2 on the norm for every
output and gradient (both sides round q, k, v, P and the outputs at the
same points from fp32 sums taken in other orders). The block pair, fp32
against the JAX blocks' XLA route: 1e-4 on the norm, as
`tests/test_torch_swin.py` holds the stacks.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models.swin import \
    SpaceTimeSwinBlock as JBlock  # noqa: E402
from stswincl_tpu.ops import pallas_attention as jpa  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jattn  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.models.swin import SpaceTimeSwinBlock  # noqa: E402
from stswincl_tpu_torch.ops import attention, block_attention  # noqa: E402
from stswincl_tpu_torch.ops.swin_block import whole_block_plan  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

HEAD_DIMS = {"hd320": (640, 2), "hd512": (512, 1)}  # (C, heads)
T, H, W, WS = 2, 16, 16, 8  # four windows of TN 128
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BF16_REL = 1e-2
K1_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
ROW_REL = 1e-5
BLOCK_REL = 1e-4
GRID = [pytest.param(h, dt, sh, id=f"{h}-{dt}-{'sw' if sh else 'w'}")
        for h in HEAD_DIMS for dt in DTYPES for sh in (False, True)]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
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


def _bias_mask(rng, heads, shift, k=0.1):
    N = WS * WS
    table = (rng.standard_normal(((2 * WS - 1) ** 2, heads)) * k).astype(
        np.float32)
    bias = np.tile(table[relative_position_index(WS, WS).reshape(-1)]
                   .reshape(N, N, heads).transpose(2, 0, 1), (1, T, T))
    mask = (np.tile(shifted_window_attention_mask(H, W, WS, shift),
                    (1, T, T)) if shift else None)
    return np.ascontiguousarray(bias), mask


def _attn_case(rng, hd_key, dtype, shifted):
    C, heads = HEAD_DIMS[hd_key]
    shift = WS // 2 if shifted else 0
    f = lambda *s, k=1.0: _round(  # noqa: E731
        (rng.standard_normal(s) * k).astype(np.float32), dtype)
    bias, mask = _bias_mask(rng, heads, shift)
    return dict(x=f(1, T, H, W, C, k=0.5), g=f(1, T, H, W, C, k=0.5),
                wqkv=f(C, 3 * C, k=C ** -0.5), bqkv=f(3 * C, k=0.1),
                wproj=f(C, C, k=C ** -0.5), bproj=f(C, k=0.1), bias=bias,
                mask=mask, heads=heads, scale=(C // heads) ** -0.5,
                shift=shift, TN=T * WS * WS)


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


def test_the_head_dims_are_past_the_resident_pair():
    """Both head dims run the streamed bf16 pair on the card (the resident
    pair's q, k and v pass shared memory at TN 128) and K5 bf16's two
    passes; the fp32 forms stream too."""
    from stswincl_tpu_torch import kernels
    TN = T * WS * WS
    for C, heads in HEAD_DIMS.values():
        hd = C // heads
        assert attention._attn_smem_bytes(TN, hd) > kernels.SMEM_LIMIT
        assert attention._attn_plan_bytes(TN, hd) == 864 * TN
        assert not block_attention._attn_bwd_slot_takes(TN, hd)
        assert not block_attention._attn_f32_bwd_resident(TN, hd)
        assert (attention._attn_f32_smem_bytes(TN, hd)
                != attention._attn_f32_resident_bytes(TN, hd))


@pytest.mark.parametrize("hd_key,dtype,shifted", GRID)
def test_block_attention_matches_jax(rng, hd_key, dtype, shifted):
    """K1 on the CPU (its twin) against the interpreted
    `fused_swin_block_attention`."""
    c = _attn_case(rng, hd_key, dtype, shifted)
    want = jattn.fused_swin_block_attention(
        *_jax_attn_args(c, dtype), c["heads"], c["scale"], WS, c["shift"],
        True)
    got = block_attention.swin_block_attention(
        *_port_attn_args(c, dtype), c["heads"], c["scale"], WS, c["shift"])
    assert got.dtype == DTYPES[dtype][0]
    _check(got, want, "out", dtype, K1_TOL)


@pytest.mark.parametrize("hd_key,dtype,shifted", GRID)
def test_block_attention_bwd_matches_jax(rng, hd_key, dtype, shifted):
    """K5: the gradients of the port's CPU path (autograd through
    `BlockAttentionFn`) against the interpreted
    `fused_swin_block_attention_bwd`, routed as `_fsba_bwd` routes it (x
    rolled into the shifted layout, dx rolled back)."""
    c = _attn_case(rng, hd_key, dtype, shifted)
    shift = c["shift"]
    jx, jw, jb, jp, _, jbias, jmask = _jax_attn_args(c, dtype)
    jdt = DTYPES[dtype][1]
    xs = jnp.roll(jx, (-shift, -shift), axis=(2, 3))
    dx, *want = jattn.fused_swin_block_attention_bwd(
        xs, jw, jb, jp, jbias, jmask, jnp.asarray(c["g"], jdt), c["heads"],
        c["scale"], WS, interpret=True)
    want = [jnp.roll(dx, (shift, shift), axis=(2, 3))] + want
    want[1], want[3] = jnp.transpose(want[1]), jnp.transpose(want[3])
    args = _port_attn_args(c, dtype)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    out = block_attention.swin_block_attention(
        *leaves, args[6], c["heads"], c["scale"], WS, shift)
    got = torch.autograd.grad(out, leaves, T_(c["g"]).to(DTYPES[dtype][0]))
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                           "dbias"), got, want):
        _check(a, b, name, dtype, BWD_TOL)


@pytest.mark.parametrize("hd_key,dtype,shifted", GRID)
def test_rows_10_and_11_match_jax(rng, hd_key, dtype, shifted):
    """Rows 10 (`windowed_attention_image`) and 11
    (`fused_window_attention`) on the CPU against the interpreted Pallas
    kernels, with the SW-MSA mask or without one."""
    C, heads = HEAD_DIMS[hd_key]
    dt, jdt = DTYPES[dtype]
    TN, hd = T * WS * WS, C // heads
    qkv = _round(rng.standard_normal((1, T, H, W, 3 * C)).astype(
        np.float32), dtype)
    bias, mask = _bias_mask(rng, heads, WS // 2 if shifted else 0, k=0.5)
    scale = hd ** -0.5
    jm = (jnp.zeros((1, TN, TN), jnp.float32) if mask is None
          else jnp.asarray(mask))  # a single zero entry: the W-MSA marker
    want = jattn.windowed_attention_image(
        jnp.asarray(qkv, jdt), jnp.asarray(bias), jm, heads, scale, WS, True)
    got = block_attention.windowed_attention_image(
        T_(qkv).to(dt), T_(bias), None if mask is None else T_(mask), heads,
        scale, WS)
    _check(got, want, "row 10", dtype, ROW_REL)
    # row 11 on the same qkv, partitioned as the JAX model partitions it
    xw = qkv.reshape(1, T, H // WS, WS, W // WS, WS, 3 * C)
    xw = xw.transpose(0, 2, 4, 1, 3, 5, 6).reshape(-1, TN, 3, heads, hd)
    q, k, v = np.ascontiguousarray(xw.transpose(2, 0, 3, 1, 4))
    want = jpa.fused_window_attention(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(bias), jm,
        scale, interpret=True)
    got = attention.fused_window_attention(
        *(T_(t).to(dt) for t in (q, k, v)), T_(bias),
        None if mask is None else T_(mask), scale)
    _check(got, want, "row 11", dtype, ROW_REL)


def test_block_pair_at_one_head_matches_jax():
    """A W-MSA and an SW-MSA `SpaceTimeSwinBlock` at C 512 with one head
    (hd 512, TN 128: `num_heads=1`'s stage 1) on the port's kernel route
    (its CPU twins) against the JAX blocks on the same weights
    (`load_from_jax`), fp32: the pair's output and the gradients of the
    input and of every parameter, as `jax.grad` of the same loss gives
    them."""
    C, RES = 512, (H, W)
    rng = np.random.default_rng(26)
    x = rng.standard_normal((1, T, *RES, C)).astype(np.float32)
    G = rng.standard_normal((1, T, *RES, C)).astype(np.float32)
    jx, jG = (jnp.asarray(a.reshape(1, T, H * W, C)) for a in (x, G))
    jblocks = [JBlock(dim=C, input_resolution=RES, num_heads=1,
                      window_size=WS, shift_size=s, attn_impl="einsum")
               for s in (0, WS // 2)]
    variables = [jax.jit(b.init)(jax.random.key(i), jx)
                 for i, b in enumerate(jblocks)]

    def jloss(params, xx):
        y = xx
        for b, v, p in zip(jblocks, variables, params):
            y = b.apply({**v, "params": p}, y)
        return jnp.sum(y * jG), y
    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        [v["params"] for v in variables], jx)
    blocks = [load_from_jax(SpaceTimeSwinBlock(C, RES, 1, WS, s,
                                               kernels=True), v)
              for s, v in zip((0, WS // 2), variables)]
    xt = T_(x).requires_grad_()
    y = xt
    for b in blocks:
        y = b(y)
    (y * T_(G)).sum().backward()
    assert _rel(_np(y), _np(jy).reshape(y.shape)) <= BLOCK_REL
    assert _rel(_np(xt.grad), _np(jgx).reshape(x.shape)) <= BLOCK_REL
    # every parameter's gradient, through the port's JAX-path names
    for b, v, jg in zip(blocks, variables, jgp):
        want = load_from_jax(
            SpaceTimeSwinBlock(C, RES, 1, WS, b.shift_size),
            {**v, "params": jg}).state_dict()
        grads = {n: p.grad for n, p in b.named_parameters()}
        assert grads and all(g is not None for g in grads.values())
        for n, g in grads.items():
            assert _rel(_np(g), _np(want[n])) <= BLOCK_REL, n


# Row 16's decisions before the streamed pair: (dtype, C) -> the attention
# group of each (heads, (T, ws)) of ROW16_CASES, 0 where the plan refuses
ROW16_CASES = [(heads, tw) for heads in (1, 2, 4)
               for tw in ((2, 8), (2, 4), (1, 4), (8, 4))]
ROW16_GROUPS = {
    ("bf16", 128): (1, 4, 8, 1, 1, 4, 8, 1, 1, 4, 8, 1),
    ("bf16", 256): (1, 4, 8, 1, 1, 4, 8, 1, 1, 4, 8, 1),
    ("bf16", 512): (0, 2, 4, 0, 1, 4, 8, 1, 1, 4, 8, 1),
    ("bf16", 1024): (0, 1, 2, 0, 0, 2, 4, 0, 1, 4, 8, 1),
    ("fp32", 128): (1, 4, 8, 1, 1, 4, 8, 1, 1, 4, 8, 1),
    ("fp32", 256): (0, 2, 4, 0, 1, 4, 8, 1, 1, 4, 8, 1),
    ("fp32", 512): (0, 1, 2, 0, 0, 2, 4, 0, 1, 4, 8, 1),
    ("fp32", 1024): (0, 0, 1, 0, 0, 1, 2, 0, 0, 2, 4, 0),
}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_whole_block_plan_decides_as_before(dtype):
    """`whole_block_plan` keeps its resident pairs (`_attn_smem_bytes`,
    `_attn_f32_resident_bytes`): on a grid of C, heads, T and ws every
    shape it took is taken with the same attention group and pair bytes;
    the shapes it refused for shared memory (0 in the table) now run the
    streamed pair (a ring of 864 TN bytes), as many at once as the 8
    warps and shared memory hold."""
    dt = DTYPES[dtype][0]
    pair = (attention._attn_smem_bytes if dtype == "bf16"
            else attention._attn_f32_resident_bytes)
    fixed = 0 if dtype == "fp32" else 1024 + 128
    for (dname, C), groups in ROW16_GROUPS.items():
        if dname != dtype:
            continue
        for (heads, (Tn, ws)), want in zip(ROW16_CASES, groups):
            TN = Tn * ws * ws
            plan = whole_block_plan(2, Tn, 16, 16, C, 4 * C, heads, ws, dt)
            assert plan.streamed == (want == 0), (C, heads, Tn, ws)
            if want:
                assert plan.attention_group == want, (C, heads, Tn, ws)
                assert plan.pair_bytes == pair(TN, C // heads)
            else:
                assert plan.pair_bytes == 864 * TN
                assert plan.attention_group == min(
                    256 // (TN // 16 * 32),
                    (kernels.SMEM_LIMIT - fixed) // (864 * TN))


def test_attention_backward_alone_on_the_cpu(rng):
    """K5's attention backward alone (`attn_bwd`, the card's
    `stswin_attn_bwd`) runs its twin on a CPU tensor: autograd of the
    window attention in qkv's dtype, whose fp32 form is K5 fp32's twin
    (`attn_bwd_f32_ref`); at hd 512 over one head both hold the gradients
    of the bf16 attention within BF16_REL of fp32."""
    C, heads = HEAD_DIMS["hd512"]
    TN = T * WS * WS
    bias, mask = _bias_mask(rng, heads, WS // 2)
    rows = H * W * T
    qkv = T_(_round(rng.standard_normal((rows, 3 * C)).astype(np.float32),
                    "bf16"))
    dattn = T_(_round(rng.standard_normal((rows, C)).astype(np.float32),
                      "bf16"))
    args = (T_(bias), T_(mask), heads, C ** -0.5, TN)
    got = block_attention.attn_bwd(qkv.bfloat16(), dattn.bfloat16(),
                                   None, *args)
    want = block_attention.attn_bwd_ref(qkv.bfloat16(), dattn.bfloat16(),
                                        *args)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    f32 = block_attention.attn_bwd_f32_ref(qkv, dattn, *args)
    assert all(torch.equal(a, b) for a, b in zip(
        f32, block_attention.attn_bwd_ref(qkv, dattn, *args)))
    for a, b in zip(got, f32):
        assert _rel(_np(a), _np(b)) <= BF16_REL
