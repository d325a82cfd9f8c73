"""The numeric design of the fp32 kernels' tensor-core products, on the CPU.

The fp32 attention core (`csrc/fp32_attention.cuh`: K1's fp32 form and
those of Pallas rows 10, 11 and 16) runs every product as three TF32
products on the tensor cores (`csrc/tf32x3.cuh`): x = hi + lo with hi = x
rounded to TF32 to nearest, ties away from zero (what `cvt.rna.tf32.f32`
gives), and lo = x - hi, which the mma reads as TF32 by dropping its low
13 bits; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi. Here that split is
emulated in plain PyTorch (a product of two TF32 values is exact in fp32,
so an fp32 matmul of the halves is what the mma sums) and applied to the
attention contract and K5's attention backward (and its streamed form,
hd in chunks, P and dS stored): the 3xTF32 form stays
within the fp32 bound the card's checks hold the kernels to
(`chip_smoke.TOL_F32_REL`), and a single TF32 pass misses it tenfold.
The fp32 GEMM tile (`csrc/fp32_gemm.cuh`: the fp32 GEMM, row 17's fp32
implicit GEMM, row 16's products and the weight gradients `wgrad_f32`)
runs the split on wgmma with lo rounded to TF32 too (`split_rn`), each
32-deep k tile's three products summed from zero and added to fp32 sums
(`mm_tile`); it is emulated on a GEMM, on row 17 at dilation 18 with the
k tiles that read only the padding skipped, against a split it did not
take (hi the raw value, truncated as the tensor cores read it), and on
the weight gradients with K = the token rows, split as `wgrad_f32`
splits them (`wgrad_tile`); K6's db1 as the dpre GEMM's epilogue sums it
(`gemm.f32_colsum`). This records why three passes are fp32 enough and
one is not; the card checks the kernels themselves.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import pallas_attention as jpa  # noqa: E402
from stswincl_tpu.ops.window import shifted_window_attention_mask  # noqa: E402
from stswincl_tpu_torch.ops import gemm  # noqa: E402
from stswincl_tpu_torch.ops.attention import attend_tiled  # noqa: E402

# `chip_smoke.TOL_F32_REL`: ||form - fp32 twin|| / ||fp32 twin|| on the card
TOL_F32_REL = 2e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: the magnitude bits plus half of the last kept bit, the low
    13 bits cleared (`cvt.rna.tf32.f32`; a carry into the exponent is the
    rounding up)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """x as an mma reads an fp32 register as TF32: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """(hi, lo) as the kernels' `tf32x3::split` forms them, lo as the mma
    reads it."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels form it: three TF32 products summed in fp32,
    the small terms first."""
    (ah, al), (bh, bl) = split(a), split(b)
    d = al @ bh
    d = d + ah @ bl
    return d + ah @ bh


def mm_1xtf32(a, b):
    """a @ b in one TF32 pass: what the kernels would give on plain TF32."""
    return tf32(a) @ tf32(b)


def probs_with(mm, q, k, bias, mask, scale):
    """P of `attend_tiled`'s contract (the scale after the product, +
    bias, + the window's mask, max, exp, x 1 / sum), S by `mm`."""
    Bw, heads, TN, _ = q.shape
    s = mm(q, k.transpose(-1, -2)) * scale + bias[None]
    if mask is not None and mask.shape[0] > 1:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, heads, TN, TN)
             + mask[None, :, None]).reshape(Bw, heads, TN, TN)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def attend_with(mm, q, k, v, bias, mask, scale):
    """`attend_tiled`'s contract with both products by `mm`."""
    return mm(probs_with(mm, q, k, bias, mask, scale), v)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated hi (`cvt.rna.tf32.f32`): 10 mantissa bits kept, the
    halfway case away from zero in both signs, the rest to nearest, within
    2^-11 |x|; lo as the mma reads it within 2^-21 |x| of x - hi, and the
    fp32 GEMM tile's rounded lo within 2^-22 |x|."""
    one, ulp = 1.0, 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, 2.0 ** -130],
                     dtype=torch.float32)
    want = [one + ulp, -(one + ulp), one, one + ulp, 3.0, 2.0 ** -130]
    assert tf32(x).tolist() == want
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 7
    hi, lo = split(r)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - hi).abs() <= r.abs() * 2.0 ** -11)
    assert torch.all((r - hi - lo).abs() <= r.abs() * 2.0 ** -21)
    hi, lo = split_rn(r)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - hi - lo).abs() <= r.abs() * 2.0 ** -22)


@pytest.mark.parametrize("masked", [False, True], ids=["w", "sw"])
def test_attention_contract_on_3xtf32(masked):
    """Both attention products on the split, at phase 7's draw (qkv at
    std 2, the relative bias N(0, 1)) on two images of 6 windows of TN 32
    (T 2, ws 4), hd 64: within TOL_F32_REL of the port's fp32 twin
    (`attend_tiled`) and of the JAX row 11 interpreted on the CPU; one TF32
    pass misses that tenfold against both."""
    rng = np.random.default_rng(19)
    Bw, heads, T, H, W, ws, hd = 12, 2, 2, 8, 12, 4, 64
    TN = T * ws * ws
    q, k, v = (rng.standard_normal((Bw, heads, TN, hd)).astype(np.float32)
               * 2 for _ in range(3))
    bias = rng.standard_normal((heads, TN, TN)).astype(np.float32)
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, ws // 2),
                    (1, T, T)) if masked
            else np.zeros((1, TN, TN), np.float32))
    scale = hd ** -0.5
    tq, tk, tv, tb, tm = map(torch.from_numpy, (q, k, v, bias, mask))
    twin = attend_tiled(tq, tk, tv, tb, tm, scale)
    jax_row11 = jpa.fused_window_attention(
        *map(jnp.asarray, (q, k, v, bias, mask)), scale, True)
    assert _rel(twin, jax_row11) <= TOL_F32_REL / 10
    three = attend_with(mm_3xtf32, tq, tk, tv, tb, tm, scale)
    one = attend_with(mm_1xtf32, tq, tk, tv, tb, tm, scale)
    for want in (twin, jax_row11):
        assert _rel(three, want) <= TOL_F32_REL
        assert _rel(one, want) > 10 * TOL_F32_REL


def mm_steps(split_fn, step=8):
    """a @ b as the mma.sync kernels form it: the k dim in steps of 8 (an
    m16n8k8's), each step's three TF32 products (`split_fn`'s halves, the
    small terms first) summed from zero, then added to the fp32 sums."""
    def mm(a, b):
        (ah, al), (bh, bl) = split_fn(a), split_fn(b)
        out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype)
        for k0 in range(0, a.shape[-1], step):
            k = slice(k0, k0 + step)
            t = al[..., k] @ bh[..., k, :]
            t = t + ah[..., k] @ bl[..., k, :]
            out = out + (t + ah[..., k] @ bh[..., k, :])
        return out
    return mm


def attn_bwd_with(mm, q, k, v, bias, mask, scale, do):
    """The attention backward of `attend_tiled` with its five products by
    `mm`, as K5 fp32's attention backward (`csrc/fp32_attention_bwd.cuh`)
    forms it: S = q k^T, P as the forward; dP = dO v^T, D = sum dP P, dS =
    P (dP - D); dq = dS k * scale, dk = dS^T q * scale, dv = P^T dO; dbias
    the sum of dS over the windows. Returns (dq, dk, dv, dbias)."""
    p = probs_with(mm, q, k, bias, mask, scale)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do), ds.sum(dim=0))


@pytest.mark.parametrize("TN,hd,masked", [
    (128, 128, False), (128, 128, True), (32, 256, False), (32, 256, True)],
    ids=["s1-w", "s1-sw", "s2-w", "s2-sw"])
def test_attention_backward_on_3xtf32(TN, hd, masked):
    """K5 fp32's attention backward on the split it takes (`split`: hi to
    nearest, lo as the mma truncates it), each m16n8k8 k step summed from
    zero into fp32 sums, all five products (S, dP, dq, dv, dk), at stage
    1's window (TN 128, hd 128) and stage 2's (TN 32, hd 256), one image of
    4 windows x 2 heads, W-MSA and SW-MSA (the shifted mask), at phase 7's
    draw (q, k, v at std 2, the bias N(0, 1)) and dO N(0, 1): dq, dk, dv
    and dbias within TOL_F32_REL of the backward in float64 (the same
    formulas, which autograd of the fp32 twin `attend_tiled` meets within
    a tenth of it); one TF32 pass misses it tenfold."""
    rng = np.random.default_rng(21)
    ws = 8 if TN == 128 else 4
    T, H, W, heads = 2, 2 * ws, 2 * ws, 2
    Bw = (H // ws) * (W // ws)
    q, k, v = (rng.standard_normal((Bw, heads, TN, hd)).astype(np.float32)
               * 2 for _ in range(3))
    do = rng.standard_normal((Bw, heads, TN, hd)).astype(np.float32)
    bias = rng.standard_normal((heads, TN, TN)).astype(np.float32)
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, ws // 2),
                    (1, T, T)) if masked else None)
    scale = hd ** -0.5
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    tm = None if mask is None else torch.from_numpy(mask)
    tdo = torch.from_numpy(do)
    want = attn_bwd_with(torch.matmul, *(a.double() for a in args),
                         None if tm is None else tm.double(), scale,
                         tdo.double())
    leaves = [a.clone().requires_grad_() for a in args]
    out = attend_tiled(*leaves[:3], leaves[3], tm, scale)
    auto = torch.autograd.grad(out, leaves[:3] + leaves[3:], tdo)
    three = attn_bwd_with(mm_steps(split), *args, tm, scale, tdo)
    one = attn_bwd_with(mm_1xtf32, *args, tm, scale, tdo)
    for name, a, t, o, w in zip(("dq", "dk", "dv", "dbias"), auto, three,
                                one, want):
        assert _rel(a, w) <= TOL_F32_REL / 10, name
        assert _rel(t, w) <= TOL_F32_REL, name
        assert _rel(o, w) > 10 * TOL_F32_REL, name


def mm_chunked(split_fn, chunk=32, step=8):
    """a @ b as the streamed passes form S = q k^T and dP = dO v^T: the k
    dim (hd) arrives in chunks of `chunk` columns (the ring's slots), and
    each chunk's k steps of 8 are summed as `mm_steps` sums them, into the
    same fp32 sums."""
    def mm(a, b):
        (ah, al), (bh, bl) = split_fn(a), split_fn(b)
        out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=a.dtype)
        for c0 in range(0, a.shape[-1], chunk):
            for k0 in range(c0, min(c0 + chunk, a.shape[-1]), step):
                k = slice(k0, k0 + step)
                t = al[..., k] @ bh[..., k, :]
                t = t + ah[..., k] @ bl[..., k, :]
                out = out + (t + ah[..., k] @ bh[..., k, :])
        return out
    return mm


def streamed_attn_bwd(mm_qk, mm, q, k, v, bias, mask, scale, do):
    """K5 fp32's streamed attention backward (`attn32b::qs_kernel`,
    `kvs_kernel`): the query pass forms S (`mm_qk`, hd in chunks), P as
    the forward and stores it, dP (`mm_qk`), D = sum dP P from the stored
    P, dS = P (dP - D) stored beside it, dq = dS k * scale (`mm`: the k
    steps over keys); the key pass dv = P^T dO and dk = dS^T q * scale
    from the stored P and dS (`mm`: the k steps over queries). Returns
    (dq, dk, dv, dbias)."""
    p = probs_with(mm_qk, q, k, bias, mask, scale).clone()  # stored
    dp = mm_qk(do, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).clone()  # stored
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), do), ds.sum(dim=0))


@pytest.mark.parametrize("masked", [False, True], ids=["w", "sw"])
def test_streamed_attention_backward_on_3xtf32(masked):
    """K5 fp32's streamed attention backward at `num_heads=2`'s stage-1
    window (TN 128, hd 256, past the resident passes), one image of 4
    windows x 2 heads, W-MSA and SW-MSA, at phase 7's draw (q, k, v at std
    2, the bias N(0, 1)) and dO N(0, 1): S and dP summed over hd in
    chunks of 32 columns give the bits of the unchunked k steps (the
    resident order); dq, dk, dv and dbias from the stored P and dS are
    within TOL_F32_REL of the backward in float64; one TF32 pass misses it
    tenfold."""
    rng = np.random.default_rng(25)
    TN, hd, ws, heads = 128, 256, 8, 2
    T, H, W = 2, 2 * ws, 2 * ws
    Bw = (H // ws) * (W // ws)
    q, k, v = (rng.standard_normal((Bw, heads, TN, hd)).astype(np.float32)
               * 2 for _ in range(3))
    do = rng.standard_normal((Bw, heads, TN, hd)).astype(np.float32)
    bias = rng.standard_normal((heads, TN, TN)).astype(np.float32)
    mask = (np.tile(shifted_window_attention_mask(H, W, ws, ws // 2),
                    (1, T, T)) if masked else None)
    scale = hd ** -0.5
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    tm = None if mask is None else torch.from_numpy(mask)
    tdo = torch.from_numpy(do)
    steps = mm_steps(split)
    chunked = mm_chunked(split)
    qk = args[0] @ args[1].transpose(-1, -2)
    assert torch.equal(chunked(args[0], args[1].transpose(-1, -2)),
                       steps(args[0], args[1].transpose(-1, -2)))
    assert not torch.equal(qk, steps(args[0], args[1].transpose(-1, -2)))
    want = attn_bwd_with(torch.matmul, *(a.double() for a in args),
                         None if tm is None else tm.double(), scale,
                         tdo.double())
    three = streamed_attn_bwd(chunked, steps, *args, tm, scale, tdo)
    one = streamed_attn_bwd(mm_1xtf32, mm_1xtf32, *args, tm, scale, tdo)
    for name, t, o, w in zip(("dq", "dk", "dv", "dbias"), three, one, want):
        assert _rel(t, w) <= TOL_F32_REL, name
        assert _rel(o, w) > 10 * TOL_F32_REL, name


# ---- the fp32 GEMM tile (`csrc/fp32_gemm.cuh`, `f32t::ktile`) ------------

K_TILE = 32  # fp32 of k a k tile of the tile
TILE_ROWS = 128


def split_rn(x):
    """(hi, lo) as the fp32 GEMM tile forms them (`f32t::split_rn`): hi = x
    rounded to TF32, lo = x - hi rounded to TF32 as well."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def split_truncated(x):
    """(hi, lo) with hi the raw value as the tensor cores read it (its low
    13 bits dropped) and lo = x - hi, read the same way: the split the fp32
    GEMM tile did not take."""
    hi = tf32_truncated(x)
    return hi, tf32_truncated(x - hi)


def mm_tile(a, wt, live=None, split_fn=split_rn):
    """a (M, K) @ wt (N, K)^T as the fp32 GEMM tile forms it: K cut into
    32-deep k tiles, zero-filled past K; each k tile's three TF32 products
    (`split_rn`) summed from zero, the small terms first, a_lo b_hi + a_hi
    b_lo + a_hi b_hi; the k tile's sum
    added to the fp32 sums, rounded to nearest. `live` (row tiles of 128,
    k tiles) bool: a k tile that is not live for a row tile is skipped
    (row 17's k tiles wholly in the padding)."""
    M, K = a.shape
    KT = -(-K // K_TILE)
    pad = KT * K_TILE - K
    (ah, al), (bh, bl) = (split_fn(torch.nn.functional.pad(t, (0, pad)))
                          for t in (a, wt))
    rows_tile = torch.arange(M) // TILE_ROWS
    out = torch.zeros(M, wt.shape[0])
    for kt in range(KT):
        k = slice(kt * K_TILE, (kt + 1) * K_TILE)
        t = al[:, k] @ bh[:, k].t()
        t = t + ah[:, k] @ bl[:, k].t()
        t = t + ah[:, k] @ bh[:, k].t()
        if live is None:
            out = out + t
        else:
            out = torch.where(live[rows_tile, kt][:, None], out + t, out)
    return out


def test_gemm_tile_on_3xtf32():
    """The fp32 GEMM (`linear_f32`) as its tile sums: K 2048 (64 k tiles),
    M 300 and N 200 (off the 128-wide tiles), the bias and the erf GELU of
    its epilogue, against the fp32 twin `gemm.linear_sm90_ref`: within
    TOL_F32_REL; one TF32 pass misses it tenfold; a K off the k tile (2044)
    is the same sum as its zero-filled 2048."""
    from stswincl_tpu_torch.ops.mlp import gelu
    g = torch.Generator().manual_seed(20)
    M, N, K = 300, 200, 2048
    a = torch.randn(M, K, generator=g)
    wt = torch.randn(N, K, generator=g) * K ** -0.5
    bias = torch.randn(N, generator=g) * 0.1
    want = gemm.linear_sm90_ref(a, wt, bias, "erf")
    three = gelu(mm_tile(a, wt) + bias, True)
    one = gelu(mm_1xtf32(a, wt.t()) + bias, True)
    assert _rel(three, want) <= TOL_F32_REL
    assert _rel(one, want) > 10 * TOL_F32_REL
    cut = mm_tile(a[:, :2044].contiguous(), wt[:, :2044].contiguous())
    padded = torch.nn.functional.pad
    assert torch.equal(cut, mm_tile(padded(a[:, :2044], (0, 4)),
                                    padded(wt[:, :2044], (0, 4))))


def test_gemm_tile_rounded_hi_leaves_one_signed_sums_unbiased():
    """Why the tile rounds hi: on products of one sign (a reduction over a
    batch into a BatchNorm weight's gradient is one) a truncated hi
    (`split_truncated`, the raw value the tensor cores would read)
    shrinks every product, a_lo b_lo left out and lo truncated, so the
    sums drift toward zero by about 3e-7 of their size, past the spread a
    sum of independent roundings has; rounded, the error keeps no sign
    and is half as large."""
    g = torch.Generator().manual_seed(20)
    M, N, K = 128, 128, 2048
    a = torch.randn(M, K, generator=g).abs()
    wt = torch.randn(N, K, generator=g).abs() * K ** -0.5
    want = a.double() @ wt.double().t()

    def drift(split_fn):
        e = mm_tile(a, wt, split_fn=split_fn).double() - want
        return (e.mean() / want.mean()).item(), _rel(e + want, want)
    bias_round, rel_round = drift(split_rn)
    bias_trunc, rel_trunc = drift(split_truncated)
    assert bias_trunc < -1e-7 and abs(bias_round) < 1e-8
    assert rel_round < rel_trunc / 2 < TOL_F32_REL


@pytest.mark.parametrize("cin,res", [(32, False), (64, True), (36, False)],
                         ids=["cin32", "cin64-res", "cin36"])
def test_conv_tile_on_3xtf32_skips_the_padding(cin, res):
    """Row 17's fp32 form as the tile sums it: the implicit GEMM of the
    output pixels (`conv.tap_rows`) against the tap-major weight
    (`conv.pack_weights_f32`) at dilation 18 on a 2 x 24 x 20 map, the k
    tiles that read only the padding skipped (`conv.live_k_tiles`; at Cin
    36 a k tile may span two taps), then * scale + shift, + residual, ReLU
    in the twin's order: within TOL_F32_REL of the twin
    `conv3x3_bn_act_ref`, bit-equal to the same sums with no k tile
    skipped (a skipped k tile adds only zeros), and one TF32 pass misses
    the bound tenfold on the conv itself (* scale + shift, before the
    residual, which both forms add alike, dilutes it)."""
    from stswincl_tpu_torch.ops import conv
    g = torch.Generator().manual_seed(20)
    N, H, W, cout, d = 2, 24, 20, 40, 18
    x = torch.randn(N, H, W, cin, generator=g)
    w = torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
    scale = 0.5 + torch.rand(cout, generator=g)
    shift = torch.randn(cout, generator=g) * 0.5
    resid = torch.randn(N, H, W, cout, generator=g) if res else None
    want = conv.conv3x3_bn_act_ref(x, w, scale, shift, dilation=d,
                                   residual=resid)
    rows = conv.tap_rows(N, H, W, d)
    xr = torch.cat([x.reshape(-1, cin), torch.zeros(1, cin)])
    a = xr[rows].reshape(rows.shape[0], 9 * cin)  # -1: the zero row
    wt = conv.pack_weights_f32(w)
    live = conv.live_k_tiles(N, H, W, cin, d)
    assert live.shape == (-(-N * H * W // TILE_ROWS), -(-9 * cin // K_TILE))
    assert not live.all()

    def epilogue(acc):
        y = acc * scale + shift
        if resid is not None:
            y = y + resid.reshape(-1, cout)
        return y.clamp_min(0.0).reshape(N, H, W, cout)

    skipped = mm_tile(a, wt, live)
    assert torch.equal(skipped, mm_tile(a, wt))
    assert _rel(epilogue(skipped), want) <= TOL_F32_REL
    bare = conv.conv3x3_bn_act_ref(x, w, scale, shift, dilation=d,
                                   relu=False).reshape(-1, cout)
    assert _rel(mm_tile(a, wt, live) * scale + shift, bare) <= TOL_F32_REL
    assert (_rel(mm_1xtf32(a, wt.t()) * scale + shift, bare)
            > 10 * TOL_F32_REL)


# ---- the weight-gradient tile (`wgrad_f32`, `csrc/fp32_train.cu`) -------


def wgrad_tile(a, b, a_map, b_map, other_tiles=0):
    """sum_r a[a_rows(r)]^T b[b_rows(r)] as `wgrad_f32` forms it: the rows
    split as `gemm.wgrad_splits` splits them for the launch's output tiles
    (this gradient's, + `other_tiles` of the gradient it shares the launch
    with), each split's rows in 32-row k tiles from its start, zero-filled
    past its end, on the fp32 GEMM tile's k tile (`mm_tile` with K = r:
    `split_rn`, the three products from zero, added to fp32 sums), then
    the splits' partials added in order. Returns (sum, splits)."""
    R, M = a.shape
    N = b.shape[1]
    ar = a[gemm.window_rows(R, a_map)]
    br = b[gemm.window_rows(R, b_map)]
    tiles = -(-M // TILE_ROWS) * -(-N // TILE_ROWS) + other_tiles
    splits, chunk = gemm.wgrad_splits(R, tiles)
    out = None
    for s in range(splits):
        rows = slice(s * chunk, min(R, (s + 1) * chunk))
        part = mm_tile(ar[rows].t().contiguous(), br[rows].t().contiguous())
        out = part if out is None else out + part
    return out, splits


@pytest.mark.parametrize("grid,R,maps,other,splits", [
    ((23, 1, 9, 9, 3), 1863, "a", 0, 1),
    ((60, 1, 9, 9, 3), 4860, "b", 0, 2),
    ((81, 1, 9, 9, 3), 6561, None, 0, 3),
    ((81, 1, 9, 9, 3), 6561, "b", 1, 3)],
    ids=["a-shifted", "b-shifted-split", "split3-ragged", "pair-b-shifted"])
def test_weight_gradient_on_3xtf32(grid, R, maps, other, splits):
    """out = sum_r A[a_map(r)]^T B[b_map(r)] as the weight-gradient tile
    sums it (`wgrad_tile`): M 72 and N 100 (off the 128-wide tiles), R not
    a multiple of the 32-row k tile, split in 1 to 3 ranges (the last
    ragged), A read through the window partition with the cyclic shift (as
    no gradient of the port does) or B (K5's dwqkv reads x so), or neither
    (K6's), and beside a second gradient of the same launch: within
    TOL_F32_REL of the twin `gemm.wgrad_sm90_ref`; one TF32 pass misses it
    tenfold."""
    g = torch.Generator().manual_seed(19)
    B, T, H, W, ws = grid
    assert R == B * T * H * W
    M, N = 72, 100
    a, b = torch.randn(R, M, generator=g), torch.randn(R, N, generator=g)
    a_map = (T, H, W, ws, 1) if maps == "a" else None
    b_map = (T, H, W, ws, 1) if maps == "b" else None
    if maps == "a":
        b_map = (T, H, W, ws, 0)
    want = gemm.wgrad_sm90_ref(a, b, a_map, b_map)
    got, n = wgrad_tile(a, b, a_map, b_map, other)
    assert n == splits
    assert _rel(got, want) <= TOL_F32_REL
    ar = a[gemm.window_rows(R, a_map)]
    br = b[gemm.window_rows(R, b_map)]
    assert _rel(mm_1xtf32(ar.t(), br), want) > 10 * TOL_F32_REL


def test_weight_gradient_split_plans():
    """The splits of the training shapes' launches (the 132 SMs' waves
    filled best): K6's dw1 and dw2 in one queue, 128 tiles at stage 1
    unsplit, 512 at stage 2 in 17 ranges of 2,432 rows (the last 2,048);
    K5's dwqkv and dwproj, 64 tiles in two ranges, 256 in 17; `wgrad_f32`
    alone at K5's stage-1 dwqkv (48 tiles) in 11."""
    assert gemm.wgrad_splits(163840, 128) == (1, 163840)
    assert gemm.wgrad_splits(40960, 512) == (17, 2432)
    assert gemm.wgrad_splits(163840, 64) == (2, 81920)
    assert gemm.wgrad_splits(40960, 256) == (17, 2432)
    assert gemm.wgrad_splits(163840, 48) == (11, 14912)


@pytest.mark.parametrize("shift", [0, 2])
def test_db1_from_row_tile_partials(shift):
    """K6 fp32's db1 as the dpre GEMM's epilogue forms it
    (`gemm.f32_colsum`: each 128-row tile's column sums, rows past R 0,
    then the tiles' partials in order) over dpre = dL / dpre of the
    twin's forward, R 600 (four tiles and one of 88 rows), with and
    without the shift: within TOL_F32_REL of db1 from autograd of the twin
    `swin_block_epilogue_bwd_ref`; the last, ragged tile dropped misses it
    tenfold."""
    from stswincl_tpu_torch.ops import add_ln_mlp as epi
    from stswincl_tpu_torch.ops.mlp import gelu
    g = torch.Generator().manual_seed(23)
    B, T, H, W, C, ws = 1, 2, 15, 20, 128, 5
    hidden, R = 4 * C, B * T * H * W

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale
    x, y, go = (randn(B, T, H, W, C) for _ in range(3))
    s2, b2 = 1.0 + randn(C, scale=0.1), randn(C, scale=0.1)
    w1, b1 = randn(hidden, C, scale=2 * C ** -0.5), randn(hidden, scale=0.1)
    w2 = randn(C, hidden, scale=2 * hidden ** -0.5)
    bw2, s1, b1n = randn(C, scale=0.1), 1.0 + randn(C, scale=0.1), randn(C)
    want = epi.swin_block_epilogue_bwd_ref(x, y, s2, b2, w1, b1, w2, bw2,
                                           s1, b1n, go, True, shift, ws)[5]
    s32 = x + (torch.roll(y, (shift, shift), dims=(2, 3)) if shift else y)
    n2 = epi.layer_norm_f32(s32, s2, b2, 1e-5)
    pre = torch.nn.functional.linear(n2, w1, b1).requires_grad_()
    with torch.enable_grad():
        m = torch.nn.functional.linear(gelu(pre, True), w2, bw2)
        out = epi.layer_norm_f32(s32 + m, s1, b1n, 1e-5)
        (dpre,) = torch.autograd.grad(out, pre, go)
    dpre = dpre.reshape(R, hidden)
    assert _rel(gemm.f32_colsum(dpre), want) <= TOL_F32_REL
    assert _rel(gemm.f32_colsum(dpre[:512]), want) > 10 * TOL_F32_REL
