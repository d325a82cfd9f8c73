"""K4's banded schedule and K3's backward, on the CPU.

K4 (`csrc/upsample_argmax.cu`) sums each row of the two interpolation
matrices over its span only (`ops.upsample_argmax.interp_spans`). The
spans are held to their definition at both eval protocols and on dense,
zero-row and out-of-order matrices. The kernel's schedule is then emulated
in plain PyTorch: a block of 16 output rows x 128 output columns takes its
band of x from the min of lo and the max of hi over its own rows and
columns, forms t = mh @ x for its rows on the band's columns only (NaN
elsewhere, so a sum that reached outside the band would show), and each
output sums its own column's span of t; every sum runs in ascending index
order, with the kernel's bf16 rounding points (logits, both matrices, t)
unless `exact`, and a strict `>` across the classes. The emulation is held
against the port's twin `upsample_argmax_ref` and the Pallas kernel in
interpret mode on >= 99.9 % of pixels (`TOL_K4_SHARE` of `chip_smoke.py`:
the sums run in another order there, so a near-tie may flip).

K3's backward (`ops.patch_merge.PatchMergeFn`): the products dn = g @ w and
dW = g^T @ n in x's dtype with fp32 accumulation, the LayerNorm's backward
by autograd of the twin's LayerNorm, against `jax.vjp` of the Pallas
`fused_patch_merge` in interpret mode (its backward is the vjp of
`patch_merge_ref`), in bf16 and fp32.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from stswincl_tpu.ops import pallas_patch_merge as jpm  # noqa: E402
from stswincl_tpu.ops import pallas_upsample_argmax as jua  # noqa: E402
from stswincl_tpu_torch.ops import patch_merge  # noqa: E402
from stswincl_tpu_torch.ops.resize import composed_matrices  # noqa: E402
from stswincl_tpu_torch.ops.upsample_argmax import (  # noqa: E402
    interp_spans, upsample_argmax_ref)

torch.set_num_threads(1)
T_ = torch.from_numpy
HB, OB = 16, 128  # the kernel's block: UA_HB output rows x UA_OB columns
TOL_K4_SHARE = 0.999


def _spans_np(m):
    """[lo, hi) of the nonzeros of each row, by a loop over the rows."""
    out = np.zeros((m.shape[0], 2), np.int32)
    for i, row in enumerate(np.asarray(m)):
        nz = np.flatnonzero(row)
        if nz.size:
            out[i] = nz[0], nz[-1] + 1
    return out


@pytest.mark.parametrize("protocol", ["endovis", "cadis"])
def test_spans_of_the_eval_protocols(protocol):
    """(a) EndoVis: 64x80 -> 512x640 -> 1024x1280 (align_out True); CaDIS:
    a 67x84 head -> 536x672 -> 540x960 (align_out False): every row of both
    composed matrices spans at most 3 input rows or columns."""
    if protocol == "endovis":
        mats = composed_matrices(64, 80, (512, 640), (1024, 1280))
    else:
        mats = composed_matrices(67, 84, (536, 672), (540, 960),
                                 align_out=False)
    for m in mats:
        s = interp_spans(m)
        assert s.dtype == torch.int32 and tuple(s.shape) == (m.shape[0], 2)
        np.testing.assert_array_equal(s.numpy(), _spans_np(m))
        width = s[:, 1] - s[:, 0]
        assert int(width.min()) >= 1 and int(width.max()) <= 3


def test_spans_of_a_dense_matrix():
    """(b) every entry nonzero: full-row spans."""
    m = torch.rand(37, 11, generator=torch.Generator().manual_seed(0)) + 0.1
    s = interp_spans(m)
    assert (s[:, 0] == 0).all() and (s[:, 1] == 11).all()


def test_spans_of_an_all_zero_row():
    """(c) an all-zero row gets the empty span [0, 0); the others keep
    theirs, zeros inside a span included."""
    m = torch.zeros(4, 9)
    m[0, 2], m[0, 5] = 0.5, 0.25
    m[2, 8] = 1.0
    m[3, 0] = -1.0
    np.testing.assert_array_equal(interp_spans(m).numpy(),
                                  [[2, 6], [0, 0], [8, 9], [0, 1]])


def test_spans_that_are_not_monotone():
    """(d) rows of a bilinear matrix permuted: each span moves with its row,
    so lo is not monotone over the rows."""
    mh, _ = composed_matrices(16, 24, (128, 192), (200, 300))
    perm = torch.randperm(200, generator=torch.Generator().manual_seed(1))
    s = interp_spans(mh[perm])
    np.testing.assert_array_equal(s.numpy(), interp_spans(mh)[perm].numpy())
    assert (s[1:, 0] < s[:-1, 0]).any()


def emulate(x, mh, mw, exact):
    """K4 as the kernel schedules it (module docstring); (B, OH, OW) int32."""
    def rnd(t):
        t = t.float()
        return t if exact else t.to(torch.bfloat16).float()
    B, NC, h, w = x.shape
    OH, OW = mh.shape[0], mw.shape[0]
    sh, sw = interp_spans(mh).long(), interp_spans(mw).long()
    xr, mhr, mwr = rnd(x), rnd(mh), rnd(mw)
    out = torch.empty((B, OH, OW), dtype=torch.int32)

    def band(spans):
        live = spans[:, 0] < spans[:, 1]
        if not live.any():
            return 0, 0
        return int(spans[live, 0].min()), int(spans[live, 1].max())

    for r0 in range(0, OH, HB):
        rows = torch.arange(r0, min(r0 + HB, OH))
        for o0 in range(0, OW, OB):
            cols = torch.arange(o0, min(o0 + OB, OW))
            rlo, rhi = band(sh[rows])
            clo, chi = band(sw[cols])
            xband = xr[:, :, rlo:rhi, clo:chi]  # what the block stages
            # t on the band's columns, each row over its own span,
            # ascending; NaN off the band
            t = torch.full((B, NC, len(rows), w), float("nan"))
            acc = torch.zeros((B, NC, len(rows), chi - clo))
            lo, n = sh[rows, 0], sh[rows, 1] - sh[rows, 0]
            for s in range(int(n.max()) if len(n) else 0):
                valid = s < n
                j = torch.where(valid, lo + s, rlo)
                prod = (mhr[rows, j.clamp(max=h - 1)][:, None]
                        * xband[:, :, (j - rlo).clamp(0, max(rhi - rlo - 1,
                                                             0))])
                acc = torch.where(valid[:, None], acc + prod, acc)
            t[..., clo:chi] = rnd(acc)
            # each output over its own column's span of t, ascending
            lo, n = sw[cols, 0], sw[cols, 1] - sw[cols, 0]
            y = torch.zeros((B, NC, len(rows), len(cols)))
            for s in range(int(n.max())):
                valid = s < n
                k = torch.where(valid, lo + s, 0)
                y = torch.where(valid, y + t[..., k] * mwr[cols, k], y)
            assert not torch.isnan(y).any(), "a sum reached off the band"
            best = torch.full((B, len(rows), len(cols)), -float("inf"))
            idx = torch.zeros((B, len(rows), len(cols)), dtype=torch.int32)
            for c in range(NC):  # strict: ties keep the earlier class
                take = y[:, c] > best
                idx = torch.where(take, c, idx)
                best = torch.where(take, y[:, c], best)
            out[:, rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = idx
    return out


def _k4_case(name, rng):
    """(x, mh, mw): OH and OW no multiple of the 16 x 128 block."""
    x = rng.standard_normal((2, 5, 16, 24)).astype(np.float32)
    mh, mw = (m.numpy() for m in composed_matrices(16, 24, (128, 192),
                                                   (200, 300)))
    if name == "dense":
        mh = rng.random((70, 16)).astype(np.float32)
        mw = rng.random((150, 24)).astype(np.float32)
    elif name == "not monotone":
        mh, mw = mh[rng.permutation(200)], mw[rng.permutation(300)]
    elif name == "zero rows":
        mh, mw = mh.copy(), mw.copy()
        mh[7] = mh[16:32] = 0.0
        mw[130] = mw[:128] = 0.0  # a whole block with no column
    elif name == "cadis":
        x = rng.standard_normal((1, 12, 67, 84)).astype(np.float32)
        mh, mw = (m.numpy() for m in composed_matrices(
            67, 84, (536, 672), (540, 960), align_out=False))
    return x, np.ascontiguousarray(mh), np.ascontiguousarray(mw)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", ["composed", "dense", "not monotone",
                                  "zero rows", "cadis"])
def test_schedule_matches_twin_and_pallas(rng, name, exact):
    x, mh, mw = _k4_case(name, rng)
    got = emulate(T_(x), T_(mh), T_(mw), exact)
    twin = upsample_argmax_ref(T_(x), T_(mh), T_(mw), exact)
    pallas = np.asarray(jua.upsample_argmax_pallas(
        jnp.asarray(x), jnp.asarray(mh), jnp.asarray(mw), interpret=True,
        exact=exact))
    assert got.shape == twin.shape == pallas.shape
    for want in (twin.numpy(), pallas):
        share = (got.numpy() == want).mean()
        assert share >= TOL_K4_SHARE, share


@pytest.mark.parametrize("exact", [True, False])
def test_schedule_ties_take_first_class(rng, exact):
    """Class 0 below class 1 everywhere, classes 1 and 2 equal: 1 wins on
    every pixel, across the block edges too."""
    plane = rng.standard_normal((1, 1, 16, 24)).astype(np.float32)
    x = np.concatenate([plane - 1.0, plane, plane], axis=1)
    _, mh, mw = _k4_case("composed", rng)
    assert (emulate(T_(x), T_(mh), T_(mw), exact) == 1).all()


def _pm_case(rng, dtype):
    C = 32
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(
        np.float32)
    x = T_(f(3, 8, 12, C)).to(dtype)
    scale, bias = f(4 * C, k=0.1, o=1.0), f(4 * C, k=0.1)
    w = f(4 * C, 2 * C, k=0.05)  # the JAX layout; fp32, as parameters are
    g = T_(f(3, 4, 6, 2 * C)).to(dtype)
    return x, scale, bias, w, g


def _rel(got, want):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# bf16: dn (so dx) and dW are rounded to bf16 on both sides from fp32 sums
# taken in other orders, so a few elements may sit one bf16 step (2^-8
# relative) apart, and dscale / dbias sum those dn: 1e-3 on the norm.
# fp32: the same products in fp32, summed in other orders: 1e-5.
PM_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_patch_merge_backward_matches_jax_vjp(rng, dtype):
    """PatchMergeFn's gradients (x, scale, bias, w) against `jax.vjp` of
    `fused_patch_merge(..., interpret=True)` on the same values, each in
    its input's dtype (dW in w's fp32, rounded through x's dtype)."""
    x, scale, bias, w, g = _pm_case(rng, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    jg = jnp.asarray(g.float().numpy()).astype(jdt)
    _, vjp = jax.vjp(lambda a, s, b, ww: jpm.fused_patch_merge(
        a, s, b, ww, 1e-5, True), jx, jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(w))
    want = vjp(jg)
    leaves = [x.clone().requires_grad_(), T_(scale).requires_grad_(),
              T_(bias).requires_grad_(), T_(w.T.copy()).requires_grad_()]
    got = torch.autograd.grad(patch_merge.patch_merge(*leaves), leaves, g)
    assert [a.dtype for a in got] == [t.dtype for t in leaves]
    want = [np.asarray(v.astype(jnp.float32)) for v in want]
    want[3] = want[3].T
    for n, a, b in zip(("x", "scale", "bias", "w"), got, want):
        assert _rel(a, b) <= PM_TOL[dtype], (n, _rel(a, b))


def test_patch_merge_backward_fp32_matches_twin_autograd(rng):
    """The fp32 path against autograd of the whole fp32 twin."""
    x, scale, bias, w, g = _pm_case(rng, torch.float32)
    inputs = (x, T_(scale), T_(bias), T_(w.T.copy()))
    got, want = ([t.clone().requires_grad_() for t in inputs]
                 for _ in range(2))
    got = torch.autograd.grad(patch_merge.patch_merge(*got), got, g)
    want = torch.autograd.grad(patch_merge.patch_merge_ref(*want), want, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_patch_merge_backward_recomputes_no_product(rng, monkeypatch):
    """The backward recomputes n only: no forward product (F.linear) runs
    in it, and its two products take x's dtype (bf16) operands."""
    x, scale, bias, w, g = _pm_case(rng, torch.bfloat16)
    leaves = [x.clone().requires_grad_(), T_(scale).requires_grad_(),
              T_(bias).requires_grad_(), T_(w.T.copy()).requires_grad_()]
    out = patch_merge.patch_merge(*leaves)

    def no_linear(*a, **k):
        raise AssertionError("the backward recomputed the forward product")
    seen = []
    product = patch_merge._product
    monkeypatch.setattr(F, "linear", no_linear)
    monkeypatch.setattr(patch_merge, "_product", lambda a, b, dt: (
        seen.append((a.dtype, b.dtype)), product(a, b, dt))[1])
    torch.autograd.grad(out, leaves, g)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
