"""The schedule of the port's row-17 kernel (`csrc/conv.cu` on the Hopper
GEMM's EPI_CONV form), emulated in plain PyTorch on the CPU, against the
port's twin `conv3x3_bn_act_ref` and the Pallas kernel in interpret mode.

The emulation walks what the card does: the output patch of `ops.conv.
patch_shape`, the weights of `ops.conv.pack_weights`, and per patch, tap
and 64-channel block one TMA box of x zero-filled outside the image and
past Cin, skipped where the box lies wholly in the padding (the rule of
`conv_tap_live`), accumulated in fp32; then the epilogue's scale, shift,
residual and ReLU on the patch's pixels inside the image."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.ops import pallas_conv as jconv  # noqa: E402
from stswincl_tpu_torch.ckpt.from_jax import to_jax_layout  # noqa: E402
from stswincl_tpu_torch.ops import conv  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

# fp32 on all sides: the same products summed in another order (by tap and
# 64-channel block here, by XLA's / the interpreter's order there), K at
# most 9 x 128, so ||emulation - reference|| / ||reference|| <= 1e-5
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def tap_live(H, W, d, bh, bw, h0, w0, tap):
    """`conv_tap_live` (`csrc/gemm_sm90.cu`): does tap `tap`'s box over the
    patch at (h0, w0) reach into the image?"""
    y, x = h0 + (tap // 3 - 1) * d, w0 + (tap % 3 - 1) * d
    return y < H and y + bh > 0 and x < W and x + bw > 0


def tma_box(x, n, c0, x0, y0, bw, bh, k=conv.K_TILE):
    """One (k channels, bw, bh, 1) TMA box of the NHWC image x at (c0, x0,
    y0, n), as it lands in shared memory: (bh, bw, k), every element
    outside the tensor zero, at negative coordinates too."""
    _, H, W, cin = x.shape
    box = torch.zeros(bh, bw, k, dtype=x.dtype)
    ya, yb = max(y0, 0), min(y0 + bh, H)
    xa, xb = max(x0, 0), min(x0 + bw, W)
    cc = min(c0 + k, cin)
    if ya < yb and xa < xb and c0 < cc:
        box[ya - y0:yb - y0, xa - x0:xb - x0, :cc - c0] = \
            x[n, ya:yb, xa:xb, c0:cc]
    return box


def emulate(x, w, scale, shift, dilation, relu, residual):
    """Row 17 as the kernel schedules it. Returns (output, k tiles skipped,
    k tiles run, times each output pixel was written)."""
    N, H, W, _ = x.shape
    cout = w.shape[0]
    bh, bw = conv.patch_shape(H, W)
    assert bh * bw == conv.TILE_ROWS
    wt = conv.pack_weights(w)
    cb = wt.shape[1] // 9 // conv.K_TILE
    out = torch.zeros(N, H, W, cout)
    writes = torch.zeros(N, H, W, dtype=torch.int64)
    skipped = run = 0
    rows = torch.arange(conv.TILE_ROWS)
    for n in range(N):
        for h0 in range(0, -(-H // bh) * bh, bh):
            for w0 in range(0, -(-W // bw) * bw, bw):
                acc = torch.zeros(conv.TILE_ROWS, cout)
                for tap in range(9):
                    y0 = h0 + (tap // 3 - 1) * dilation
                    x0 = w0 + (tap % 3 - 1) * dilation
                    live = tap_live(H, W, dilation, bh, bw, h0, w0, tap)
                    for c in range(cb):
                        box = tma_box(x, n, c * conv.K_TILE, x0, y0, bw, bh)
                        if not live:  # the skip drops only zeros
                            assert not box.any()
                            skipped += 1
                            continue
                        run += 1
                        k0 = (tap * cb + c) * conv.K_TILE
                        acc += box.reshape(conv.TILE_ROWS, conv.K_TILE) @ \
                            wt[:, k0:k0 + conv.K_TILE].t()
                # tile row r is pixel (h0 + r // bw, w0 + r % bw)
                ys, xs = h0 + rows // bw, w0 + rows % bw
                ok = (ys < H) & (xs < W)
                v = (acc * scale + shift)[ok]
                if residual is not None:
                    v = v + residual[n, ys[ok], xs[ok]]
                if relu:
                    v = v.clamp_min(0.0)
                out[n, ys[ok], xs[ok]] = v
                writes[n, ys[ok], xs[ok]] += 1
    return out, skipped, run, writes


def _case(rng, N, H, W, cin, cout, with_res):
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(  # noqa: E731
        np.float32)
    return (f(N, H, W, cin), f(cout, cin, 3, 3, k=(9 * cin) ** -0.5),
            f(cout, k=0.1, o=1.0), f(cout, k=0.1),
            f(N, H, W, cout) if with_res else None)


# (N, H, W, Cin, Cout, dilation, relu, residual): W off the picked patch
# width (W 48 -> bw 64; W 36 -> bw 16; W 20 -> bw 8 x bh 16 over H 10),
# dilation at or past H (most or all off-centre taps in the padding), Cin
# 32 and 96 (the channels up to 64 zero-filled), N > 1
CASES = {
    "N2 12x48 96->40 d13 res": (2, 12, 48, 96, 40, 13, True, True),
    "N3 16x32 32->16 d2 linear": (3, 16, 32, 32, 16, 2, False, False),
    "N2 8x16 32->8 d20 res": (2, 8, 16, 32, 8, 20, True, True),
    "N2 10x20 64->24 d1": (2, 10, 20, 64, 24, 1, True, False),
    "N1 9x36 128->16 d4 res": (1, 9, 36, 128, 16, 4, True, True),
}
# the Pallas kernel's own envelope: W a multiple of 16, H of a row band
PALLAS = {k for k, c in CASES.items() if c[2] % 16 == 0 and c[1] % 4 == 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_the_twin_and_pallas(rng, case):
    N, H, W, cin, cout, d, relu, with_res = CASES[case]
    x, w, scale, shift, res = _case(rng, N, H, W, cin, cout, with_res)
    kw = dict(dilation=d, relu=relu,
              residual=None if res is None else T_(res))
    got, skipped, run, writes = emulate(T_(x), T_(w), T_(scale),
                                        T_(shift), d, relu, kw["residual"])
    assert torch.equal(writes, torch.ones_like(writes))  # each pixel once
    want = conv.conv3x3_bn_act_ref(T_(x), T_(w), T_(scale), T_(shift),
                                   **kw)
    assert got.shape == want.shape and _rel(got, want) <= TOL
    if d >= H:  # the skip is taken, and never drops the centre tap
        assert skipped > 0 and run >= -(-cin // conv.K_TILE)
    if case in PALLAS:
        jwant = jconv.conv3x3_bn_act(
            jnp.asarray(x), jnp.asarray(to_jax_layout("conv.weight", w)),
            jnp.asarray(scale), jnp.asarray(shift), dilation=d, relu=relu,
            residual=None if res is None else jnp.asarray(res),
            interpret=True)
        assert _rel(got, jwant) <= TOL


def test_pallas_cases_are_covered():
    """At least the d >= H case and both Cin off 64 run in interpret mode."""
    assert {"N2 12x48 96->40 d13 res", "N3 16x32 32->16 d2 linear"} <= PALLAS


@pytest.mark.parametrize("H,W,want", [
    (64, 80, (8, 16)), (32, 40, (16, 8)), (128, 160, (4, 32)),
])
def test_patch_shape_tiles_the_main_shapes_exactly(H, W, want):
    """Every image of `chip_smoke.py` phase 2e and of the conv profiler
    (64x80, 128x160, the ASPP's 32x40 and 64x80) is tiled with no
    padded pixel, by the patch the kernel's design names."""
    bh, bw = conv.patch_shape(H, W)
    assert (bh, bw) == want and H % bh == 0 and W % bw == 0
    assert bh * bw == conv.TILE_ROWS


def test_patch_shape_pads_least():
    """Off the exact shapes the picker pads fewest pixels, widest first."""
    for H in range(1, 40):
        for W in range(1, 140):
            bh, bw = conv.patch_shape(H, W)
            padded = -(-H // bh) * bh * (-(-W // bw) * bw)
            for b in conv.PATCH_WIDTHS:
                h = conv.TILE_ROWS // b
                other = -(-H // h) * h * (-(-W // b) * b)
                assert padded < other or (padded == other and bw >= b)


@pytest.mark.parametrize("cin", [32, 64, 96])
def test_pack_weights_layout(rng, cin):
    """Column tap * Cin64 + ci of the packed weights is w[:, ci, ky, kx]
    (tap = 3 ky + kx); the padded channels are zero."""
    w = T_(rng.standard_normal((8, cin, 3, 3)).astype(np.float32))
    wt = conv.pack_weights(w)
    cin64 = -(-cin // 64) * 64
    assert wt.shape == (8, 9 * cin64) and wt.is_contiguous()
    for tap in range(9):
        blk = wt[:, tap * cin64:(tap + 1) * cin64]
        assert torch.equal(blk[:, :cin], w[:, :, tap // 3, tap % 3])
        assert not blk[:, cin:].any()
