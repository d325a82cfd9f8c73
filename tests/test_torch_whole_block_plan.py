"""Row 16's schedule (`ops.swin_block.whole_block_plan`, the host side of
`csrc/swin_block.cu`) and the envelopes of rows 12, 13 and 16, checked on
the CPU: the tiles of whole windows (as many as fit 128 rows, or one past
128 tokens over two 128-row product tiles) and the window each of their
boxes of x reads cover every image row exactly once, in the window order of
the Hopper GEMM's row map, at both stages' serving and training shapes, on
a ragged last tile and at the new layouts (windows of 48 tokens, which do
not tile 128 rows, 144 and 176, which pass them; C 96 and 2560); every
phase fits the shared memory of one block, with resident or streamed
attention pairs; the kernel's seven phases emulated in PyTorch tile by
tile through the plan's boxes give the twin `whole_swin_block_ref` at
those layouts; every shape K1 and K2 take is taken (C and hidden % 8 to
2560, hd % 8, TN % 16 to 176) and only what they refuse is refused,
with a message; rows 12 and 13 take every width the first MLP products
took; and `whole_swin_block_pair`, row 16's function on the pair's
kernels, runs the twins of the pair on the CPU: with m rounded, row 16's
twin forward, and row 16's backward."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stswincl_tpu_torch import kernels
from stswincl_tpu_torch.ops import add_ln_mlp, attention, gemm, mlp
from stswincl_tpu_torch.ops import swin_block as wb

torch.set_num_threads(1)

# the emulation against the twin: the same formula on the tile's rows; in
# fp32 only the products' summation order differs (by the matrix shapes),
# in bf16 that can also move a rounding of qkv, y, LN2(s), h or m by one
# step
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# (B, T, H, W, C, hidden, heads, ws): both stages of the model
# (`TswinPlus(swin_dim=512, num_heads=4)`), serving at bs 2 (the two-group
# layers fold to 4 clips) and training at batch 8 (16 clips)
SHAPES = {
    "s1_serve": (4, 2, 64, 80, 512, 2048, 4, 8),
    "s2_serve": (4, 2, 32, 40, 1024, 4096, 4, 4),
    "s1_train": (16, 2, 64, 80, 512, 2048, 4, 8),
    "s2_train": (16, 2, 32, 40, 1024, 4096, 4, 4),
    # 6 windows of 32 tokens: a last tile of two windows
    "s2_ragged": (1, 2, 8, 12, 256, 1024, 2, 4),
}
# the layouts the first kernel refused: windows of 48 tokens (two a tile,
# a ragged last tile of one), 144 and 176 (one a tile over two product
# tiles); C 96 (hd 24) and 2560 (hd 640: resident in bf16, streamed in
# fp32), 1280 over one head past 128 tokens (streamed)
NEW_SHAPES = {
    "tn48_c64": (1, 3, 12, 12, 64, 256, 2, 4),
    "tn144_c96": (2, 4, 12, 18, 96, 384, 4, 6),
    "tn176_c1280": (1, 11, 8, 12, 1280, 5120, 1, 4),
    "tn128_c96": (2, 2, 16, 24, 96, 384, 4, 8),
    "tn32_c2560": (1, 2, 8, 12, 2560, 10240, 4, 4),
}
ALL_SHAPES = {**SHAPES, **NEW_SHAPES}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _covered_rows(plan):
    """The image rows of each tile's boxes, in tile then box order (frame,
    row, column within a box), and the window-order row each stands for."""
    B, T, H, W = plan.image
    ws = plan.ws
    f, i, j = np.meshgrid(np.arange(T), np.arange(ws), np.arange(ws),
                          indexing="ij")
    f, i, j = f.ravel(), i.ravel(), j.ravel()
    pixels, order = [], []
    for t in range(plan.tiles):
        for wl, (w0, h0, bt0) in enumerate(plan.tile_boxes(t)):
            pixels.append(((bt0 + f) * H + h0 + i) * W + w0 + j)
            start = t * plan.tile_rows + wl * plan.window_tokens
            order.append(np.arange(start, start + plan.window_tokens))
    return np.concatenate(pixels), np.concatenate(order)


@pytest.mark.parametrize("case", sorted(ALL_SHAPES))
def test_plan_tiles_cover_every_row_once(case):
    B, T, H, W, C, hidden, heads, ws = ALL_SHAPES[case]
    M = B * T * H * W
    TN = T * ws * ws
    for dtype in DTYPES.values():
        plan = wb.whole_block_plan(*ALL_SHAPES[case], dtype)
        assert plan.rows == M and plan.window_tokens == TN
        # whole windows a tile: as many as fit 128 rows, or one over two
        # 128-row product tiles
        assert plan.windows_per_tile == max(1, 128 // TN)
        assert plan.tile_rows == plan.windows_per_tile * TN
        assert plan.m_tiles == (1 if TN <= 128 else 2)
        assert plan.slot_rows == 128 * plan.m_tiles >= plan.tile_rows
        assert plan.tiles == -(-M // plan.tile_rows)
        assert sum(plan.tile_windows(t) for t in range(plan.tiles)) * TN == M
        # x by one 4-D TMA box a window where the windows tile 128 rows
        # (bf16), else through the row map
        assert plan.x_by == ("box" if dtype == torch.bfloat16
                             and 128 % TN == 0 else "rows")
        assert plan.box == (64, ws, ws, T)
        pixels, order = _covered_rows(plan)
        # every image row exactly once
        assert np.array_equal(np.sort(pixels), np.arange(M))
        # each box row is the window-order row the GEMM's row map reads
        want = gemm.window_rows(M, (T, H, W, ws, 0)).numpy()
        assert np.array_equal(pixels, want[order])
        assert np.array_equal(np.sort(order), np.arange(M))


@pytest.mark.parametrize("case", sorted(ALL_SHAPES))
def test_plan_phases_fit_shared_memory(case):
    B, T, H, W, C, hidden, heads, ws = ALL_SHAPES[case]
    plan = wb.whole_block_plan(*ALL_SHAPES[case])
    assert set(plan.phase_smem) == set(wb.PHASES)
    assert all(b <= kernels.SMEM_LIMIT for b in plan.phase_smem.values())
    assert plan.smem_bytes == max(plan.phase_smem.values())
    assert plan.smem_bytes <= kernels.SMEM_LIMIT
    # the attention's pairs in the ring's region: TN / 16 warps a pair, at
    # most the 8 consumer warps (stage 1: one pair of 8 warps; stage 2:
    # four of 2); the resident pair where it fits beside the ring's 1,152
    # bytes of alignment and barriers, else the streamed one (864 TN)
    TN, hd = T * ws * ws, C // heads
    fixed = wb.ALIGN_SLACK + wb.BARRIER_BYTES
    resident = attention._attn_smem_bytes(TN, hd)
    assert plan.streamed == (fixed + resident > kernels.SMEM_LIMIT)
    assert plan.pair_bytes == (864 * TN if plan.streamed else resident)
    assert plan.pair_threads == min(TN // 16 * 32, 256)
    assert plan.attention_group == min(
        256 // plan.pair_threads,
        (kernels.SMEM_LIMIT - fixed) // plan.pair_bytes) >= 1
    assert (plan.phase_smem["attention"] - plan.phase_smem["qkv"]
            == plan.attention_group * plan.pair_bytes - wb.RING_BYTES)
    # one slot: qkv then h (rows x max(3C, hidden) bf16), the attention
    # output then LN2(s) (rows x C bf16) and s (rows x C fp32), rows 128
    # (256 past 128 tokens)
    R = plan.slot_rows
    assert plan.wide == max(3 * C, hidden)
    assert plan.slot_bytes == {"wide": R * plan.wide * 2,
                               "narrow": R * C * 2, "s": R * C * 4}
    mib = sum(plan.slot_bytes.values()) / 2 ** 20
    assert mib == {"s1_serve": 0.875, "s1_train": 0.875, "s2_serve": 1.75,
                   "s2_train": 1.75, "s2_ragged": 0.4375,
                   "tn48_c64": 0.109375, "tn144_c96": 0.328125,
                   "tn176_c1280": 4.375, "tn128_c96": 0.1640625,
                   "tn32_c2560": 4.375}[case]
    if case in SHAPES:  # the first kernel's layouts: nothing moved
        assert not plan.streamed and plan.tile_rows == 128
        assert plan.attention_group == 256 // (TN // 16 * 32)
    assert plan.streamed == (case == "tn176_c1280")


def _old_row16_takes(C, hidden, heads, T, ws):
    """The first row-16 kernel's envelope (its wrapper's checks, and the
    first attention core's shared memory for one (window, head))."""
    TN = T * ws * ws
    if C % 128 or C > 1024 or hidden % 128 or C % heads:
        return False
    hd = C // heads
    if hd % 16 or TN % 16 or TN > attention.MAX_WINDOW_TOKENS or 128 % TN:
        return False
    a = attention._align
    smem = (3 * a(TN * (hd + 8) * 2) + a(TN * max(TN + 4, hd + 4) * 4)
            + a(TN * (TN + 8) * 2) + a(TN * 8))
    return smem <= kernels.SMEM_LIMIT


def test_row16_envelope_takes_every_shape_the_first_kernel_took():
    """Every (C, heads, T, ws) of the first kernel's envelope, hidden 4C,
    gets a plan that fits; a shape the plan refuses raises ValueError
    with its reason."""
    counts = {"old": 0, "new": 0}
    for C in range(128, 1025, 128):
        for heads in range(1, C + 1):
            if C % heads:
                continue
            for T in (1, 2, 4, 8):
                for ws in (1, 2, 4, 8):
                    args = (1, T, 2 * ws, 3 * ws, C, 4 * C, heads, ws)
                    old = _old_row16_takes(C, 4 * C, heads, T, ws)
                    try:
                        plan = wb.whole_block_plan(*args)
                    except ValueError as e:
                        assert str(e).startswith("whole_swin_block: ")
                        assert not old, (args, str(e))
                        continue
                    assert plan.smem_bytes <= kernels.SMEM_LIMIT
                    counts["old"] += old
                    counts["new"] += 1
    assert counts["old"] > 50 and counts["new"] >= counts["old"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("args,why", [
    ((1, 2, 16, 16, 512, 2048, 3, 8), "C % heads"),
    ((1, 2, 12, 16, 512, 2048, 4, 8), "over windows"),
    ((1, 2, 16, 16, 100, 400, 2, 8), "C and hidden multiples of 8"),
    ((1, 2, 16, 16, 512, 2044, 4, 8), "C and hidden multiples of 8"),
    ((1, 2, 16, 16, 96, 384, 8, 8), "head_dim % 8"),
    ((1, 4, 16, 16, 512, 2048, 4, 8), "at most 176"),
    ((1, 12, 8, 8, 512, 2048, 4, 4), "at most 176"),
    ((1, 1, 9, 9, 512, 2048, 4, 3), "tokens % 16"),
])
def test_row16_envelope_refuses_with_a_message(args, why, dtype):
    """What K1 or K2 refuses, row 16 refuses in both forms, naming itself
    and the reason: C % heads, windows not tiling the image, C or hidden
    off 8, head dims off 8, windows past 176 tokens (256, 192) or off 16
    (9)."""
    sfx = "_f32" if dtype == "fp32" else ""
    with pytest.raises(ValueError, match=f"whole_swin_block{sfx}: .*{why}"):
        wb.whole_block_plan(*args, DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("args,was", [
    ((1, 2, 16, 16, 1152, 4608, 8, 8), "C <= 1024"),
    ((1, 2, 16, 16, 192, 768, 2, 8), "C % 128"),
    ((1, 2, 16, 16, 512, 1000, 4, 8), "hidden % 128"),
    ((1, 3, 8, 8, 512, 2048, 4, 4), "do not tile"),
    ((1, 2, 16, 16, 384, 1536, 16, 8), "head_dim % 16"),
    ((1, 2, 16, 16, 1024, 4096, 2, 8), "does not fit shared memory"),
    ((1, 2, 16, 16, 384, 1536, 24, 8), "head_dim % 32 (fp32)"),
    ((1, 2, 16, 16, 512, 2048, 2, 8), "the fp32 pair"),
])
def test_row16_envelope_takes_what_the_first_kernel_refused(args, was,
                                                             dtype):
    """The shapes the first kernels refused (`was`: their reason) are
    taken in both forms, each phase within one block's shared memory: C
    past 1024 and off 128, hidden off 128, windows of 48 tokens, head dims
    of 24 and 16, and pairs past the resident ones (the streamed pair)."""
    plan = wb.whole_block_plan(*args, DTYPES[dtype])
    assert plan.smem_bytes <= kernels.SMEM_LIMIT
    assert plan.attention_group >= 1
    fixed = 0 if dtype == "fp32" else wb.ALIGN_SLACK + wb.BARRIER_BYTES
    TN, hd = args[1] * args[7] ** 2, args[4] // args[6]
    resident = (attention._attn_f32_resident_bytes(TN, hd) if dtype == "fp32"
                else attention._attn_smem_bytes(TN, hd))
    assert plan.streamed == (fixed + resident > kernels.SMEM_LIMIT)


# (T, ws) of every window of 16-176 tokens the grid reaches: ws 4 (16 T), 8
# (64 T), 2 (4 T), 6 (36 T), 12 (144)
K1_WINDOWS = ([(T, 4) for T in range(1, 12)] + [(1, 8), (2, 8), (4, 2),
              (8, 2), (20, 2), (4, 6), (1, 12)])


def _k1_k2_take(C, hidden, heads, T, ws):
    """K1's and K2's envelope on their own terms: K1's attention core
    (`check_attention_core`, heads dividing C) and K2's widths (multiples
    of 8, `check_mlp_widths`)."""
    if C % heads:
        return False
    TN = T * ws * ws
    bias = torch.empty((heads, TN, TN), device="meta")
    try:
        attention.check_attention_core("k1", torch.device("meta"), bias,
                                       None, heads, TN, C // heads)
        mlp.check_mlp_widths("add_ln_mlp", C, hidden)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_row16_takes_every_shape_k1_and_k2_take(dtype):
    """Over C = 8 .. 2560 in steps of 8 and four widths off 8, every head
    count with a head dim of at least 8, hidden 4C and every window of
    K1_WINDOWS (TN 16-176) and three past or off K1's (TN 192, 256, 9):
    the plan takes exactly what K1's attention core and K2's widths take,
    with every phase within one block's shared memory, and refuses the
    rest with a `whole_swin_block` message."""
    dt = DTYPES[dtype]
    windows = K1_WINDOWS + [(12, 4), (4, 8), (1, 3)]
    taken = refused = 0
    for C in [12, 100, 516, 2564] + list(range(8, 2561, 8)):
        heads_list = [h for h in (1, 2, 3, 4, 5, 8, 16, 32) if C // h >= 8]
        for heads in heads_list:
            for T, ws in windows:
                args = (1, T, 2 * ws, ws, C, 4 * C, heads, ws)
                want = _k1_k2_take(C, 4 * C, heads, T, ws)
                try:
                    plan = wb.whole_block_plan(*args, dt)
                except ValueError as e:
                    assert str(e).startswith("whole_swin_block"), str(e)
                    assert not want, (args, str(e))
                    refused += 1
                    continue
                assert want, args
                assert plan.smem_bytes <= kernels.SMEM_LIMIT
                assert plan.attention_group >= 1
                taken += 1
    assert taken > 14000 and refused > 30000, (taken, refused)


def _layer_norm(s, g, b, eps=1e-5):
    return add_ln_mlp.layer_norm_f32(s, g, b, eps)


def emulate_row16(plan, x, wqkv, bqkv, wproj, bproj, bias, s2, b2, w1, b1,
                  w2, bw2, s1, b1n, scale, gelu_exact=True):
    """Row 16's seven phases, tile by tile: each window of a tile gathered
    through the plan's box of x, the products with fp32 sums and the
    kernel's rounding points, the attention of each (window, head) of the
    tile, both LayerNorms on the tile's rows, and the output scattered
    back through the same boxes."""
    B, T, H, W = plan.image
    C, ws, TN, heads = plan.C, plan.ws, plan.window_tokens, plan.heads
    hd, dt = C // heads, x.dtype
    img = x.reshape(B * T, H, W, C)
    out = torch.full_like(img, float("nan"))

    def lin(a, w, b):
        return F.linear(a.float(), w.to(dt).float(), b.float())

    for t in range(plan.tiles):
        boxes = plan.tile_boxes(t)
        rows = torch.cat([img[bt:bt + T, h0:h0 + ws, w0:w0 + ws].reshape(
            TN, C) for w0, h0, bt in boxes])
        qkv = lin(rows, wqkv, bqkv).to(dt)
        q, k, v = qkv.reshape(len(boxes), TN, 3, heads, hd).permute(
            2, 0, 3, 1, 4)
        o = attention.attend_tiled(q, k, v, bias, None, scale)
        o = o.permute(0, 2, 1, 3).reshape(-1, C)
        s = rows.float() + lin(o, wproj, bproj).to(dt).float()
        n2 = _layer_norm(s, s2, b2).to(dt)
        h = mlp.gelu(lin(n2, w1, b1), gelu_exact).to(dt)
        s = s + lin(h, w2, bw2).to(dt).float()
        o1 = _layer_norm(s, s1, b1n).to(dt)
        for wl, (w0, h0, bt) in enumerate(boxes):
            out[bt:bt + T, h0:h0 + ws, w0:w0 + ws] = o1[
                wl * TN:(wl + 1) * TN].reshape(T, ws, ws, C)
    return out.reshape(x.shape)


def _block_args(shape, seed, dtype, weight_dtype=None):
    """Seeded x and the block's parameters (`whole_swin_block`'s order,
    the mask None) with the attention branch about as large as x, the
    four matrices in `weight_dtype` (x's dtype by default); and the
    attention scale."""
    B, T, H, W, C, hidden, heads, ws = shape
    TN = T * ws * ws
    rng = np.random.default_rng(seed)

    def f(*s, k=1.0, o=0.0):
        return torch.from_numpy((rng.standard_normal(s) * k + o)
                                .astype(np.float32))
    x = f(B, T, H, W, C).to(dtype)
    p = [f(3 * C, C, k=1.75 * C ** -0.5), f(3 * C, k=0.1),
         f(C, C, k=1.2 * C ** -0.5), f(C, k=0.1), f(heads, TN, TN), None,
         f(C, k=0.1, o=1.0), f(C, k=0.1), f(hidden, C, k=C ** -0.5),
         f(hidden, k=0.1), f(C, hidden, k=hidden ** -0.5), f(C, k=0.1),
         f(C, k=0.1, o=1.0), f(C, k=0.1)]
    for i in (0, 2, 8, 10):
        p[i] = p[i].to(weight_dtype or dtype)
    return x, p, (C // heads) ** -0.5


@pytest.mark.parametrize("shape,dtype", [
    ((2, 2, 16, 24, 128, 512, 2, 8), torch.float32),
    ((2, 2, 16, 24, 128, 512, 2, 8), torch.bfloat16),
    ((2, 2, 8, 12, 256, 1024, 2, 4), torch.float32),
    ((1, 2, 8, 12, 256, 1024, 2, 4), torch.bfloat16),  # a ragged last tile
    # the new layouts: two windows of 48 a tile and a ragged last one;
    # one window of 144 / 176 a tile over two product tiles; C 96, hd 24
    ((1, 3, 12, 12, 64, 256, 2, 4), torch.float32),
    ((1, 3, 12, 12, 64, 256, 2, 4), torch.bfloat16),
    ((1, 4, 12, 12, 96, 384, 4, 6), torch.float32),
    ((1, 4, 12, 12, 96, 384, 4, 6), torch.bfloat16),
    ((1, 11, 8, 4, 32, 128, 4, 4), torch.float32),
    ((1, 11, 8, 4, 32, 128, 4, 4), torch.bfloat16),
    ((1, 2, 16, 16, 96, 384, 4, 8), torch.bfloat16),
])
def test_schedule_emulation_matches_the_twin(shape, dtype):
    B, T, H, W, C, hidden, heads, ws = shape
    plan = wb.whole_block_plan(*shape)
    x, p, scale = _block_args(shape, 3, dtype)
    want = wb.whole_swin_block_ref(x, *p, heads, scale, ws)
    got = emulate_row16(plan, x, *p[:5], *p[6:], scale)
    assert not got.isnan().any()  # every row written
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= TOL[dtype], rel


def test_mlp_envelope_takes_every_width_the_first_products_took():
    """Rows 12 and 13 on the Hopper GEMM take C and hidden multiples of 8:
    every width the first products took (row 12: multiples of 32; row 13:
    of 128, K2's geometry), both stages' (512 -> 2048, 1024 -> 4096), and
    the JAX tests' C 32 and 64."""
    widths = range(8, 4097, 8)
    for C in widths:
        for hidden in (C, 4 * C, 8):
            mlp.check_mlp_widths("fused_mlp", C, hidden)
            mlp.check_mlp_widths("add_ln_mlp", C, hidden)
    for C in range(32, 4097, 32):
        for hidden in range(32, 4097, 32 * 7):
            mlp.check_mlp_widths("fused_mlp", C, hidden)


@pytest.mark.parametrize("C,hidden", [(36, 128), (64, 100), (0, 64),
                                      (64, 0), (12, 48)])
def test_mlp_envelope_refuses_with_a_message(C, hidden):
    for name in ("fused_mlp", "add_ln_mlp"):
        with pytest.raises(ValueError, match=f"{name}: needs C and hidden "
                           "multiples of 8"):
            mlp.check_mlp_widths(name, C, hidden)


PAIR_SHAPES = [(2, 2, 8, 8, 64, 256, 2, 4), (1, 2, 16, 16, 128, 512, 4, 8)]


@pytest.mark.parametrize("shape", PAIR_SHAPES)
@pytest.mark.parametrize("m_out", [None, True])
def test_pair_forward_is_its_twin(shape, m_out):
    """`whole_swin_block_pair` on CPU tensors runs the pair's twins: with
    m_out it is row 16's twin to the bit (m rounded before the residual
    add), without it K1's twin then K2's as served (the fp32 m)."""
    heads, ws = shape[6], shape[7]
    x, p, scale = _block_args(shape, 5, torch.bfloat16)
    got = wb.whole_swin_block_pair(x, *p, heads, scale, ws, m_out=m_out)
    if m_out:
        want = wb.whole_swin_block_ref(x, *p, heads, scale, ws)
    else:
        y = wb.swin_block_attention_ref(x, *p[:6], heads, scale, ws)
        want = add_ln_mlp.swin_block_epilogue_ref(x, y, *p[6:])
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.parametrize("shape", PAIR_SHAPES)
@pytest.mark.parametrize("m_out", [None, True])
def test_pair_gradients_are_row16s(shape, m_out):
    """Through autograd, `whole_swin_block_pair` (K1's and K2's
    Functions; with m_out K2 saves the rounded m for K6) gives the
    gradients of row 16's Function, whose backward recomputes that pair:
    on the CPU both run the same backward twins, to the bit (bf16 x, fp32
    weights, as a training block hands them over)."""
    heads, ws = shape[6], shape[7]
    x, p, scale = _block_args(shape, 6, torch.bfloat16, torch.float32)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape).astype(np.float32)).to(x.dtype)
    leaves = [t for t in [x, *p] if t is not None]

    def grads(fn):
        ts = [t.detach().requires_grad_() for t in leaves]
        out = fn(*ts[:6], None, *ts[6:], heads, scale, ws)
        return torch.autograd.grad(out, ts, g)

    got = grads(functools.partial(wb.whole_swin_block_pair, m_out=m_out))
    want = grads(wb.whole_swin_block)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
