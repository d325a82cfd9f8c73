"""The fp32 training path of the port, on the CPU: the routing of an fp32
forward that records a graph (through the autograd Functions of K1, K2
and K3, whose card branches call the fp32 forms forward, K2's row-8 form
exactly where `mlp_output_saved`, and the fp32 K5 and K6 backward; shown
on meta tensors, which take the card's branches without a card); the
shared-memory plan of K5 fp32's attention backward; Pallas rows 6, 7, 8
and 9 in fp32 at C 512 and C 1024-class shapes, the port's routed
Function on the CPU against the interpreted Pallas kernel called
directly; and the slice as a whole: one stage-1 train step of
`build_model(dtype="float32")` and one stage-2 step of
`build_contrast_encoder` against the JAX fp32 model routed as on its TPU,
its Pallas kernels interpreted (their custom VJPs then take XLA's vjp of
the references, which is why rows 6-9 are called directly above).

Tolerances: rows 6-9, ||port - pallas|| / ||pallas|| <= ROW_REL (2e-5)
for every output: fp32 on both sides, the same products and erf
polynomial in other summation orders (about 1e-6 measured). The train
steps keep the bounds of tests/test_torch_train.py and
tests/test_torch_contrast.py, stated there (flax's E[x^2] - E[x]^2
BatchNorm backward limits the gradients to 1e-2, the stage-2 step adds 8x
the port's own spread on clips perturbed by 1e-7)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.models import ContrastEncoder as JContrastEncoder  # noqa: E402
from stswincl_tpu.ops import pallas_add_ln_mlp as jepi  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jattn  # noqa: E402
from stswincl_tpu.ops.window import (  # noqa: E402
    relative_position_index, shifted_window_attention_mask)
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_contrast as jtc  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ckpt import jax_path, to_jax_layout  # noqa: E402
from stswincl_tpu_torch.configs import (ContrastTrainConfig,  # noqa: E402
                                        DataConfig, ModelConfig,
                                        SegTrainConfig)
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.ops import (add_ln_mlp, block_attention,  # noqa: E402
                                    patch_merge)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from stswincl_tpu_torch.pipelines.contrast import (  # noqa: E402
    build_contrast_encoder)
from stswincl_tpu_torch.pipelines.seg import make_tx, train_steps  # noqa: E402
from stswincl_tpu_torch.train import train_seg  # noqa: E402
from test_torch_contrast import _port_step, _seeded_stats  # noqa: E402
from test_torch_fp32 import jax_tpu_interpreted  # noqa: E402,F401
from test_torch_train import (_jax_variables, _leaf, _recording,  # noqa: E402
                              _rel)

torch.set_num_threads(1)
T_ = torch.from_numpy
ROW_REL = 2e-5


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def _like(*shape):
    return torch.empty(shape, device="meta")


B, T, H, W, WS = 1, 2, 8, 8, 4


def _k1_case(calls, monkeypatch, C=512, heads=4):
    TN = T * WS * WS

    def fwd(x, *a):
        calls.append("forward")
        rows = x.numel() // C
        return _like(*x.shape), _like(rows, 3 * C), _like(rows, C)

    def bwd(x, g, qkv, attn, *a):
        calls.append(("backward", tuple(qkv.shape), tuple(attn.shape)))
        return (_like(*x.shape), _like(3 * C, C), _like(3 * C), _like(C, C),
                _like(C), _like(heads, TN, TN))

    monkeypatch.setattr(block_attention, "_forward_f32", fwd)
    monkeypatch.setattr(block_attention, "swin_block_attention_bwd_f32", bwd)
    args = (_meta(B, T, H, W, C, grad=True), _meta(3 * C, C, grad=True),
            _meta(3 * C, grad=True), _meta(C, C, grad=True),
            _meta(C, grad=True), _meta(heads, TN, TN, grad=True), None,
            heads, 0.125, WS)
    out = block_attention.swin_block_attention(*args, shift=WS // 2)
    return out, args[:6], "BlockAttentionFn"


def _k2_case(calls, monkeypatch, C, shift):
    hidden = 4 * C
    saved = []

    def fwd(x, *a, m_out=False, **kw):
        calls.append(("forward", m_out))
        out = _like(*x.shape)
        if m_out:
            saved.append(_like(*x.shape))
            return out, saved[-1]
        return out

    def bwd(x, y, g, m, *a, **kw):
        calls.append(("backward", m is not None
                      and any(m is s for s in saved)))
        return (_like(*x.shape), _like(*x.shape), _like(C), _like(C),
                _like(hidden, C), _like(hidden), _like(C, hidden), _like(C),
                _like(C), _like(C))

    monkeypatch.setattr(add_ln_mlp, "swin_block_epilogue_f32", fwd)
    monkeypatch.setattr(add_ln_mlp, "swin_block_epilogue_bwd_f32", bwd)
    v = functools.partial(_meta, grad=True)
    args = (_meta(B, T, H, W, C, grad=True), _meta(B, T, H, W, C, grad=True),
            v(C), v(C), v(hidden, C), v(hidden), v(C, hidden), v(C), v(C),
            v(C))
    out = add_ln_mlp.swin_block_epilogue(*args, shift=shift, ws=WS)
    return out, args, "EpilogueFn"


def _k3_case(calls, monkeypatch, C=512):
    def fwd(x, *a):
        calls.append("forward")
        return _like(x.shape[0], x.shape[1] // 2, x.shape[2] // 2, 2 * C)

    monkeypatch.setattr(patch_merge, "patch_merge_f32", fwd)
    args = (_meta(4, H, W, C, grad=True), _meta(4 * C, grad=True),
            _meta(4 * C, grad=True), _meta(2 * C, 4 * C, grad=True))
    return patch_merge.patch_merge(*args), args, "PatchMergeFn"


ROUTES = {
    "K1 -> K5": (lambda c, mp: _k1_case(c, mp),
                 ["forward", ("backward", (B * T * H * W, 1536),
                              (B * T * H * W, 512))]),
    "K2 C 512 -> row 7": (lambda c, mp: _k2_case(c, mp, 512, 0),
                          [("forward", False), ("backward", False)]),
    "K2 C 512 shifted -> row 7": (lambda c, mp: _k2_case(c, mp, 512, 2),
                                  [("forward", False), ("backward", False)]),
    "K2 C 1024 -> rows 8, 9": (lambda c, mp: _k2_case(c, mp, 1024, 2),
                               [("forward", True), ("backward", True)]),
    "K3": (lambda c, mp: _k3_case(c, mp), ["forward"]),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_fp32_training_routes_through_the_functions(monkeypatch, case):
    """An fp32 forward off the CPU that records a graph goes through the
    wrapper's autograd Function, whose forward calls the fp32 form once
    (K2's with its m output exactly where `mlp_output_saved`: C 1024) and
    whose backward calls the fp32 backward form once: K5 with K1's
    window-order scratch, K6 with the m that row 8 saved (row 9) or none
    (row 7); K3's backward is the twin's vjp, no form. Every leaf gets a
    gradient of its own shape."""
    make, want = ROUTES[case]
    calls = []
    out, leaves, fn = make(calls, monkeypatch)
    assert out.device.type == "meta"
    assert type(out.grad_fn).__name__ == fn + "Backward"
    grads = torch.autograd.grad(out, leaves, _like(*out.shape))
    assert calls == want
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape)
                                               for t in leaves]
    C = leaves[0].shape[-1]
    if fn == "EpilogueFn":
        assert add_ln_mlp.mlp_output_saved(C, 4 * C, torch.float32) == (
            C == 1024)


def test_fp32_attention_backward_shared_memory_plan(monkeypatch):
    """K5 fp32's attention backward (`csrc/fp32_attention_bwd.cuh`): where
    its resident passes fit (a query pass holding k, v and each warp's q,
    then dO, of a (window, head); a key pass holding k, v and a ring of
    16-query chunks of q and dO, three past 32 tokens): stage 1 (TN 128, hd
    128) and stage 2 (TN 32, hd 256), both stages of `swin_dim` 128 (hd 32)
    and every 16-token window up to 128 (TN 96 among them), at every head
    dim of 8 (48 and 24 among them). Past them the streamed passes (the
    fp32 forward's ring, 864 TN bytes; the key pass's chunks of P, dS, q
    and dO) take every other window K1 takes: TN 128 at hd 192 and 256
    (`num_heads=2`), TN 144, and any head dim of 8 (296 at TN 128 among
    them). A window K1 refuses (TN 192) and a head dim off 8 are refused
    by `check_backward_window` before any launch: the Function's forward
    raises without calling the form."""
    plan = block_attention._attn_f32_bwd_smem_bytes
    assert plan(128, 128) == 4 * 3 * 128 * 132 == 202752
    assert plan(32, 256) == 4 * (2 * 32 + 2 * 16 * 2) * 260 == 133120
    assert plan(96, 128) == 4 * 3 * 96 * 132 == 152064
    assert max(plan(128, 128), plan(32, 256)) <= kernels.SMEM_LIMIT
    assert plan(128, 256) == plan(128, 192) == 3 * 128 * 72 * 4 == 110592
    assert plan(144, 64) == 3 * 144 * 72 * 4 == 124416
    assert plan(32, 512) == 4 * 3 * (2 * 16 * 40 + 2 * 16 * 72) == 43008
    check = block_attention.check_backward_window
    f32 = dict(dtype=torch.float32, device="meta")
    check("k5", torch.empty((1, 2, 8, 8, 512), **f32), 4, 8)    # s1
    check("k5", torch.empty((1, 2, 4, 4, 1024), **f32), 4, 4)   # s2
    check("k5", torch.empty((1, 4, 4, 4, 256), **f32), 4, 4)    # TN 64
    check("k5", torch.empty((1, 2, 4, 4, 128), **f32), 4, 4)    # hd 32
    check("k5", torch.empty((1, 2, 8, 8, 128), **f32), 4, 8)    # TN 128
    check("k5", torch.empty((1, 6, 4, 4, 256), **f32), 4, 4)    # TN 96
    check("k5", torch.empty((1, 2, 4, 4, 192), **f32), 4, 4)    # hd 48
    check("k5", torch.empty((1, 2, 8, 8, 96), **f32), 4, 8)     # hd 24
    check("k5", torch.empty((1, 2, 8, 8, 512), **f32), 2, 8)    # hd 256
    check("k5", torch.empty((1, 1, 12, 12, 256), **f32), 4, 12)  # TN 144
    check("k5", torch.empty((1, 2, 8, 8, 768), **f32), 4, 8)    # hd 192
    check("k5", torch.empty((1, 2, 8, 8, 592), **f32), 2, 8)    # hd 296
    refused = (((1, 3, 8, 8, 592), 2, 8),     # TN 192, hd 296
               ((1, 12, 4, 4, 256), 4, 4),    # TN 192
               ((1, 2, 4, 4, 200), 4, 4))     # hd 50
    for shape, heads, ws in refused:
        with pytest.raises(ValueError, match="fp32 form"):
            check("k5", torch.empty(shape, **f32), heads, ws)
    # the same windows pass bf16's own plan where it takes them
    check("k5", torch.empty((1, 2, 4, 4, 128), dtype=torch.bfloat16,
                            device="meta"), 4, 4)
    calls = []
    monkeypatch.setattr(block_attention, "_forward_f32",
                        lambda *a: calls.append(a))
    C, TN = 592, 192
    with pytest.raises(ValueError, match="fp32 form"):
        block_attention.swin_block_attention(
            _meta(1, 3, 8, 8, C), _meta(3 * C, C, grad=True), _meta(3 * C),
            _meta(C, C), _meta(C), _meta(2, TN, TN), None, 2, 0.1, 8)
    assert calls == []


# ---- rows 6-9 against the interpreted Pallas kernels ----------------------

# (C, heads, ws, T, H, W): stage 1's window (TN 128, hd 128) and stage 2's
# (TN 32, hd 256), two windows a row of the image
STAGES = {"C 512": (512, 4, 8, 2, 16, 16), "C 1024": (1024, 4, 4, 2, 8, 8)}


def _rel_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= ROW_REL, (name, rel)


def _attn_inputs(rng, C, heads, ws, Tn, Hn, Wn, shift):
    f = lambda *s, k=1.0: (rng.standard_normal(s) * k).astype(np.float32)
    N, TN = ws * ws, Tn * ws * ws
    table = f((2 * ws - 1) ** 2, heads)
    idx = relative_position_index(ws, ws)
    bias = np.tile(table[idx.reshape(-1)].reshape(N, N, heads)
                   .transpose(2, 0, 1), (1, Tn, Tn))
    mask = (np.tile(shifted_window_attention_mask(Hn, Wn, ws, shift),
                    (1, Tn, Tn)) if shift else None)
    return dict(x=f(1, Tn, Hn, Wn, C), g=f(1, Tn, Hn, Wn, C),
                wqkv=f(C, 3 * C, k=3 * C ** -0.5), bqkv=f(3 * C, k=0.1),
                wproj=f(C, C, k=2 * C ** -0.5), bproj=f(C, k=0.1),
                bias=bias, mask=mask, TN=TN)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_row6_fp32_matches_pallas(rng, stage, shifted):
    """Pallas row 6 (`fused_swin_block_attention_bwd`, interpreted, routed
    as `_fsba_bwd` routes it: x rolled into the shifted layout, dx rolled
    back) against the gradients of the port's `BlockAttentionFn` (the
    wrapper under autograd) on the same fp32 inputs: dx, dwqkv, dbqkv,
    dwproj, dbproj and the relative bias's gradient."""
    shape = STAGES[stage]
    C, heads, ws = shape[:3]
    shift = ws // 2 if shifted else 0
    c = _attn_inputs(rng, *shape, shift)
    scale = (C // heads) ** -0.5
    mask = (jnp.zeros((1, c["TN"], c["TN"]), jnp.float32)
            if c["mask"] is None else jnp.asarray(c["mask"]))
    xs = jnp.roll(jnp.asarray(c["x"]), (-shift, -shift), axis=(2, 3))
    dx, dwqkv, dbqkv, dwproj, dbproj, dbias = \
        jattn.fused_swin_block_attention_bwd(
            xs, jnp.asarray(c["wqkv"]), jnp.asarray(c["bqkv"]),
            jnp.asarray(c["wproj"]), jnp.asarray(c["bias"]), mask,
            jnp.asarray(c["g"]), heads, scale, ws, interpret=True)
    dx = jnp.roll(dx, (shift, shift), axis=(2, 3))
    leaves = [T_(a).requires_grad_() for a in (
        c["x"], c["wqkv"].T.copy(), c["bqkv"], c["wproj"].T.copy(),
        c["bproj"], c["bias"])]
    out = block_attention.swin_block_attention(
        *leaves, None if c["mask"] is None else T_(c["mask"]), heads, scale,
        ws, shift)
    assert type(out.grad_fn).__name__ == "BlockAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, T_(c["g"]))
    want = (dx, np.asarray(dwqkv).T, dbqkv, np.asarray(dwproj).T, dbproj,
            dbias)
    for name, a, b in zip(("dx", "dwqkv", "dbqkv", "dwproj", "dbproj",
                           "dbias"), got, want):
        _rel_close(a.numpy(), b, f"{name} ({stage}, shift {shift})")


PARAMS = ("s2", "b2", "w1", "b1", "w2", "bw2", "s1", "b1n")


def _epi_inputs(rng, C):
    hidden = 4 * C
    f = lambda *s, k=1.0, o=0.0: (rng.standard_normal(s) * k + o).astype(
        np.float32)
    lead = (1, 2, 8, 8)
    return dict(x=f(*lead, C), y=f(*lead, C), g=f(*lead, C),
                s2=f(C, k=0.1, o=1.0), b2=f(C, k=0.1),
                w1=f(C, hidden, k=2 * C ** -0.5), b1=f(hidden, k=0.1),
                w2=f(hidden, C, k=2 * hidden ** -0.5), bw2=f(C, k=0.1),
                s1=f(C, k=0.1, o=1.0), b1n=f(C, k=0.1))


def _epi_port(c):
    """Leaves (x, y, params...) in the port's layout, requiring grad."""
    return [T_(np.ascontiguousarray(c[k].T if k in ("w1", "w2") else c[k]))
            .requires_grad_() for k in ("x", "y") + PARAMS]


def _epi_routed(c, shift):
    """The port's routed `swin_block_epilogue` under autograd: (out, the
    m its Function saved or None, the gradients of every leaf)."""
    leaves = _epi_port(c)
    out = add_ln_mlp.swin_block_epilogue(*leaves, True, shift,
                                         4 if shift else None)
    assert type(out.grad_fn).__name__ == "EpilogueFnBackward"
    m = out.grad_fn.saved_tensors[-1]
    grads = torch.autograd.grad(out, leaves, T_(c["g"]))
    return out, m, grads


def _check_epi_grads(grads, ds, shift, jgrads, tag):
    dy = jnp.roll(ds, (-shift, -shift), axis=(2, 3)) if shift else ds
    _rel_close(grads[0].numpy(), ds, f"dx {tag}")
    _rel_close(grads[1].numpy(), dy, f"dy {tag}")
    for name, a, b in zip(PARAMS, grads[2:], jgrads):
        b = np.asarray(b)
        _rel_close(a.numpy(), b.T if name in ("w1", "w2") else b,
                   f"{name} {tag}")


@pytest.mark.parametrize("shift", [0, 2])
def test_row7_fp32_matches_pallas(rng, shift):
    """Pallas row 7 (`fused_epilogue_bwd`, m recomputed, interpreted; y
    rolled back first as `_epis_bwd` does) at C 512, hidden 2048, where
    the fp32 routing recomputes m (`mlp_output_saved` False: 16 MiB of
    weights and accumulators), against the port's `EpilogueFn` gradients;
    its forward saved no m."""
    c = _epi_inputs(rng, 512)
    x, y, g = (jnp.asarray(c[k]) for k in ("x", "y", "g"))
    y_un = jnp.roll(y, (shift, shift), axis=(2, 3)) if shift else y
    jp = [jnp.asarray(c[k]) for k in PARAMS]
    ds, *jgrads = jepi.fused_epilogue_bwd(x, y_un, *jp[:7], g, True, 1e-5,
                                          True)
    _, m, grads = _epi_routed(c, shift)
    assert m is None
    _check_epi_grads(grads, ds, shift, jgrads, f"(row 7, shift {shift})")


@pytest.mark.parametrize("shift", [0, 2])
def test_rows8_9_fp32_match_pallas(rng, shift):
    """At C 1024, hidden 4096 the fp32 routing saves m: the port's
    `EpilogueFn` forward (row 8's CPU form) against
    `_fused_epilogue_fwd_with_m` (interpreted) on the output and the
    saved m, and its gradients against `fused_epilogue_bwd_streamed`
    (row 9, interpreted, its two hidden slices and the combine) given the
    Pallas m; y rolled back first as `_epis_fwd` / `_epis_bwd` do."""
    c = _epi_inputs(rng, 1024)
    x, y, g = (jnp.asarray(c[k]) for k in ("x", "y", "g"))
    y_un = jnp.roll(y, (shift, shift), axis=(2, 3)) if shift else y
    jp = [jnp.asarray(c[k]) for k in PARAMS]
    jout, jm = jepi._fused_epilogue_fwd_with_m(x, y_un, *jp, True, 1e-5,
                                               True)
    ds, *jgrads = jepi.fused_epilogue_bwd_streamed(
        x, y_un, *jp[:7], g, jm, True, 1e-5, 2, True)
    out, m, grads = _epi_routed(c, shift)
    tag = f"(rows 8, 9, shift {shift})"
    _rel_close(out.detach().numpy(), jout, f"out {tag}")
    _rel_close(m.numpy(), jm, f"m {tag}")
    _check_epi_grads(grads, ds, shift, jgrads, tag)


# ---- the slice: one train step of each stage ---------------------------

HW, NC, B2 = (128, 128), 5, 2
MODEL = dict(swin_dim=128, swin_depths=(1, 1))
# the bounds of tests/test_torch_train.py and tests/test_torch_contrast.py
LOSS_TOL, GRAD_TOL, GRAD_ATOL, STATS_TOL = 1e-5, 1e-2, 1e-6, 1e-4
C_LOSS_TOL, NOISE_FACTOR, PARAM_TOL = 1e-4, 8.0, 1e-4
TOTAL_STEPS = 100
JAX_TRAIN_KERNELS = {"fused_swin_block_attention",
                     "fused_swin_block_epilogue",
                     "fused_swin_block_epilogue_shifted",
                     "fused_patch_merge"}


def _stage1_port_step(mc, init, images, labels, make=None):
    """One port step of `build_model(mc)` (or of the model `make()`
    builds) from state `init`: (the model after it, its loss, its
    gradients by name, numpy)."""
    port = (make() if make is not None
            else build_model(mc, DataConfig(crop_hw=HW), device="cpu")[0])
    assert port.kernels is None
    port.load_state_dict(init)
    cfg = SegTrainConfig(model=mc)
    opt, schedule = make_tx(cfg, 10, port)
    step = train_seg.make_seg_train_step(port, opt, schedule, "ohem")
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in port.named_parameters()}))
    metrics = train_steps(step, [{"image": images, "label": labels}], 1,
                          torch.device("cpu"))
    return port, metrics[0]["loss"], grads


def test_fp32_stage1_step_matches_jax_tpu_routing(jax_tpu_interpreted):
    """One stage-1 step of `build_model(ModelConfig(dtype="float32"))`
    (`kernels=None`: on the CPU the Functions of K1/K5, K2/K6 and K3 with
    their twins) against the JAX fp32 `make_seg_train_step` on the TPU
    routing, K1, both K2s and K3 interpreted, on the same weights and
    batch: the loss, every gradient, the new BatchNorm statistics and the
    parameters after one Adam step, to the bounds of
    tests/test_torch_train.py; each gradient's bound also adds
    NOISE_FACTOR times the port's own spread on clips perturbed by 1e-7
    (as tests/test_torch_contrast.py does): at swin_dim 128 the step is
    rounding-sensitive enough that XLA's thread count alone moves a
    ResNet gradient by 1 % (flax's E[x^2] - E[x]^2 BatchNorm backward)."""
    check_fp32_stage1_step(
        jax_tpu_interpreted, ModelConfig(num_classes=NC, dtype="float32",
                                         **MODEL),
        JTswinPlus(num_classes=NC, **MODEL), JAX_TRAIN_KERNELS)


def check_fp32_stage1_step(jax_calls, mc, jm, jax_kernels, make=None):
    """One stage-1 step of the fp32 port model (`build_model(mc)`, or
    `make()`) against the JAX fp32 `make_seg_train_step` of `jm`, both from
    the port's seeded weights, on the same batch; `jax_calls` the JAX
    kernels the fixture records, which must be `jax_kernels`. The bounds
    of `test_fp32_stage1_step_matches_jax_tpu_routing`."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B2, 4, *HW, 3)).astype(np.float32)
    labels = rng.integers(-1, NC, (B2, *HW)).astype(np.int32)
    seeded = (make() if make is not None
              else build_model(mc, DataConfig(crop_hw=HW), device="cpu")[0])
    init = init_weights(seeded, torch.Generator().manual_seed(0)).state_dict()
    variables = _jax_variables(seeded)
    tx = _recording(joptim.make_adam(3e-4))
    jstate = jtrain.SegTrainState.create(variables, tx)
    jstep = jtrain.make_seg_train_step(jm, tx, loss_type="ohem")
    jstate, jmetrics = jstep(jstate, jnp.asarray(images),
                             jnp.asarray(labels))
    assert set(jax_calls) == jax_kernels
    jgrads = jstate.opt_state[1]

    port, loss, grads = _stage1_port_step(mc, init, images, labels, make)
    noisy = (images * (1 + 1e-7 * np.random.default_rng(9).standard_normal(
        images.shape))).astype(np.float32)
    _, _, grads_n = _stage1_port_step(mc, init, noisy, labels, make)
    lr = SegTrainConfig(model=mc).lr
    assert loss == pytest.approx(float(jmetrics["loss"]), rel=LOSS_TOL)
    new_vars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    stable = total = 0
    for name, t in port.state_dict().items():
        coll, path = jax_path(name, t.dim())
        want = _leaf(new_vars[coll], path)
        got = to_jax_layout(name, t.numpy())
        if coll == "batch_stats":
            assert _rel(got, want) <= STATS_TOL, name
            continue
        pg, jg = to_jax_layout(name, grads[name]), _leaf(jgrads, path)
        assert (np.linalg.norm(pg - jg)
                <= GRAD_TOL * np.linalg.norm(jg) + GRAD_ATOL + NOISE_FACTOR
                * np.linalg.norm(grads[name] - grads_n[name])), name
        start = to_jax_layout(name, init[name].numpy())
        assert np.abs(got - start).max() <= 1.001 * lr, name
        sure = (np.sign(pg) == np.sign(jg)) & (
            np.minimum(np.abs(pg), np.abs(jg)) >= 1e-5)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=name)
        stable += sure.sum()
        total += sure.size
    assert stable >= total / 2


def test_fp32_stage2_step_matches_jax_tpu_routing(jax_tpu_interpreted):
    """One contrast step of `build_contrast_encoder` in fp32 (`kernels=
    None`) against the JAX fp32 `make_contrast_train_step` on the TPU
    routing (K1, both K2s and K3 interpreted) from the same query and key
    weights, batch and LARS schedule: the loss, every query gradient (to
    1e-2 plus 8x the port's own spread on clips perturbed by 1e-7, as
    tests/test_torch_contrast.py states), both branches' BatchNorm
    statistics and the parameters after the step."""
    rng = np.random.default_rng(1)
    cfg = ContrastTrainConfig(model=ModelConfig(dtype="float32", **MODEL),
                              data=DataConfig(crop_hw=HW, seed=0))
    query = _seeded_stats(build_contrast_encoder(cfg, NC, "cpu"), 3)
    blocks = [m for m in query.modules() if hasattr(m, "kernels")]
    assert blocks and all(m.kernels is None for m in blocks)
    key = _seeded_stats(build_contrast_encoder(
        ContrastTrainConfig(model=cfg.model, data=DataConfig(
            crop_hw=HW, seed=1)), NC, "cpu"), 4)
    clips = rng.standard_normal((B2, 6, 4, *HW, 3)).astype(np.float32)
    blocks = rng.integers(0, NC, (B2, 6, HW[0] // 16, HW[1] // 16))
    labels = np.repeat(np.repeat(blocks, 16, axis=2), 16,
                       axis=3).astype(np.int32)

    schedule = joptim.warmup_cosine_schedule(0.1, 10, TOTAL_STEPS)
    tx = _recording(joptim.make_lars(schedule))
    qvars, kvars = _jax_variables(query), _jax_variables(key)
    jstate = jtc.ContrastTrainState.create(qvars, tx).replace(
        params_k=kvars["params"], stats_k=kvars["batch_stats"])
    jstep = jtc.make_contrast_train_step(
        JContrastEncoder(num_classes=NC, **MODEL), tx, class_num=NC,
        total_steps=TOTAL_STEPS, ins_loss_weight=0.0,
        query_mode="unrolled")
    jstate, jmetrics = jstep(jstate, jnp.asarray(clips), jnp.asarray(labels))
    assert set(jax_tpu_interpreted) == JAX_TRAIN_KERNELS
    jgrads = jstate.opt_state[1]

    state, metrics, grads = _port_step(query, key, clips, labels, 0.0)
    noisy = (clips * (1 + 1e-7 * np.random.default_rng(9).standard_normal(
        clips.shape))).astype(np.float32)
    state_n, _, grads_n = _port_step(query, key, noisy, labels, 0.0)
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=C_LOSS_TOL)
    params_n = dict(state_n.query.named_parameters())
    over = {}
    for name, p in state.query.named_parameters():
        _, path = jax_path(name, p.dim())
        pg, jg = to_jax_layout(name, grads[name]), _leaf(jgrads, path)
        bound = (GRAD_TOL * np.linalg.norm(jg) + GRAD_ATOL + NOISE_FACTOR
                 * np.linalg.norm(grads[name] - grads_n[name]))
        if np.linalg.norm(pg - jg) > bound:
            over[name] = float(np.linalg.norm(pg - jg) / bound)
        spread = (p - params_n[name]).abs().max().item()
        np.testing.assert_allclose(
            to_jax_layout(name, p.detach().numpy()),
            _leaf(jstate.params_q, path), rtol=0,
            atol=PARAM_TOL + NOISE_FACTOR * spread, err_msg=name)
    assert over == {}
    for model, jstats in ((state.query, jstate.stats_q),
                          (state.key, jstate.stats_k)):
        for name, t in model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                _, path = jax_path(name, t.dim())
                assert _rel(t.numpy(), _leaf(jstats, path)) <= STATS_TOL, name


def test_model_trains_after_serving_under_inference_mode():
    """A model that served under `inference_mode` first (the SW masks are
    cached on first use) then trains: the Functions save those masks for
    their backward, so the cache must hold normal tensors, and every
    parameter gets a finite gradient."""
    model = init_weights(build_model(
        ModelConfig(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                    dtype="float32"), DataConfig(crop_hw=HW),
        device="cpu")[0], torch.Generator().manual_seed(0))
    clip = torch.randn((1, 4, *HW, 3), generator=torch.Generator()
                       .manual_seed(1))
    with torch.inference_mode():
        model.eval()(clip)
    masks = [t for m in model.modules()
             for t in getattr(m, "_masks", {}).values()]
    assert masks and not any(t.is_inference() for t in masks)
    model.train()(clip).float().square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters() if p.requires_grad)
