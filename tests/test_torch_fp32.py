"""The fp32 route of the port, on the CPU: `build_model` builds an fp32
model on the kernels (`kernels=None`) on every route; an fp32 forward on
the card that records no graph launches the fp32 forms of K1-K3 and of
rows 10, 11 and 16 directly and one that records a graph goes through
their autograd Functions, which call those forms (shown on meta tensors,
which take the card's branches of the wrappers without a card: K1-K3's
forms are monkeypatched, rows 10, 11 and 16 reach `kernels.launch`, which
is; the backward half is in test_torch_fp32_train.py); rows 12-15 and 17
launch their fp32 C entries with the call's sizes (and refuse, naming the
form, what their fp32 forms do not take); the fp32 attention core's
shared-memory plan; and the fp32 slice as a whole:
`build_model(dtype="float32")` through `StreamingSegmenter` against the
JAX fp32 model routed as on the TPU, its Pallas kernels interpreted (the
routes off 'pallas_full' in test_torch_fp32_routes.py)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import traverse_util  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.pipelines.streaming import (  # noqa: E402
    StreamingSegmenter as JStreamingSegmenter)
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.ckpt import load_from_jax  # noqa: E402
from stswincl_tpu_torch.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu_torch.ops import (add_layernorm, add_ln_mlp,  # noqa: E402
                                    attention, block_attention, conv,
                                    layernorm, mlp, patch_merge, swin_block)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from stswincl_tpu_torch.pipelines.streaming import (  # noqa: E402
    StreamingSegmenter)

torch.set_num_threads(1)


@pytest.mark.parametrize("attn_impl,want", [
    ("auto", None), ("pallas_full", None), ("einsum", None),
    ("pallas", None), ("pallas_windows", None)])
@pytest.mark.parametrize("arch", ["swinPlus", "puredeeplab18"])
def test_build_model_fp32_route_by_attn_impl(attn_impl, want, arch):
    """fp32 runs the kernels (None) on every route, as bf16 does: each
    route's attention kernel (K1, Pallas row 10 or 11) has an fp32
    form."""
    mc = ModelConfig(arch=arch, swin_dim=64, swin_depths=(1, 1),
                     dtype="float32", attn_impl=attn_impl)
    model, _ = build_model(mc, DataConfig(crop_hw=(64, 96)), device="cpu")
    blocks = [m for m in model.modules() if hasattr(m, "kernels")]
    assert blocks and all(m.kernels is want for m in blocks)


def _meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype,
                       requires_grad=grad)


# one head of 64: a window the fp32 attention backward takes, which the
# Function checks before its forward
B, T, H, W, C, HEADS, WS = 1, 2, 8, 8, 64, 1, 4


def _k1(grad):
    TN = T * WS * WS
    return ((_meta(B, T, H, W, C), _meta(3 * C, C, grad=grad),
             _meta(3 * C), _meta(C, C), _meta(C), _meta(HEADS, TN, TN),
             None, HEADS, 0.125, WS), dict(shift=WS // 2))


def _k2(grad, shift):
    v = _meta
    return ((_meta(B, T, H, W, C), _meta(B, T, H, W, C), v(C), v(C),
             _meta(4 * C, C, grad=grad), v(4 * C), _meta(C, 4 * C), v(C),
             v(C), v(C)), dict(shift=shift, ws=WS))


def _k3(grad):
    return ((_meta(4, H, W, C), _meta(4 * C), _meta(4 * C),
             _meta(2 * C, 4 * C, grad=grad)), {})


def _outs(*shapes):
    out = tuple(torch.empty(s, device="meta") for s in shapes)
    return out if len(out) > 1 else out[0]


# the fp32 form each Function's forward calls, and its meta outputs
TRAIN_FORMS = {
    "K1": ("_forward_f32", lambda x, *a, **k: _outs(
        x.shape, (x.numel() // C, 3 * C), (x.numel() // C, C))),
    "K2": ("swin_block_epilogue_f32", lambda x, *a, m_out=False, **k: _outs(
        *[x.shape] * (2 if m_out else 1))),
    "K3": ("patch_merge_f32", lambda x, *a, **k: _outs(
        (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, 2 * x.shape[3]))),
}

CASES = {
    "K1": (block_attention, "swin_block_attention",
           "swin_block_attention_f32", _k1),
    "K2": (add_ln_mlp, "swin_block_epilogue", "swin_block_epilogue_f32",
           lambda g: _k2(g, 0)),
    "K2 shifted": (add_ln_mlp, "swin_block_epilogue",
                   "swin_block_epilogue_f32", lambda g: _k2(g, WS // 2)),
    "K3": (patch_merge, "patch_merge", "patch_merge_f32", _k3),
}


# rows 10, 11 and 16: (wrapper, the C entry of its fp32 form, its
# arguments as make(grad) -> (args, kwargs)); one head of 64, a window of
# 32 tokens (T 2, ws 4), which K5's fp32 form takes (row 16's backward)
TN_ = T * WS * WS


def _row10(grad):
    return ((_meta(B, T, H, W, 3 * C, grad=grad), _meta(HEADS, TN_, TN_),
             _meta(4, TN_, TN_), HEADS, 0.125, WS), {})


def _row11(grad):
    q = _meta(8, HEADS, TN_, C, grad=grad)
    return ((q, _meta(8, HEADS, TN_, C), _meta(8, HEADS, TN_, C),
             _meta(HEADS, TN_, TN_), _meta(4, TN_, TN_), 0.125), {})


def _row16(grad):
    c, heads = 128, 2  # the whole block takes C % 128
    v = _meta
    return ((_meta(B, T, H, W, c), _meta(3 * c, c, grad=grad), v(3 * c),
             v(c, c), v(c), v(heads, TN_, TN_), None, v(c), v(c),
             v(4 * c, c), v(4 * c), v(c, 4 * c), v(c), v(c), v(c), heads,
             0.125, WS), {})


LAUNCHED = {
    "row 10": (block_attention.windowed_attention_image,
               "stswin_window_attention_image_f32", _row10,
               "WindowedAttentionImageFn"),
    "row 11": (attention.fused_window_attention,
               "stswin_window_attention_heads_f32", _row11,
               "FusedWindowAttentionFn"),
    "row 16": (swin_block.whole_swin_block, "stswin_whole_block_f32",
               _row16, "WholeBlockFn"),
}


def _launch_on_meta(monkeypatch):
    """Let meta tensors take the card's branch down to `kernels.launch`:
    they report `is_cuda`, the launch and the library's queries are
    recorded or answered here, and `require_bf16` fails the test if a
    wrapper asks for it. Returns the list of launched C entries."""
    entries = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: entries.append(name))
    monkeypatch.setattr(kernels, "use_device", lambda dev: 0)

    def no_bf16(name, row, *t):
        raise AssertionError(f"{name} asked for bf16 ({row})")
    monkeypatch.setattr(kernels, "require_bf16", no_bf16)
    monkeypatch.setattr(swin_block, "_slots", lambda *a: 132)

    def f32_layout(TN, hd, dtype):
        """`stswin_whole_block_f32_layout`'s answer: as many attention
        pairs as the 8 warps (TN / 16 a pair) and shared memory hold, in
        a region that also holds the product phases' ring (the fp32 GEMM
        tile's four stages, `F32_RING_BYTES`)."""
        pair = attention._attn_f32_smem_bytes(TN, hd)
        group = min(256 // (TN * 2), kernels.SMEM_LIMIT // pair)
        return group, max(swin_block.F32_RING_BYTES, group * pair)
    monkeypatch.setattr(swin_block, "_layout", f32_layout)
    return entries


@pytest.mark.parametrize("case", sorted(CASES) + sorted(LAUNCHED))
def test_fp32_wrappers_route_by_graph(monkeypatch, case):
    """On fp32 tensors off the CPU, the wrapper launches the fp32 form when
    no graph is recorded (no grad asked for, `no_grad`,
    `inference_mode`) and goes through its autograd Function when one is:
    the output then carries the Function's graph, whose forward called the
    fp32 form (K1's with its window-order scratch) once, and no twin.
    Rows 10, 11 and 16 reach their `_f32` C entry and never
    `require_bf16`."""
    if case in LAUNCHED:
        fn, entry, make, function = LAUNCHED[case]
        entries = _launch_on_meta(monkeypatch)
        for ctx, grad in ((torch.enable_grad, False), (torch.no_grad, True),
                          (torch.inference_mode, True)):
            args, kw = make(grad)
            with ctx():
                out = fn(*args, **kw)
            assert out.device.type == "meta" and out.grad_fn is None
        args, kw = make(True)
        out = fn(*args, **kw)
        assert out.device.type == "meta"
        assert type(out.grad_fn).__name__ == function + "Backward"
        assert entries == [entry] * 4
        return
    mod, wrapper, form, make = CASES[case]
    calls = []
    monkeypatch.setattr(mod, form, lambda *a, **k: calls.append(a) or "f32")
    fn = getattr(mod, wrapper)
    for ctx, grad in ((torch.enable_grad, False), (torch.no_grad, True),
                      (torch.inference_mode, True)):
        args, kw = make(grad)
        with ctx():
            assert fn(*args, **kw) == "f32"
    assert len(calls) == 3
    attr, fake = TRAIN_FORMS[case.split()[0]]
    monkeypatch.setattr(mod, attr, lambda *a, **k: calls.append(a)
                        or fake(*a, **k))
    args, kw = make(True)
    out = fn(*args, **kw)
    assert out.device.type == "meta"
    assert type(out.grad_fn).__name__.endswith("FnBackward")
    assert len(calls) == 4


def _mlp_args(C, hidden):
    return (_meta(64, C), _meta(hidden, C), _meta(hidden), _meta(C, hidden),
            _meta(C))


OFF_PATH = {  # the rows on no model path: (the call on fp32 tensors, its
    # fp32 C entry and the sizes it is handed; a call outside the fp32
    # form's envelope and the message that names the form)
    "row 12": (lambda: mlp.fused_mlp(*_mlp_args(128, 512)),
               "stswin_mlp_f32", (64, 128, 512, 1),
               lambda: mlp.fused_mlp(*_mlp_args(66, 264)),
               "fused_mlp_f32: needs C and hidden multiples of 4"),
    "row 13": (lambda: add_ln_mlp.add_ln_mlp(
        _meta(64, 128), _meta(64, 128), _meta(128), _meta(128),
        *_mlp_args(128, 512)[1:], gelu_exact=False),
               "stswin_add_ln_mlp_f32", (64, 128, 512, 2, 1e-5),
               lambda: add_ln_mlp.add_ln_mlp(
                   _meta(64, 66), _meta(64, 66), _meta(66), _meta(66),
                   *_mlp_args(66, 264)[1:]),
               "add_ln_mlp_f32: needs C and hidden multiples of 4"),
    "row 14": (lambda: add_layernorm.add_layer_norm(
        _meta(64, 100), _meta(64, 100), _meta(100), _meta(100)),
               "stswin_add_layer_norm_f32", (64, 100, 1e-5),
               lambda: add_layernorm.add_layer_norm(
                   _meta(64, 100), _meta(64, 100), _meta(96), _meta(96)),
               "add_layer_norm_f32: x"),
    "row 15": (lambda: layernorm.fused_layer_norm(_meta(3, 7, 3072),
                                                  _meta(3072), _meta(3072)),
               "stswin_layer_norm_f32", (21, 3072, 1e-5),
               lambda: layernorm.fused_layer_norm(_meta(64, 100), _meta(96),
                                                  _meta(96)),
               "fused_layer_norm_f32: x"),
    "row 17": (lambda: conv.conv3x3_bn_act(
        _meta(2, 8, 12, 64), _meta(96, 64, 3, 3), _meta(96), _meta(96),
        dilation=4, relu=False, residual=_meta(2, 8, 12, 96)),
               "stswin_conv3x3_bn_act_f32", (2, 8, 12, 64, 96, 4, 0),
               lambda: conv.conv3x3_bn_act(
                   _meta(1, 8, 8, 48), _meta(64, 48, 3, 3), _meta(64),
                   _meta(64)),
               "conv3x3_bn_act_f32: .* Cin a multiple of 32"),
}


@pytest.mark.parametrize("row", sorted(OFF_PATH))
def test_fp32_offpath_rows_refuse_by_name(monkeypatch, row):
    """Rows 12-15 and 17 on fp32 tensors off the CPU launch their fp32
    form: the fp32 C entry, handed the call's sizes (rows, C, hidden and
    the GELU; rows, C and eps; N, H, W, Cin, Cout, the dilation and the
    ReLU), and no bf16 entry, `require_bf16` never asked; a call outside
    the fp32 form's envelope is refused naming the form, before any
    launch."""
    launched = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True),
                        raising=False)
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: launched.append((name, a)))
    monkeypatch.setattr(kernels, "use_device", lambda dev: 0)

    def no_bf16(name, form_of, *t):
        raise AssertionError(f"{name} asked for bf16 ({form_of})")
    monkeypatch.setattr(kernels, "require_bf16", no_bf16)
    call, entry, sizes, refused, message = OFF_PATH[row]
    out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.device.type == "meta" and o.dtype == torch.float32
               for o in outs)
    assert [name for name, _ in launched] == [entry]
    assert launched[0][1][-len(sizes):] == pytest.approx(sizes)
    launched.clear()
    with pytest.raises(ValueError, match=message):
        refused()
    assert launched == []


def test_fp32_attention_shared_memory_plan():
    """The fp32 core holds q, k and v of a (window, head) in fp32 rows of
    hd + 4, 4 mod 32 words for every admitted head dim (its tensor-core
    fragment reads fall on distinct banks): stage 1 (TN 128, hd 128) and
    stage 2 (TN 32, hd 256) fit one block, and so do (144, 128) and (176,
    64). Every other window the bf16 core takes streams through a ring of
    three chunks of TN rows of 72 floats ((160, 128), (128, 256), (176,
    128), (32, 1200), and past the bf16 core's resident pair (128, 296),
    (176, 216), (128, 2048)); a window the bf16 core refuses (TN 192, a
    head dim off 8) is refused before any launch."""
    plan = attention._attn_f32_smem_bytes
    assert plan(128, 128) == 3 * 128 * 132 * 4 <= kernels.SMEM_LIMIT
    assert plan(32, 256) == 3 * 32 * 260 * 4 <= kernels.SMEM_LIMIT
    assert plan(128, 128) > attention._attn_smem_bytes(128, 128)
    dev = torch.device("cpu")
    for TN, hd in ((128, 128), (32, 256), (144, 128), (64, 256)):
        bias = torch.zeros((2, TN, TN))
        attention.check_attention_core("f32", dev, bias, None, 2, TN, hd,
                                       plan)
    for TN, hd in ((160, 128), (128, 256), (176, 128), (32, 1200)):
        assert plan(TN, hd) == 3 * TN * 72 * 4 <= kernels.SMEM_LIMIT
        bias = torch.zeros((2, TN, TN))
        attention.check_attention_core("f32", dev, bias, None, 2, TN, hd,
                                       plan)
    for TN, hd in ((128, 296), (176, 216), (128, 2048)):
        assert plan(TN, hd) == 3 * TN * 72 * 4
        bias = torch.zeros((2, TN, TN))
        attention.check_attention_core("f32", dev, bias, None, 2, TN, hd,
                                       plan)
    for TN, hd in ((192, 64), (128, 12)):
        bias = torch.zeros((2, TN, TN))
        with pytest.raises(ValueError, match="tokens|head_dim"):
            attention.check_attention_core("f32", dev, bias, None, 2, TN, hd,
                                           plan)
    # TN 176, hd 64: within the window envelope and the plan
    attention.check_attention_core("f32", dev, torch.zeros((2, 176, 176)),
                                   None, 2, 176, 64, plan)


# The slice: swin_dim 128 with 16x16 / 8x8 feature maps, so that the JAX
# patch merge takes its Pallas kernel ((W / 2) % 8 == 0, C % 128 == 0) and
# every SW block shifts; one paired layer a stage.
HW, OUT, NC = (128, 128), (256, 256), 5
# Logits, ||port - jax|| / ||jax||: both fp32 with the same GELU
# polynomial, the JAX kernels interpreted, the same arithmetic in other
# summation orders (the stack's own bound in test_torch_swin.py).
LOGIT_REL = 1e-4
# Predictions: pixels whose top two classes lie within that rounding may
# flip; at least this share must agree.
PRED_SHARE = 0.999


@pytest.fixture
def jax_tpu_interpreted(monkeypatch):
    """The JAX package routed as on its TPU, every Pallas kernel it then
    reaches interpreted on the CPU: K1 (attention with the shift inside),
    K2 (both epilogues), K3 (the patch merge) and K4 (the resize +
    argmax), in serving and in a train step (whose custom VJPs, given
    `interpret`, differentiate the XLA references)."""
    import stswincl_tpu.ops.pallas_add_ln_mlp as palm
    import stswincl_tpu.ops.pallas_attention as pa
    import stswincl_tpu.ops.pallas_block_attention as pba
    import stswincl_tpu.ops.pallas_patch_merge as ppm
    import stswincl_tpu.ops.pallas_upsample_argmax as pua

    monkeypatch.setattr(pa, "_is_tpu_backend", lambda: True)
    attn = pba.fused_swin_block_attention
    monkeypatch.setattr(pba, "fused_swin_block_attention",
                        lambda *a, **kw: attn(*a[:11], True))
    epi = palm.fused_swin_block_epilogue
    monkeypatch.setattr(palm, "fused_swin_block_epilogue",
                        lambda *a, **kw: epi(*a[:11], 1e-5, True))
    epis = palm.fused_swin_block_epilogue_shifted
    monkeypatch.setattr(palm, "fused_swin_block_epilogue_shifted",
                        lambda *a, **kw: epis(*a[:13], 1e-5, True))
    merge = ppm.fused_patch_merge
    # the custom VJPs' forward rules (a train step) pass `interpret` too
    monkeypatch.setattr(ppm, "fused_patch_merge",
                        lambda x, s, b, w, eps=1e-5, interpret=False:
                        merge(x, s, b, w, eps, True))
    up = pua.upsample_argmax_pallas
    monkeypatch.setattr(pua, "upsample_argmax_pallas",
                        lambda x, mh, mw, interpret=False, exact=False:
                        up(x, mh, mw, True, exact))
    calls = []
    for mod, name in ((pba, "fused_swin_block_attention"),
                      (palm, "fused_swin_block_epilogue"),
                      (palm, "fused_swin_block_epilogue_shifted"),
                      (ppm, "fused_patch_merge"),
                      (pua, "upsample_argmax_pallas")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(
            lambda *a, _inner, _name, **kw: calls.append(_name)
            or _inner(*a, **kw), _inner=inner, _name=name))
    return calls


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_fp32_slice_matches_jax_tpu_routing(jax_tpu_interpreted):
    """`build_model(ModelConfig(dtype="float32"))` (kernels=None) served
    through `StreamingSegmenter` against the JAX fp32 model and its
    `StreamingSegmenter` on the TPU routing: the head-resolution logits of
    each clip within LOGIT_REL, the streamed predictions equal on at least
    PRED_SHARE of pixels, and every JAX kernel of the route reached."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((1, 6, *HW, 3)).astype(np.float32)
    jm = JTswinPlus(num_classes=NC, swin_dim=128, swin_depths=(1, 1))
    variables = jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), jnp.asarray(frames[:, :4]))
    flat = traverse_util.flatten_dict(variables["batch_stats"])
    for k, v in flat.items():
        lo, hi = (-0.2, 0.2) if k[-1] == "mean" else (0.7, 1.3)
        flat[k] = jnp.asarray(rng.uniform(lo, hi, v.shape).astype(np.float32))
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(flat)}
    jlogits = jax.jit(functools.partial(jm.apply, train=False,
                                        head_res_logits=True))
    # the class bias set to minus each class's mean logit on the first
    # clip, so that the predictions spread over the classes
    lcf0 = np.asarray(jlogits(variables, jnp.asarray(frames[:, :4])))
    params = traverse_util.flatten_dict(variables["params"])
    bias = ("classifier", "conv2", "bias")
    params[bias] = params[bias] - jnp.asarray(lcf0.mean(axis=(0, 2, 3)))
    variables = {"params": traverse_util.unflatten_dict(params),
                 "batch_stats": variables["batch_stats"]}

    port, classes = build_model(
        ModelConfig(num_classes=NC, swin_dim=128, swin_depths=(1, 1),
                    dtype="float32"), DataConfig(crop_hw=HW), device="cpu")
    assert classes == NC and port.kernels is None
    load_from_jax(port, variables)
    port.eval()
    seg = StreamingSegmenter(port, out_hw=OUT)
    jseg = JStreamingSegmenter(jm, variables, out_hw=OUT)
    assert seg.exact
    cache, pred = seg.init_and_predict(torch.from_numpy(frames[:, :4]))
    jcache, jpred = jseg.init_and_predict(jnp.asarray(frames[:, :4]))
    preds, jpreds = [pred], [jpred]
    for i in (4, 5):
        cache, pred = seg.predict_next(cache, torch.from_numpy(frames[:, i]))
        jcache, jpred = jseg.predict_next(jcache, jnp.asarray(frames[:, i]))
        preds.append(pred)
        jpreds.append(jpred)
    assert set(jax_tpu_interpreted) == {
        "fused_swin_block_attention", "fused_swin_block_epilogue",
        "fused_swin_block_epilogue_shifted", "fused_patch_merge",
        "upsample_argmax_pallas"}

    for k, (p, jp) in enumerate(zip(preds, jpreds)):
        clip = frames[:, k:k + 4]
        with torch.inference_mode():
            lcf = port(torch.from_numpy(clip), head_res_logits=True)
        lcf_j = np.asarray(jlogits(variables, jnp.asarray(clip)))
        assert _rel(lcf.numpy(), lcf_j) <= LOGIT_REL
        assert p.shape == (1, *OUT) and p.dtype == torch.int32
        share = (p.numpy() == np.asarray(jp)).mean()
        assert share >= PRED_SHARE, (k, share)
        # no class takes more than 60 % of the pixels
        assert np.bincount(p.numpy().ravel(), minlength=NC).max() \
            <= 0.6 * p.numel()
