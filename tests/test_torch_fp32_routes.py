"""The fp32 model on the routes off 'pallas_full', on the CPU, against the
JAX package: `build_model(dtype="float32")` with `attn_impl` 'pallas'
(Pallas row 10) and 'pallas_windows' (row 11), and an fp32
`TswinPlus(whole_block=True)` (row 16) served through
`StreamingSegmenter` against the JAX fp32 model and its
`StreamingSegmenter` routed as on the TPU (`STSWIN_WHOLE_BLOCK=1` for row
16), every Pallas kernel it reaches interpreted; and row 16's fp32 plan
(`whole_block_plan(..., torch.float32)`, the host side of
`csrc/fp32_whole_block.cu`) at both stages' shapes. On the CPU the port's
wrappers run their plain twins, the functions the card's fp32 forms are
held to (chip_smoke.py phase 7). The train steps of the 'pallas' and
`whole_block` routes are in test_torch_fp32_routes_train.py.

Tolerances, those of test_torch_fp32.py: head-resolution logits within
LOGIT_REL (1e-4, fp32 on both sides with the same GELU polynomial, other
summation orders), streamed predictions equal on >= PRED_SHARE (99.9 %)
of pixels."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.ops import pallas_attention as jpa  # noqa: E402
from stswincl_tpu.ops import pallas_block_attention as jpba  # noqa: E402
from stswincl_tpu.ops import pallas_swin_block as jwb  # noqa: E402
from stswincl_tpu.pipelines.streaming import (  # noqa: E402
    StreamingSegmenter as JStreamingSegmenter)
from stswincl_tpu_torch import kernels  # noqa: E402
from stswincl_tpu_torch.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.ops import swin_block as wb  # noqa: E402
from stswincl_tpu_torch.ops.attention import (  # noqa: E402
    _attn_f32_resident_bytes, _attn_f32_smem_bytes)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from stswincl_tpu_torch.pipelines.streaming import (  # noqa: E402
    StreamingSegmenter)
from test_torch_fp32 import (HW, LOGIT_REL, NC, OUT, PRED_SHARE,  # noqa: E402
                             _rel, jax_tpu_interpreted)  # noqa: F401
from test_torch_train import _jax_variables  # noqa: E402
from test_torch_whole_block_plan import SHAPES  # noqa: E402

torch.set_num_threads(1)

MODEL = dict(swin_dim=128, swin_depths=(1, 1))
# route -> (the port's and the JAX model's route arguments, the JAX
# kernels a served clip reaches: the route's attention kernel, the
# epilogues, the patch merge, the resize + argmax)
ROUTES = {
    "pallas": (dict(attn_impl="pallas"), {
        "windowed_attention_image", "fused_swin_block_epilogue",
        "fused_patch_merge", "upsample_argmax_pallas"}),
    "pallas_windows": (dict(attn_impl="pallas_windows"), {
        "fused_window_attention", "fused_swin_block_epilogue",
        "fused_patch_merge", "upsample_argmax_pallas"}),
    # row 16 takes the W-MSA blocks, K1 and the shifted K2 the SW-MSA
    # blocks
    "whole_block": (dict(whole_block=True), {
        "fused_whole_swin_block", "fused_swin_block_attention",
        "fused_swin_block_epilogue_shifted", "fused_patch_merge",
        "upsample_argmax_pallas"}),
}


@pytest.fixture
def jax_routes(jax_tpu_interpreted, monkeypatch):
    """`jax_tpu_interpreted` (the JAX package routed as on its TPU, K1-K4
    interpreted and recorded) plus rows 10, 11 and 16 interpreted and
    recorded in the same list, and `STSWIN_WHOLE_BLOCK=1` (it changes
    nothing off 'pallas_full'). Each custom VJP is kept: a train step
    differentiates them as the JAX package does."""
    import stswincl_tpu.models.swin as jswin

    calls = jax_tpu_interpreted
    monkeypatch.setenv("STSWIN_WHOLE_BLOCK", "1")
    wai = jpba.windowed_attention_image
    monkeypatch.setattr(
        jpba, "windowed_attention_image",
        lambda qkv, b, m, heads, scale, ws, interpret=False:
        calls.append("windowed_attention_image")
        or wai(qkv, b, m, heads, scale, ws, True))
    fwa = jpa.fused_window_attention
    monkeypatch.setattr(jpa, "fused_window_attention",
                        lambda *a: calls.append("fused_window_attention")
                        or fwa(*a))
    stwaf = jpa.space_time_window_attention_fused
    monkeypatch.setattr(jswin, "space_time_window_attention_fused",
                        lambda q, k, v, rb, m, scale, use_pallas=None:
                        stwaf(q, k, v, rb, m, scale, interpret=True))
    whole = jwb.fused_whole_swin_block
    # the model passes 15 tensors, heads, scale, ws, gelu_exact
    monkeypatch.setattr(jwb, "fused_whole_swin_block",
                        lambda *a: calls.append("fused_whole_swin_block")
                        or whole(*a[:19], 1e-5, True))
    return calls


def fp32_route_model(route):
    """The port's fp32 model on `route`, seeded: `build_model` for the
    `attn_impl` routes, `TswinPlus(whole_block=True)` (which `build_model`
    does not configure) for row 16; `kernels=None` on every route."""
    kw = ROUTES[route][0]
    if route == "whole_block":
        model = TswinPlus(NC, dtype=torch.float32, input_hw=HW, **kw,
                          **MODEL)
    else:
        model, _ = build_model(ModelConfig(num_classes=NC, dtype="float32",
                                           **kw, **MODEL),
                               DataConfig(crop_hw=HW), device="cpu")
    assert model.kernels is None
    return init_weights(model, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fp32_route_serves_as_jax_tpu_routing(jax_routes, route):
    """The port's fp32 model on `route` served through
    `StreamingSegmenter` against the JAX fp32 model on the same route and
    weights (the port's, through the reverse name map) and its
    `StreamingSegmenter`, routed as on the TPU: the head-resolution
    logits of each clip within LOGIT_REL, the streamed predictions equal
    on at least PRED_SHARE of pixels, and the JAX kernels of the route
    reached (row 10, row 11 or row 16 among them). The BatchNorm
    statistics are drawn away from (0, 1) and the class bias set to minus
    each class's mean logit on the first clip, so that the predictions
    spread over the classes."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((1, 6, *HW, 3)).astype(np.float32)
    port = fp32_route_model(route)
    for name, t in port.state_dict().items():
        if name.endswith("running_mean"):
            t.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, t.shape)))
        elif name.endswith("running_var"):
            t.copy_(torch.from_numpy(rng.uniform(0.7, 1.3, t.shape)))
    port.eval()
    with torch.no_grad():
        lcf0 = port(torch.from_numpy(frames[:, :4]), head_res_logits=True)
        port.classifier.conv2.bias -= lcf0.mean(dim=(0, 2, 3))
    variables = _jax_variables(port)
    # row 16 is the JAX package's STSWIN_WHOLE_BLOCK=1 on 'auto'
    jm = JTswinPlus(num_classes=NC, **{
        k: v for k, v in ROUTES[route][0].items() if k == "attn_impl"},
        **MODEL)
    jlogits = jax.jit(functools.partial(jm.apply, train=False,
                                        head_res_logits=True))

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
    for k, (p, jp) in enumerate(zip(preds, jpreds)):
        clip = frames[:, k:k + 4]
        with torch.inference_mode():
            lcf = port(torch.from_numpy(clip), head_res_logits=True)
        lcf_j = np.asarray(jlogits(variables, jnp.asarray(clip)))
        assert _rel(lcf.numpy(), lcf_j) <= LOGIT_REL, k
        assert p.shape == (1, *OUT) and p.dtype == torch.int32
        share = (p.numpy() == np.asarray(jp)).mean()
        assert share >= PRED_SHARE, (k, share)
        # no class takes more than 60 % of the pixels
        assert np.bincount(p.numpy().ravel(), minlength=NC).max() \
            <= 0.6 * p.numel()
    assert set(jax_routes) == ROUTES[route][1]


# ---- row 16's fp32 plan ---------------------------------------------------

@pytest.mark.parametrize("case", ["s1_serve", "s2_serve", "s1_train",
                                  "s2_train", "s2_ragged"])
def test_whole_block_plan_fp32(case):
    """Row 16's fp32 plan at both stages' serving and training shapes and
    a ragged last tile: the bf16 plan's tiles and windows; every phase
    within SMEM_LIMIT, the product phases on the fp32 GEMM tile's ring
    (four stages of 128 x 32 fp32 A, Wt and Wt-lo k tiles, 1024-byte
    aligned: 197,632 bytes, under the attention pairs' at each shape here) and
    the attention phase as many pairs of the fp32 core at once as the 8
    warps (TN / 16 a pair) and shared memory hold (one of 198 KiB at
    stage 1, TN 128 x hd 128; two of 98 KiB at stage 2, TN 32 x hd 256;
    four of 50 KiB at TN 32 x hd 128); a workspace slot of fp32 wide and
    narrow buffers, twice the bf16 plan's bytes, and the same fp32 s."""
    B, T, H, W, C, hidden, heads, ws = SHAPES[case]
    f32 = wb.whole_block_plan(*SHAPES[case], torch.float32)
    bf = wb.whole_block_plan(*SHAPES[case])
    assert (f32.dtype, bf.dtype) == (torch.float32, torch.bfloat16)
    assert (f32.tiles, f32.windows_per_tile, f32.box, f32.wide) == (
        bf.tiles, bf.windows_per_tile, bf.box, bf.wide)
    assert all(f32.tile_boxes(t) == bf.tile_boxes(t)
               for t in range(f32.tiles))
    TN, hd = T * ws * ws, C // heads
    assert f32.attention_group == {512: 1, 1024: 2, 256: 4}[C]
    assert f32.attention_group <= 256 // (TN // 16 * 32)
    assert f32.pair_bytes == _attn_f32_smem_bytes(TN, hd)
    assert (f32.phase_smem["attention"]
            == f32.attention_group * f32.pair_bytes)
    assert all(f32.phase_smem[ph] == wb.F32_RING_BYTES == 197632
               for ph in wb.PHASES if ph != "attention")
    assert f32.smem_bytes == max(f32.attention_group * f32.pair_bytes,
                                 wb.F32_RING_BYTES)
    assert f32.smem_bytes <= kernels.SMEM_LIMIT
    assert f32.pair_bytes == {512: 202752, 1024: 99840, 256: 50688}[C]
    assert f32.slot_bytes == {"wide": 2 * bf.slot_bytes["wide"],
                              "narrow": 2 * bf.slot_bytes["narrow"],
                              "s": bf.slot_bytes["s"]}
    mib = sum(f32.slot_bytes.values()) / 2 ** 20
    assert mib == {512: 1.5, 1024: 3.0, 256: 0.75}[C]


@pytest.mark.parametrize("args,why", [
    ((1, 2, 16, 16, 96, 384, 8, 8), "head_dim % 8"),
    ((1, 2, 16, 16, 100, 400, 2, 8), "C and hidden multiples of 8"),
    ((1, 3, 16, 16, 512, 2048, 4, 8), "at most 176"),
    ((1, 2, 16, 16, 512, 2048, 3, 8), "C % heads"),
])
def test_whole_block_plan_fp32_refuses_with_a_message(args, why):
    """The fp32 form's envelope is the bf16 form's, K1's and K2's: it
    refuses a head dim off 8, C off 8, a window past 176 tokens and heads
    not dividing C, naming itself, as the bf16 plan does."""
    with pytest.raises(ValueError, match=f"whole_swin_block_f32: .*{why}"):
        wb.whole_block_plan(*args, torch.float32)
    with pytest.raises(ValueError, match=f"whole_swin_block: .*{why}"):
        wb.whole_block_plan(*args)


@pytest.mark.parametrize("args,was", [
    ((1, 2, 16, 16, 384, 1536, 24, 8), "head_dim % 32"),
    ((1, 2, 16, 16, 512, 2048, 2, 8), "does not fit shared memory"),
    ((1, 2, 16, 16, 1152, 4608, 8, 8), "C <= 1024"),
    ((1, 3, 8, 8, 512, 2048, 4, 4), "do not tile"),
])
def test_whole_block_plan_fp32_takes_what_it_refused(args, was):
    """What the first fp32 form refused (`was`) it takes, as the bf16
    form does: head dims of 16 (the core's P V off 32 columns), the fp32
    pair past shared memory (TN 128 x hd 256: 390 KiB, on the streamed
    pair), C past 1024 and windows of 48 tokens (through the row map, two
    a tile)."""
    f32 = wb.whole_block_plan(*args, torch.float32)
    bf = wb.whole_block_plan(*args)
    assert f32.smem_bytes <= kernels.SMEM_LIMIT
    assert (f32.tiles, f32.tile_rows, f32.slot_rows) == (
        bf.tiles, bf.tile_rows, bf.slot_rows)
    TN, hd = args[1] * args[7] ** 2, args[4] // args[6]
    assert f32.streamed == (_attn_f32_resident_bytes(TN, hd)
                            > kernels.SMEM_LIMIT)
    assert f32.streamed == (was == "does not fit shared memory")
