"""One data-parallel train step of each stage against the JAX step on the
global batch, on the CPU, fp32: two gloo ranks (`torch_parallel_ranks`),
each with half the batch, synced BatchNorms and a DDP wrap, against the
JAX package's jitted step over all of it.

Stage 1 (a small TswinPlus, `swin_dim` 64, depths (1, 1), 64x128, global
batch 4): OHEM at its threshold branch (thresh 0.7) and at its top-k
branch (0.02), CE, dice and BCE, and OHEM with `remat` (non-reentrant
checkpoints of the swin blocks under DDP). Stage 2 (a small `ContrastEncoder`,
global batch 4 of six views), with and without the instance branch.
Held: the loss, every gradient after DDP's reduce, the BatchNorm
statistics, the parameters after the optimizer, and both ranks'
parameters equal to the bit. The halves of the batch differ in their
valid and hard pixel counts, so that local and global differ; each
planted fault (BatchNorms on local statistics, OHEM selected and the loss
normalised per rank, one rank's gradient not reduced, the key pass's
BatchNorms unsynced) must break the bounds. A step whose model is not
wrapped refuses to run under a group of two.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import ContrastEncoder as JContrastEncoder  # noqa: E402
from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_contrast as jtc  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch.ckpt import jax_path, to_jax_layout  # noqa: E402
from stswincl_tpu_torch.models import ContrastEncoder, TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.train import optim  # noqa: E402
from stswincl_tpu_torch.train import train_contrast as tc  # noqa: E402
from tests import torch_parallel_ranks as ranks  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy
HW, NC, B = (64, 128), 5, 4
MODEL = dict(swin_dim=64, swin_depths=(1, 1), input_hw=HW)

# Stated bounds. Against the JAX step: those of the one-process steps
# (tests/test_torch_train.py, tests/test_torch_contrast.py), for the same
# reasons (fp32 sums in another order; flax's E[x^2] - E[x]^2 BatchNorm
# backward; Adam's sign-like step; the contrast step's rounding
# sensitivity, measured by the port's own step on clips scaled by
# 1 + 1e-7 noise). A stage-1 gradient may also be as far from JAX's as
# the port's one-process step on the same global batch is: on these
# colour-block frames flax's ill-conditioned BatchNorm backward puts the
# stem BatchNorm's scale 1.2e-2 from the port's, in one process as in
# two. Against that one-process step, with which the two ranks share
# every formula and differ only in the order of their sums: the loss
# within 1e-6 relative, each gradient within 1e-3 relative (1.5e-5
# measured) + 1e-6, each BatchNorm statistic within 1e-5.
LOSS_TOL, GRAD_TOL, GRAD_ATOL, STATS_TOL = 1e-5, 1e-2, 1e-6, 1e-4
ONE_LOSS_TOL, ONE_GRAD_TOL, ONE_STATS_TOL = 1e-6, 1e-3, 1e-5
C_LOSS_TOL, NOISE_FACTOR, EMA_TOL, PARAM_TOL = 1e-4, 8.0, 1e-6, 1e-4
TOTAL_STEPS = 100
SCHEDULE = (0.1, 10, TOTAL_STEPS)


def _jax_variables(model):
    tree = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        coll, path = jax_path(name, t.dim())
        node = tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.array(to_jax_layout(name, t.numpy()),
                                   copy=True)
    return tree


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _recording(tx):
    """`tx` that also keeps the last gradients in its state."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


def _seg_batch():
    """Blocky labels, one class per 16x16 block drawn in its own colour
    under noise; rank 0's half has half its blocks ignored (-1), rank 1's
    none, so the halves' valid and hard counts differ."""
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, NC, (B, HW[0] // 16, HW[1] // 16))
    blocks[:B // 2][rng.random((B // 2, *blocks.shape[1:])) < 0.5] = -1
    labels = np.repeat(np.repeat(blocks, 16, axis=1), 16, axis=2)
    palette = rng.uniform(-1.0, 1.0, (NC + 1, 3))
    images = palette[labels][:, None] + 0.3 * rng.standard_normal(
        (B, 4, *HW, 3))
    return images.astype(np.float32), labels.astype(np.int32)


# (loss, OHEM threshold, variant): None and "remat" (the swin blocks
# recomputed in the backward, under DDP) are sound; the rest are faults
SOUND = (None, "remat")
SEG_VARIANTS = [("ohem", 0.7, None), ("ohem", 0.02, None), ("ce", 0.7, None),
                ("dice", 0.7, None), ("bce", 0.7, None),
                ("ohem", 0.7, "remat"),
                ("ohem", 0.7, "bn_local"), ("ohem", 0.7, "loss_local"),
                ("ohem", 0.02, "loss_local"), ("ce", 0.7, "loss_local"),
                ("ohem", 0.7, "unreduced")]


def _one_process_seg_step(port, images, labels, loss_type, thresh):
    """The port's step on the whole batch in one process: loss, the
    gradients it steps on, the state after it."""
    import copy
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train import train_seg
    m = copy.deepcopy(port)
    opt, schedule = make_tx(SegTrainConfig(), 10, m)
    step = train_seg.make_seg_train_step(m, opt, schedule, loss_type,
                                         ohem_thresh=thresh)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in m.named_parameters()}))
    metrics = step(T_(images), T_(labels).long())
    return dict(loss=float(metrics["loss"]), grads=grads,
                state={k: v.numpy() for k, v in m.state_dict().items()})


@pytest.fixture(scope="module")
def seg_world():
    port = init_weights(TswinPlus(NC, **MODEL),
                        torch.Generator().manual_seed(0))
    images, labels = _seg_batch()
    spec = dict(num_classes=NC, model=MODEL, images=images, labels=labels,
                state={k: v.numpy() for k, v in port.state_dict().items()},
                variants=SEG_VARIANTS)
    outs = ranks.run_world(ranks.seg_steps, spec)
    refs = {}
    jm = JTswinPlus(num_classes=NC, swin_dim=64, swin_depths=(1, 1))
    for loss_type, thresh, _ in SEG_VARIANTS:
        if (loss_type, thresh) in refs:
            continue
        tx = _recording(joptim.make_adam(3e-4))
        jstate = jtrain.SegTrainState.create(_jax_variables(port), tx)
        jstep = jtrain.make_seg_train_step(jm, tx, loss_type=loss_type,
                                           ohem_thresh=thresh)
        jstate, jmet = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        one = _one_process_seg_step(port, images, labels, loss_type, thresh)
        refs[(loss_type, thresh)] = (jstate, jmet, one)
    return port, outs, refs


def _seg_violations(port, got, jstate, jmet, one):
    """The stated bounds that `got` (one rank's step) breaks against the
    JAX step and the one-process step `one`, by name."""
    bad = []
    jloss = float(jmet["loss"])
    if abs(got["loss"] - jloss) > LOSS_TOL * abs(jloss):
        bad.append("loss")
    if abs(got["loss"] - one["loss"]) > ONE_LOSS_TOL * abs(one["loss"]):
        bad.append("loss (one process)")
    new = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    start = port.state_dict()
    stable = total = 0
    for name, t in got["state"].items():
        coll, path = jax_path(name, t.ndim)
        want = _leaf(new[coll], path)
        val = to_jax_layout(name, t)
        if coll == "batch_stats":
            if _rel(val, want) > STATS_TOL:
                bad.append(name)
            if _rel(t, one["state"][name]) > ONE_STATS_TOL:
                bad.append(f"{name} (one process)")
            continue
        g, g1 = got["grads"][name], one["grads"][name]
        pg, p1 = to_jax_layout(name, g), to_jax_layout(name, g1)
        jg = _leaf(jstate.opt_state[1], path)
        if np.linalg.norm(pg - jg) > (GRAD_TOL * np.linalg.norm(jg)
                                      + GRAD_ATOL + np.linalg.norm(p1 - jg)):
            bad.append(f"grad {name}")
        if np.linalg.norm(g - g1) > (ONE_GRAD_TOL * np.linalg.norm(g1)
                                     + GRAD_ATOL):
            bad.append(f"grad {name} (one process)")
        s = to_jax_layout(name, start[name].numpy())
        sure = (np.sign(pg) == np.sign(jg)) & (
            np.minimum(np.abs(pg), np.abs(jg)) >= 1e-5)
        if np.abs(val - s).max() > 1.001 * 3e-4 or not np.allclose(
                val[sure], want[sure], rtol=0, atol=1e-6):
            bad.append(f"param {name}")
        stable += sure.sum()
        total += sure.size
    if stable < total / 2:
        bad.append("stable share")
    return bad


@pytest.mark.parametrize("variant",
                         [v for v in SEG_VARIANTS if v[2] in SOUND],
                         ids=lambda v: "-".join(map(str, v[:2] + v[2:] *
                                                    bool(v[2]))))
def test_stage1_step_over_two_ranks_matches_jax(seg_world, variant):
    port, outs, refs = seg_world
    for r, out in enumerate(outs):
        assert _seg_violations(port, out[variant], *refs[variant[:2]]) == [], r
        assert out[variant]["parted"] == 0.0
    assert outs[0][variant]["loss"] == outs[1][variant]["loss"]


@pytest.mark.parametrize("variant",
                         [v for v in SEG_VARIANTS if v[2] not in SOUND],
                         ids=lambda v: f"{v[2]}-{v[0]}-{v[1]}")
def test_stage1_planted_faults_break_the_bounds(seg_world, variant):
    port, outs, refs = seg_world
    broken = [_seg_violations(port, out[variant], *refs[variant[:2]])
              for out in outs]
    if variant[2] == "unreduced":
        # rank 0 reduced; rank 1 stepped on its own gradient
        assert broken[0] == [] and broken[1] != []
        assert all(o[variant]["parted"] > 0 for o in outs)
    else:
        assert all(b != [] for b in broken)


def test_a_step_under_a_group_must_reduce(seg_world):
    """Step 0 (d): make_seg_train_step refuses an unwrapped model under a
    group of two; wrapped, the ranks' weights stay equal to the bit, and
    with one rank's gradient unreduced they part."""
    _, outs, _ = seg_world
    assert all(o["refused"] for o in outs)
    sound = [v for v in SEG_VARIANTS if v[2] in SOUND]
    assert all(o[v]["parted"] == 0.0 for o in outs for v in sound)
    assert outs[1][("ohem", 0.7, "unreduced")]["parted"] > 0.0


# ---- stage 2 -----------------------------------------------------------------

CONTRAST_VARIANTS = [(0.0, None), (0.5, None), (0.0, "key_local")]


def _encoder(with_instance, seed):
    m = ContrastEncoder(NC, with_instance=with_instance, **MODEL)
    init_weights(m, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 10)
    with torch.no_grad():  # running statistics away from (0, 1)
        for name, b in m.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(1.0 + torch.rand(b.shape, generator=g))
    return m


def _contrast_batch():
    """Six views of 4 frames; rank 0's labels hold a quarter of 255
    pixels, rank 1's none (the valid counts of the halves differ)."""
    rng = np.random.default_rng(5)
    clips = rng.standard_normal((B, 6, 4, *HW, 3)).astype(np.float32)
    blocks = rng.integers(0, NC, (B, 6, HW[0] // 16, HW[1] // 16))
    blocks[:B // 2][rng.random((B // 2, 6, *blocks.shape[2:])) < 0.25] = 255
    labels = np.repeat(np.repeat(blocks, 16, axis=2), 16, axis=3)
    return clips, labels.astype(np.int32)


def _one_process_grads(query, key, clips, labels, ins):
    """The port's one-process step on clips: its gradients (the noise
    term of the bound)."""
    import copy
    q, k = copy.deepcopy(query), copy.deepcopy(key)
    state = tc.ContrastTrainState(q, k, optim.make_lars(
        q.parameters(), optim.warmup_cosine_schedule(*SCHEDULE)))
    grads = {}
    state.opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in q.named_parameters()}))
    tc.make_contrast_train_step(state, NC, TOTAL_STEPS,
                                ins_loss_weight=ins)(T_(clips),
                                                     T_(labels).long())
    return grads, dict(q.named_parameters())


@pytest.fixture(scope="module")
def contrast_world():
    clips, labels = _contrast_batch()
    models = {w: (_encoder(w, 0), _encoder(w, 1)) for w in (False, True)}
    spec = dict(num_classes=NC, model=MODEL, clips=clips, labels=labels,
                schedule=SCHEDULE, variants=CONTRAST_VARIANTS,
                query={w: {k: v.numpy() for k, v in q.state_dict().items()}
                       for w, (q, _) in models.items()},
                key={w: {k: v.numpy() for k, v in kk.state_dict().items()}
                     for w, (_, kk) in models.items()})
    outs = ranks.run_world(ranks.contrast_steps, spec)
    refs = {}
    noisy = (clips * (1 + 1e-7 * np.random.default_rng(9).standard_normal(
        clips.shape))).astype(np.float32)
    for ins in (0.0, 0.5):
        query, key = models[ins > 0]
        qv, kv = _jax_variables(query), _jax_variables(key)
        tx = _recording(joptim.make_lars(joptim.warmup_cosine_schedule(
            *SCHEDULE)))
        jstate = jtc.ContrastTrainState.create(qv, tx).replace(
            params_k=kv["params"], stats_k=kv["batch_stats"])
        jstep = jtc.make_contrast_train_step(
            JContrastEncoder(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                             with_instance=ins > 0),
            tx, class_num=NC, total_steps=TOTAL_STEPS, ins_loss_weight=ins,
            query_mode="unrolled")
        jstate, jmet = jstep(jstate, jnp.asarray(clips), jnp.asarray(labels))
        g1, p1 = _one_process_grads(query, key, clips, labels, ins)
        gn, pn = _one_process_grads(query, key, noisy, labels, ins)
        spread = {n: (np.linalg.norm(g1[n] - gn[n]),
                      (p1[n] - pn[n]).abs().max().item()) for n in g1}
        refs[ins] = (jstate, jmet, spread)
    return models, outs, refs


def _contrast_violations(models, ins, got, jstate, jmet, spread):
    bad = []
    for k in ("loss",) + (("ins_loss",) if ins else ()):
        if abs(got["metrics"][k] - float(jmet[k])) > C_LOSS_TOL * abs(
                float(jmet[k])):
            bad.append(k)
    query, key = models[ins > 0]
    m = got["metrics"]["momentum"]
    for name, p in query.named_parameters():
        _, path = jax_path(name, p.dim())
        pg = to_jax_layout(name, got["grads"][name])
        jg = _leaf(jstate.opt_state[1], path)
        g_spread, p_spread = spread[name]
        if np.linalg.norm(pg - jg) > (GRAD_TOL * np.linalg.norm(jg)
                                      + GRAD_ATOL + NOISE_FACTOR * g_spread):
            bad.append(f"grad {name}")
        val = to_jax_layout(name, got["query"][name])
        if np.abs(val - _leaf(jstate.params_q, path)).max() > (
                PARAM_TOL + NOISE_FACTOR * p_spread):
            bad.append(f"param {name}")
    k0, q0 = key.state_dict(), query.state_dict()
    for name, p in key.named_parameters():
        want = (k0[name] * m + q0[name] * (1.0 - m)).numpy()
        if np.abs(got["key"][name] - want).max() > EMA_TOL:
            bad.append(f"ema {name}")
    for branch, jstats in (("query", jstate.stats_q), ("key", jstate.stats_k)):
        for name, t in got[branch].items():
            if name.endswith(("running_mean", "running_var")):
                _, path = jax_path(name, t.ndim)
                if _rel(t, _leaf(jstats, path)) > STATS_TOL:
                    bad.append(f"{branch} {name}")
    return bad


@pytest.mark.parametrize("variant", CONTRAST_VARIANTS,
                         ids=lambda v: f"ins{v[0]}-{v[1] or 'sound'}")
def test_stage2_step_over_two_ranks_matches_jax(contrast_world, variant):
    """The sound steps meet the bounds on both ranks with their
    parameters equal to the bit; the planted fault (the key pass's
    BatchNorms on local statistics) breaks them."""
    models, outs, refs = contrast_world
    ins, fault = variant
    broken = [_contrast_violations(models, ins, o[variant], *refs[ins])
              for o in outs]
    if fault:
        assert all(b != [] for b in broken)
        assert all(any(n.startswith("key ") for n in b) for b in broken)
    else:
        assert broken == [[], []]
        assert all(o[variant]["parted"] == 0.0 for o in outs)
        assert outs[0][variant]["metrics"] == outs[1][variant]["metrics"]
