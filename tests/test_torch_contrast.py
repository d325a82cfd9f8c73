"""The stage-2 (inter-video contrastive) slice of the port against the JAX
package on the CPU, fp32: the class-sum loss, the EMA momentum, LARS and
its LR scaling, the nearest label resize, `ContrastEncoder` (its
parameter tree and forward), the sequential key pass, and one whole
contrast step (loss, gradients, the EMA, both branches' BatchNorm
statistics, the parameters after LARS) against `make_contrast_train_step`
with its plain joint backward (`query_mode="unrolled"`, whose gradients
are bitwise those of the default remat form), with and without the
instance branch. The JAX variables are built from the port's seeded
weights through `ckpt.jax_path` / `to_jax_layout`."""

import copy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.models import ContrastEncoder as JContrastEncoder  # noqa: E402
from stswincl_tpu.ops import contrastive as jcontrastive  # noqa: E402
from stswincl_tpu.ops.resize import resize_nearest as jresize_nearest  # noqa: E402
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_contrast as jtc  # noqa: E402
from stswincl_tpu_torch.ckpt import (jax_path, load_from_jax,  # noqa: E402
                                     state_dict_from_jax, to_jax_layout)
from stswincl_tpu_torch.models import ContrastEncoder  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.ops import contrastive  # noqa: E402
from stswincl_tpu_torch.ops.resize import resize_nearest  # noqa: E402
from stswincl_tpu_torch.train import optim  # noqa: E402
from stswincl_tpu_torch.train import train_contrast as tc  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

# 128x128 input: 16x16 at stage 1 keeps the shift, 8x8 at stage 2 too
HW, NC, B = (128, 128), 5, 2
ENC = dict(swin_dim=64, swin_depths=(2, 2))


def _normed(rng, *shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _loss_inputs(rng, case):
    """q (B, HW, D), its labels and five key sets: plain labels, labels
    with class 2 missing everywhere, or a quarter of the pixels 255."""
    hw, d = 48, 16
    q = _normed(rng, B, hw, d)
    q_lab = rng.integers(0, NC, (B, hw))
    keys = [(_normed(rng, B, hw, d), rng.integers(0, NC, (B, hw)))
            for _ in range(5)]
    if case == "missing_class":
        q_lab[q_lab == 2] = 3
        for _, kl in keys:
            kl[kl == 2] = 1
    if case == "fill_255":
        q_lab[rng.random((B, hw)) < 0.25] = 255
        for _, kl in keys:
            kl[rng.random((B, hw)) < 0.25] = 255
    return q, q_lab.astype(np.int32), [(k, kl.astype(np.int32))
                                       for k, kl in keys]


@pytest.mark.parametrize("case", ["plain", "missing_class", "fill_255"])
def test_loss_matches_jax(rng, case):
    """The class-sum loss and its per-pixel statistics, 1e-5 relative.
    The statistics are compared on the query pixels whose label is a
    class: at a 255 pixel JAX's gather fills the out-of-range index with
    NaN, the port clamps it; both exclude those pixels from the mean. The
    JAX loss runs jitted, as the train step runs it (eagerly that NaN
    reaches the mean as NaN * 0)."""
    q, q_lab, keys = _loss_inputs(rng, case)
    jkeys = [(jnp.asarray(k), jnp.asarray(kl)) for k, kl in keys]
    pkeys = [(T_(k), T_(kl)) for k, kl in keys]
    jstats = jax.jit(jcontrastive.pixel_pair_stats, static_argnums=3)
    jloss = jax.jit(jcontrastive.class_sum_contrastive_loss,
                    static_argnums=3)
    P, N = contrastive.pixel_pair_stats(T_(q), T_(q_lab), pkeys, NC)
    jP, jN = jstats(jnp.asarray(q), jnp.asarray(q_lab), jkeys, NC)
    valid = (q_lab >= 0) & (q_lab < NC)
    np.testing.assert_allclose(P.numpy()[valid], np.asarray(jP)[valid],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(N.numpy()[valid], np.asarray(jN)[valid],
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(P.numpy()).all() and np.isfinite(N.numpy()).all()
    got = contrastive.class_sum_contrastive_loss(T_(q), T_(q_lab), pkeys, NC)
    want = jloss(jnp.asarray(q), jnp.asarray(q_lab), jkeys, NC)
    assert np.isfinite(float(got))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_contrast_momentum_matches_jax():
    K = 150
    for step in (0, K // 2, K):
        assert tc.contrast_momentum(step, K, 0.99) == pytest.approx(
            float(jtc.contrast_momentum(step, K, 0.99)), rel=1e-7)
    assert tc.contrast_momentum(0, K) == pytest.approx(0.99, rel=1e-6)
    assert tc.contrast_momentum(K, K) == pytest.approx(1.0, rel=1e-6)


def test_scale_lr_linear_matches_jax():
    for args in ((1.0, 4), (1.0, 4, 2), (0.5, 64, 4, 128)):
        assert optim.scale_lr_linear(*args) == joptim.scale_lr_linear(*args)


def test_lars_matches_optax(rng):
    """Three LARS steps on a warmup schedule against the JAX `make_lars`
    (optax.lars): rank-4, rank-2 and rank-1 leaves, one parameter of norm
    0 (its trust ratio is 1) and one leaf whose gradient is 0 on a step,
    1e-6 relative per leaf."""
    shapes = {"conv": (8, 4, 3, 3), "dense": (6, 5), "table": (9, 4),
              "scale": (6,), "bias": (6,), "zero": (5, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.3
              for k, s in shapes.items()}
    params["zero"][:] = 0.0
    port = {k: torch.nn.Parameter(T_(v.copy())) for k, v in params.items()}
    schedule = optim.warmup_cosine_schedule(0.5, 2, 10)
    opt = optim.make_lars(list(port.values()), schedule)
    tx = joptim.make_lars(joptim.warmup_cosine_schedule(0.5, 2, 10))
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        if step == 1:
            grads["dense"][:] = 0.0
        for k, p in port.items():
            p.grad = T_(grads[k].copy())
        opt.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in port.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} @ {step}")
    assert opt.count == 3


@pytest.mark.parametrize("shape", [(256, 448, 32, 56), (37, 53, 10, 7),
                                   (20, 30, 7, 11), (5, 6, 9, 13)])
def test_resize_nearest_matches_jax(rng, shape):
    H, W, h, w = shape
    x = rng.integers(0, 255, (2, 3, H, W, 1)).astype(np.int32)
    got = resize_nearest(T_(x), h, w).numpy()
    want = np.asarray(jresize_nearest(jnp.asarray(x), h, w))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _encoder(with_instance, seed=0):
    model = ContrastEncoder(NC, **ENC, with_instance=with_instance,
                            input_hw=HW)
    return init_weights(model, torch.Generator().manual_seed(seed))


def _jax_encoder(with_instance):
    return JContrastEncoder(num_classes=NC, **ENC,
                            with_instance=with_instance)


def _jax_variables(model):
    """The port's state as a JAX {"params", "batch_stats"} tree."""
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


def _seeded_stats(model, seed):
    """Running statistics away from (0, 1), so that the EMA chains start
    from values the check can tell apart."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(1.0 + torch.rand(b.shape, generator=g))
    return model


@pytest.mark.parametrize("with_instance", [False, True])
def test_encoder_tree_and_forward_match_jax(rng, with_instance):
    """The port's parameter names map one to one onto
    `ContrastEncoder.init`'s tree (no classifier: the JAX segmentor
    returns before creating it), and the eval-mode forward matches the
    JAX one within 1e-4."""
    jm = _jax_encoder(with_instance)
    x = jnp.zeros((1, 4, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x,
                                            train=False))
    model = _encoder(with_instance)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd, unmatched = state_dict_from_jax(zeros, model)
    assert unmatched == []
    assert sorted(set(model.state_dict()) - set(sd)) == []
    load_from_jax(_encoder(with_instance), zeros)  # raises on a leftover
    assert not any(k.startswith("segmentor.classifier")
                   for k in model.state_dict())
    assert ("projector_instance" in shapes["params"]) == with_instance

    _seeded_stats(model, 1)
    clip = rng.standard_normal((B, 4, *HW, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(T_(clip))
    want = jax.jit(lambda v, c: jm.apply(v, c, train=False))(
        _jax_variables(model), jnp.asarray(clip))
    if not with_instance:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    assert got[0].shape == (B, HW[0] // 8, HW[1] // 8, 256)


def _clips_labels(rng):
    clips = rng.standard_normal((B, 6, 4, *HW, 3)).astype(np.float32)
    blocks = rng.integers(0, NC, (B, 6, HW[0] // 16, HW[1] // 16))
    labels = np.repeat(np.repeat(blocks, 16, axis=2), 16, axis=3)
    return clips, labels.astype(np.int32)


def _check_stats(model, jstats, tol, prefix=""):
    for name, t in model.state_dict().items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        _, path = jax_path(name, t.dim())
        assert _rel(t.numpy(), _leaf(jstats, path)) <= tol, prefix + name


def test_key_pass_matches_jax(rng):
    """The port's key pass (six train-mode forwards under no_grad, in
    view order) against the JAX `make_key_pass` (vmapped views, the
    running statistics rebuilt by a fold): each view's keys within 1e-4,
    every BatchNorm statistic within 1e-4."""
    model = _seeded_stats(_encoder(False), 2)
    variables = _jax_variables(model)
    clips, _ = _clips_labels(rng)
    keys = tc.key_pass(model, T_(clips))
    jkeys, jstats = jax.jit(jtc.make_key_pass(_jax_encoder(False)))(
        variables["params"], variables["batch_stats"], jnp.asarray(clips))
    assert len(keys) == 6
    for v in range(6):
        np.testing.assert_allclose(keys[v].numpy(), np.asarray(jkeys[v]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"view {v}")
    _check_stats(model, jstats, 1e-4)


def _recording(tx):
    """`tx` that also keeps the last gradients in its state."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


# Stated bounds (fp32 on both sides; the port's GELU takes the erf
# polynomial, the JAX CPU route the exact erf, 2.6e-5 apart):
# * loss (and the instance term): 1e-4 relative;
# * gradients, per tensor: ||port - jax|| <= 1e-2 ||jax|| + NOISE_FACTOR
#   ||port - port'|| + 1e-6, and grad_norm likewise, where port' is the
#   port's own step on the clips scaled by 1 + 1e-7 noise (below fp32's
#   epsilon): the rounding sensitivity of that gradient on this step.
#   1e-2 is the bound of tests/test_torch_train.py (flax's E[x^2] - E[x]^2
#   BatchNorm backward is ill-conditioned where the mean is large against
#   the spread; conv biases feeding a train-mode BatchNorm have a true
#   gradient of 0, so both sides hold rounding noise there). This step is
#   worse conditioned than the stage-1 one: without the instance branch
#   the 1e-7 perturbation moves the ResNet's gradients by up to 0.5 %,
#   where port and JAX (every sum in another order) differ by up to
#   1.9 %, at most 3.8 times the perturbation's spread; with it, the
#   instance projector's and the ASPP image pool's BatchNorms normalise 2
#   values per channel at batch 2, the perturbation moves the trunk's
#   gradients by as much as port and JAX differ (up to 1.7 times, a
#   median 0.1), and the 1e-2 alone fails by up to 56x;
# * the EMA'd key parameters: 1e-6, elementwise absolute, on parameters
#   of order 0.1-1;
# * BatchNorm statistics of both branches: 1e-4 relative per tensor;
# * parameters after the LARS step: 1e-4, elementwise absolute, plus
#   NOISE_FACTOR times the largest difference from port' in the tensor
#   (a rank-1 parameter moves by lr * g, so it carries its gradient's
#   rounding noise).
LOSS_TOL, GRAD_TOL, GRAD_ATOL, NOISE_FACTOR = 1e-4, 1e-2, 1e-6, 8.0
EMA_TOL, STATS_TOL, PARAM_TOL = 1e-6, 1e-4, 1e-4
TOTAL_STEPS = 100


def _port_step(query, key, clips, labels, ins_loss_weight):
    """One port step from copies of `query` / `key`; returns the state,
    the metrics and the query gradients (numpy, the port's layouts)."""
    query = copy.deepcopy(query)
    state = tc.ContrastTrainState.create(query, lambda p: optim.make_lars(
        p, optim.warmup_cosine_schedule(0.1, 10, TOTAL_STEPS)))
    state.key.load_state_dict(key.state_dict())
    step = tc.make_contrast_train_step(state, NC, TOTAL_STEPS,
                                       ins_loss_weight=ins_loss_weight)
    grads = {}
    state.opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in query.named_parameters()}))
    metrics = step(T_(clips), T_(labels).long())
    return state, metrics, grads


@pytest.mark.parametrize("ins_loss_weight", [0.0, 0.5])
def test_contrast_step_matches_jax(rng, ins_loss_weight):
    """One contrast step of the port (plain twins on the CPU) against the
    JAX step from the same query weights, a key branch that differs from
    the query (its own seeded weights and statistics, so the EMA and the
    key pass are visible), the same batch and the same LARS schedule."""
    with_instance = ins_loss_weight > 0
    query = _seeded_stats(_encoder(with_instance, 0), 3)
    key = _seeded_stats(_encoder(with_instance, 1), 4)
    qvars, kvars = _jax_variables(query), _jax_variables(key)
    clips, labels = _clips_labels(rng)

    schedule = joptim.warmup_cosine_schedule(0.1, 10, TOTAL_STEPS)
    tx = _recording(joptim.make_lars(schedule))
    jstate = jtc.ContrastTrainState.create(qvars, tx).replace(
        params_k=kvars["params"], stats_k=kvars["batch_stats"])
    jstep = jtc.make_contrast_train_step(
        _jax_encoder(with_instance), tx, class_num=NC,
        total_steps=TOTAL_STEPS, ins_loss_weight=ins_loss_weight,
        query_mode="unrolled")
    jstate, jmetrics = jstep(jstate, jnp.asarray(clips), jnp.asarray(labels))
    jgrads = jstate.opt_state[1]

    state, metrics, grads = _port_step(query, key, clips, labels,
                                       ins_loss_weight)
    noisy = clips * (1 + 1e-7 * np.random.default_rng(9).standard_normal(
        clips.shape))
    state_n, metrics_n, grads_n = _port_step(query, key, noisy.astype(np.float32),
                                       labels, ins_loss_weight)

    assert state.step == 1 and state.opt.count == 1
    for k in ("loss",) + (("ins_loss",) if with_instance else ()):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  rel=LOSS_TOL), k
    gn, gn_n = float(metrics["grad_norm"]), float(metrics_n["grad_norm"])
    gn_j = float(jmetrics["grad_norm"])
    assert abs(gn - gn_j) <= LOSS_TOL * gn_j + NOISE_FACTOR * abs(gn - gn_n)
    m = float(metrics["momentum"])
    assert m == pytest.approx(float(jmetrics["momentum"]), rel=1e-7)
    assert m == tc.contrast_momentum(0, TOTAL_STEPS)

    over, moved = {}, []
    params_n = dict(state_n.query.named_parameters())
    for name, p in state.query.named_parameters():
        _, path = jax_path(name, p.dim())
        pg = to_jax_layout(name, grads[name])
        jg = _leaf(jgrads, path)
        bound = (GRAD_TOL * np.linalg.norm(jg) + GRAD_ATOL + NOISE_FACTOR
                 * np.linalg.norm(grads[name] - grads_n[name]))
        if np.linalg.norm(pg - jg) > bound:
            over[name] = float(np.linalg.norm(pg - jg) / bound)
        got = to_jax_layout(name, p.detach().numpy())
        spread = (p - params_n[name]).abs().max().item()
        np.testing.assert_allclose(got, _leaf(jstate.params_q, path), rtol=0,
                                   atol=PARAM_TOL + NOISE_FACTOR * spread,
                                   err_msg=name)
        if np.linalg.norm(jg) > 1e-6:
            moved.append(not torch.equal(p.detach(),
                                         dict(query.named_parameters())[name]))
    assert over == {}
    assert all(moved)
    q0 = dict(query.named_parameters())
    k0 = dict(key.named_parameters())
    for name, p in state.key.named_parameters():
        _, path = jax_path(name, p.dim())
        want = (k0[name] * m + q0[name] * (1.0 - m)).detach()
        np.testing.assert_allclose(p.numpy(), want.numpy(), rtol=0,
                                   atol=EMA_TOL, err_msg=name)
        np.testing.assert_allclose(to_jax_layout(name, p.numpy()),
                                   _leaf(jstate.params_k, path), rtol=0,
                                   atol=EMA_TOL, err_msg=name)
    _check_stats(state.query, jstate.stats_q, STATS_TOL, "query ")
    _check_stats(state.key, jstate.stats_k, STATS_TOL, "key ")
