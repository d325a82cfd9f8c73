"""The stage-1 training slice of the port against the JAX package on the
CPU, fp32: differentiable parameter casts, train-mode BatchNorm, the
losses, the optimizers and schedules, and one whole train step of a small
TswinPlus (loss, every gradient, the new BatchNorm statistics and the
parameters after one Adam step) against `make_seg_train_step`."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from stswincl_tpu.configs import SegTrainConfig  # noqa: E402
from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.ops import ohem as johem  # noqa: E402
from stswincl_tpu.ops import resize as jresize  # noqa: E402
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch.ckpt import jax_path, to_jax_layout  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.models.norm import BatchNorm  # noqa: E402
from stswincl_tpu_torch.ops import ohem  # noqa: E402
from stswincl_tpu_torch.ops.resize import resize_bilinear_cf_matmul  # noqa: E402
from stswincl_tpu_torch.pipelines.seg import make_tx, train_steps  # noqa: E402
from stswincl_tpu_torch.train import optim, train_seg  # noqa: E402

torch.set_num_threads(1)
T_ = torch.from_numpy

# 128x128 input: a 16x16 stage-1 feature map keeps the stage-1 shift
# (`min(H, W) <= ws` clamps it away) and 8x8 keeps stage 2's
HW, NC, B = (128, 128), 5, 2


def _small_model(**kw):
    model = TswinPlus(NC, swin_dim=64, swin_depths=(2, 2), input_hw=HW, **kw)
    return init_weights(model, torch.Generator().manual_seed(0))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 4, *HW, 3)).astype(np.float32)
    labels = rng.integers(-1, NC, (B, *HW)).astype(np.int32)
    return images, labels


def test_every_parameter_gets_a_gradient():
    """Repair of the parameter casts: with grad enabled, the working
    copies are casts in the graph, so every parameter of the model gets a
    finite gradient; and the kernel route's autograd Functions (their
    twins on the CPU) give the plain route's gradients."""
    images, labels = _batch()
    grads = []
    for kern in (False, True):
        model = _small_model(kernels=kern)
        step = train_seg.make_seg_train_step(model, optim.make_adam(
            model.parameters()))
        step.loss(T_(images), T_(labels).long()).backward()
        named = dict(model.named_parameters())
        missing = [n for n, p in named.items() if p.grad is None]
        assert missing == []
        assert all(torch.isfinite(p.grad).all() for p in named.values())
        grads.append({n: p.grad for n, p in named.items()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-4, atol=1e-6,
                                   msg=n)


def test_batchnorm_train_matches_flax(rng):
    x = (rng.standard_normal((4, 6, 5, 8)) * 2 + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = bn.init(jax.random.key(0), jnp.asarray(x))
    p = {k: rng.standard_normal(8).astype(np.float32) * 0.3 + o
         for k, o in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0))}
    p["var"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    variables = {"params": {"scale": p["scale"], "bias": p["bias"]},
                 "batch_stats": {"mean": p["mean"], "var": p["var"]}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(8)
    port.load_state_dict({"weight": T_(p["scale"]), "bias": T_(p["bias"]),
                          "running_mean": T_(p["mean"]),
                          "running_var": T_(p["var"])})
    out = port.train()(T_(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    for port_buf, jkey in ((port.running_mean, "mean"),
                           (port.running_var, "var")):
        np.testing.assert_allclose(port_buf.numpy(),
                                   np.asarray(upd["batch_stats"][jkey]),
                                   rtol=1e-6, atol=1e-6)


def test_per_pixel_ce_and_resize_match_jax(rng):
    logits = (rng.standard_normal((2, NC, 6, 7)) * 3).astype(np.float32)
    labels = rng.integers(-1, NC, (2, 6, 7)).astype(np.int32)
    got = ohem.per_pixel_ce_channels_first(T_(logits), T_(labels))
    want = johem.per_pixel_ce_channels_first(jnp.asarray(logits),
                                             jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    got = resize_bilinear_cf_matmul(T_(logits), 24, 21)
    want = jresize.resize_bilinear_cf_matmul(jnp.asarray(logits), 24, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _ohem_losses(rng):
    """Flat loss vectors for each branch of the OHEM select: many hard
    pixels (threshold branch), few (top-k branch), and a top-k whose k-th
    value is tied far past k."""
    n = 4000
    many = rng.uniform(0.0, 3.0, n).astype(np.float32)
    few = np.where(rng.random(n) < 0.02, 2.0, 0.1).astype(np.float32)
    ties = np.full(n, 0.2, np.float32)
    ties[:50] = rng.uniform(0.3, 0.34, 50).astype(np.float32)
    return {"threshold": many, "top-k": few, "ties": ties}


@pytest.mark.parametrize("case", ["threshold", "top-k", "ties"])
def test_ohem_select_matches_jax_and_the_sort_oracle(rng, case):
    loss = _ohem_losses(rng)[case]
    n_min = 200
    got = float(ohem._ohem_select(T_(loss), n_min, 0.7))
    for fn in (johem._ohem_select, johem._ohem_select_sort):
        want = float(fn(jnp.asarray(loss), n_min, 0.7))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("thresh", [0.7, 0.01])
def test_ohem_loss_and_gradient_match_jax(rng, thresh):
    """thresh 0.7 takes the threshold branch on these logits, 0.01 the
    top-k branch; the gradient reaches only the kept pixels in both."""
    logits = (rng.standard_normal((2, NC, 16, 16)) * 2).astype(np.float32)
    labels = rng.integers(-1, NC, (2, 16, 16)).astype(np.int32)
    n_min = 16 * 16 // 16
    jf = lambda lg: johem.ohem_cross_entropy_channels_first(
        lg, jnp.asarray(labels), n_min, thresh)
    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(logits))
    lt = T_(logits).requires_grad_()
    got = ohem.ohem_cross_entropy_channels_first(lt, T_(labels).long(),
                                                 n_min, thresh)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-7)
    lnhwc = logits.transpose(0, 2, 3, 1).copy()
    got = ohem.ohem_cross_entropy(T_(lnhwc), T_(labels), n_min, thresh)
    want = johem.ohem_cross_entropy(jnp.asarray(lnhwc), jnp.asarray(labels),
                                    n_min, thresh)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("ignore_index", [-1, 3])
def test_dice_and_bce_match_jax(rng, ignore_index):
    logits = (rng.standard_normal((2, 6, 7, NC)) * 2).astype(np.float32)
    labels = rng.integers(-1, NC, (2, 6, 7)).astype(np.int32)
    got = train_seg.dice_loss(T_(logits), T_(labels), NC)
    want = jtrain.dice_loss(jnp.asarray(logits), jnp.asarray(labels), NC)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    got = train_seg.bce_loss(T_(logits), T_(labels), NC, ignore_index)
    want = jtrain.bce_loss(jnp.asarray(logits), jnp.asarray(labels), NC,
                           ignore_index)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


class _FixedLogits(nn.Module):
    """Stand-in model: returns its logits parameter in the layout the
    loss asks for (channels first for OHEM / CE, classes last else)."""

    def __init__(self, logits_cf: np.ndarray):
        super().__init__()
        self.logits = nn.Parameter(T_(logits_cf))

    def forward(self, images, channels_first_logits=False):
        lg = self.logits
        return lg if channels_first_logits else lg.permute(0, 2, 3, 1)


@pytest.mark.parametrize("loss_type", ["ohem", "ce", "dice", "bce"])
def test_step_losses_match_jax(rng, loss_type):
    """Each branch of the step's loss (`train_seg.py:103-122`), on the
    same logits, against the JAX package's formulas."""
    logits = (rng.standard_normal((2, NC, 16, 16)) * 2).astype(np.float32)
    labels = rng.integers(-1, NC, (2, 16, 16)).astype(np.int32)
    model = _FixedLogits(logits)
    step = train_seg.make_seg_train_step(
        model, optim.make_adam(model.parameters()), loss_type=loss_type)
    got = float(step.loss(None, T_(labels).long()).detach())
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    if loss_type == "ohem":
        want = johem.ohem_cross_entropy_channels_first(lj, yj, 16, 0.7, -1)
    elif loss_type == "ce":
        ce = johem.per_pixel_ce_channels_first(lj, yj, -1)
        want = jnp.sum(ce) / jnp.maximum(jnp.sum(yj != -1), 1)
    elif loss_type == "dice":
        want = jtrain.dice_loss(lj.transpose(0, 2, 3, 1), yj, NC)
    else:
        want = jtrain.bce_loss(lj.transpose(0, 2, 3, 1), yj, NC, -1)
    assert got == pytest.approx(float(want), rel=1e-6)


def test_schedules_match_jax():
    pairs = [
        (optim.poly_schedule(1e-2, 100), joptim.poly_schedule(1e-2, 100)),
        (optim.poly_schedule(1e-2, 100, warmup_steps=10),
         joptim.poly_schedule(1e-2, 100, warmup_steps=10)),
        (optim.step_schedule(0.1, 7, 3), joptim.step_schedule(0.1, 7, 3)),
        (optim.warmup_cosine_schedule(1.0, 10, 100),
         joptim.warmup_cosine_schedule(1.0, 10, 100)),
    ]
    for port, jax_fn in pairs:
        for step in (0, 1, 5, 10, 11, 21, 50, 99, 100, 150):
            # the JAX schedules evaluate in float32 (abs 1e-7 at LR 1)
            assert port(step) == pytest.approx(float(jax_fn(step)),
                                               rel=1e-5, abs=1e-7)


class _TwoPart(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.Linear(4, 3)
        self.classifier = nn.Linear(3, 2)


def _jax_tree(module):
    # copies: a JAX array may alias the numpy buffer, which the torch
    # optimizer then updates in place
    return {name: {k: jnp.array(v.detach().numpy(), copy=True)
                   for k, v in sub.named_parameters()}
            for name, sub in module.named_children()}


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizers_match_optax(rng, kind):
    """Adam (stage 1) and SGD with folded decay, momentum, a poly schedule
    and a x10 classifier group (stage 3), against the JAX package's
    optax chains, after one and after three steps."""
    torch.manual_seed(0)
    model = _TwoPart()
    params = _jax_tree(model)
    if kind == "adam":
        opt, schedule = optim.make_adam(model.parameters()), \
            optim.constant_schedule(3e-4)
        tx = joptim.make_adam(3e-4)
    else:
        opt = optim.make_sgd(model, 1e-2, 0.9, 1e-4, head_lr_mult=10.0)
        schedule = optim.poly_schedule(1e-2, 10)
        tx = joptim.make_sgd(joptim.poly_schedule(1e-2, 10), 0.9, 1e-4,
                             head_lr_mult=10.0)
    state = tx.init(params)
    for step in range(3):
        grads = {n: {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in sub.items()} for n, sub in params.items()}
        for name, sub in model.named_children():
            for k, p in sub.named_parameters():
                p.grad = T_(grads[name][k].copy())
        optim.apply_schedule(opt, schedule, step)
        opt.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   params)
        params = optax.apply_updates(params, updates)
        if step in (0, 2):
            for name, sub in model.named_children():
                for k, p in sub.named_parameters():
                    np.testing.assert_allclose(
                        p.detach().numpy(), np.asarray(params[name][k]),
                        rtol=1e-6, atol=1e-7, err_msg=f"{name}.{k} @ {step}")


def _jax_variables(model):
    """The port's state as a JAX {"params", "batch_stats"} tree, through
    the reverse name map."""
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


def _recording(tx):
    """`tx` that also keeps the last gradients in its state, so the
    jitted JAX step hands them back."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)
    return optax.GradientTransformation(init, update)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# Stated bounds (fp32 on both sides; the port's GELU uses the erf
# polynomial, the JAX CPU route the exact erf, 2.6e-5 apart):
# * loss: 1e-5 relative.
# * gradients, per tensor: ||port - jax|| <= 1e-2 ||jax|| + 1e-6. flax's
#   train-mode BatchNorm takes the variance as E[x^2] - E[x]^2, whose fp32
#   backward is ill-conditioned where the mean is large against the
#   spread (one BatchNorm at mean 30 sigma: 3.5e-4 from a float64
#   reference, the port 2.6e-5); through the classifier's BatchNorm that
#   leaves up to 4.8e-3 between the packages on this model. Conv biases
#   that feed a train-mode BatchNorm have a true gradient of zero: both
#   sides give rounding noise (below 2e-7), hence the absolute term.
# * batch statistics, per tensor: 1e-4 relative (a running mean whose
#   batch means are small against the activations carries the rounding of
#   their sums, taken in another order: 2.6e-5 measured).
# * parameters after one Adam step: the step is lr * g / (|g| + 1e-8),
#   about lr * sign(g), so where a gradient element is near zero the two
#   packages may move it differently. Every element moves by at most lr
#   (to fp32 rounding) in both; where both gradient elements share a sign and are at least
#   1e-5, the updated parameters agree within 1e-6, and those are at least
#   half of all elements (71 % on this model).
LOSS_TOL, GRAD_TOL, GRAD_ATOL, STATS_TOL = 1e-5, 1e-2, 1e-6, 1e-4


def test_train_step_matches_jax():
    images, labels = _batch()
    port = _small_model()
    variables = _jax_variables(port)
    jm = JTswinPlus(num_classes=NC, swin_dim=64, swin_depths=(2, 2))
    tx = _recording(joptim.make_adam(3e-4))
    jstate = jtrain.SegTrainState.create(variables, tx)
    jstep = jtrain.make_seg_train_step(jm, tx, loss_type="ohem")
    jstate, jm_metrics = jstep(jstate, jnp.asarray(images),
                               jnp.asarray(labels))
    jgrads = jstate.opt_state[1]

    cfg = SegTrainConfig()
    opt, schedule = make_tx(cfg, 10, port)
    step = train_seg.make_seg_train_step(port, opt, schedule, "ohem")
    old = {n: t.clone() for n, t in port.state_dict().items()}
    grads = {}

    def keep_grads(_opt, *_):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in port.named_parameters()})
    hook = opt.register_step_pre_hook(keep_grads)
    metrics = train_steps(step, [{"image": images, "label": labels}], 1,
                          torch.device("cpu"))
    hook.remove()
    assert step.step == 1 and len(metrics) == 1
    assert metrics[0]["loss"] == pytest.approx(float(jm_metrics["loss"]),
                                               rel=LOSS_TOL)
    assert metrics[0]["grad_norm"] == pytest.approx(
        float(jm_metrics["grad_norm"]), rel=GRAD_TOL)

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
                <= GRAD_TOL * np.linalg.norm(jg) + GRAD_ATOL), name
        lr = cfg.lr
        start = to_jax_layout(name, old[name].numpy())
        # at most lr, plus the fp32 rounding of the parameter
        assert np.abs(got - start).max() <= 1.001 * lr, name
        assert np.abs(want - start).max() <= 1.001 * lr, name
        sure = (np.sign(pg) == np.sign(jg)) & (
            np.minimum(np.abs(pg), np.abs(jg)) >= 1e-5)
        np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=name)
        stable += sure.sum()
        total += sure.size
    assert stable >= total / 2
