"""A short stage-1 trajectory on both packages (CPU, fp32): k = 4 steps of
the stage-1 step (`SegTrainConfig`'s Adam 3e-4, OHEM 0.7) from the same
seeded weights on the same synthetic clips (the JAX package's
`SyntheticSegDataset`, batch 2, 128x128, 5 classes), a small TswinPlus
(swin_dim 64, depths (2, 2)). The JAX variables are built from the port's
weights (`ckpt.jax_path` / `to_jax_layout`). Held: each step's loss, the
parameters' displacements after k steps and the BatchNorm statistics
after k steps, to the bounds stated below.

Planted faults show what the bounds can tell apart. Each of these misses
them (measured on this run; the first two are cases of
`test_bounds_catch_a_planted_fault`):
* Adam without its bias correction: losses 17-23 % off at steps 2-4,
  elements 4.7 * K * lr from the JAX ones;
* steps 2-4 fed the other batches (order 0, 3, 1, 2): losses 2.8e-3 and
  2.1e-3 off at steps 2 and 3, displacement cosines down to 0.57, the
  BatchNorm statistics 9.9e-2 off;
* the BatchNorm statistics updated at step 1 only: 0.71 off.
One fault the bounds cannot see in 4 steps: Adam's beta2 at 0.99 for
0.999 reads like a sound run (losses 2.0e-4 and 2.4e-3 off at steps 3
and 4, cosines 0.927 and up), because the second moment's average over
4 steps hardly depends on it."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stswincl_tpu.configs import SegTrainConfig  # noqa: E402
from stswincl_tpu.data.loader import SyntheticSegDataset  # noqa: E402
from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu.train import optim as joptim  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch.ckpt import jax_path, to_jax_layout  # noqa: E402
from stswincl_tpu_torch.pipelines.seg import make_tx, train_steps  # noqa: E402
from stswincl_tpu_torch.train import train_seg  # noqa: E402
from stswincl_tpu_torch.models.aspp import ConvBNRelu  # noqa: E402
from tests.test_torch_train import (HW, NC, _jax_variables, _leaf,  # noqa: E402
                                    _rel, _small_model)

torch.set_num_threads(2)
K, BATCH = 4, 2
# Stated bounds. Adam's first steps move each element by about
# lr * sign(g), so where a gradient element sits near 0, rounding decides
# its direction and the later steps inherit it: two fp32 evaluations of
# the same trajectory part at the rounding level. Port and JAX (the erf
# polynomial against the exact erf, flax's E[x^2] - E[x]^2 variance,
# every sum in another order) measured on this run with 1, 2 and 4 CPU
# threads: losses 3.5e-7, 1.2e-4, 1.4e-4 and 2.6e-3 relative at steps
# 1-4; each parameter's displacement from the start at most 36 % of its
# norm apart, its cosine at least 0.933 (the stem's and layer1's
# BatchNorm parameters the worst); the BatchNorm statistics 2.0e-2.
# Held:
# * step 1's loss within 1e-5 relative (no step taken yet), steps 2 and
#   3 within 1e-3, step 4 within 1e-2;
# * each parameter's displacement: ||port - jax|| <= 0.75 ||jax|| and a
#   cosine >= 0.8, no element more than 2 * K * lr from the JAX one, and
#   none at all where the JAX one did not move (the last stage-2 layer
#   at depths (2, 2) feeds nothing); the conv biases that feed a
#   train-mode BatchNorm (a true gradient of 0, rounding noise on both
#   sides) only to the element bound;
# * each BatchNorm statistic within 5e-2 relative.
LOSS_TOL = (1e-5, 1e-3, 1e-3, 1e-2)
MOVE_TOL, MOVE_COS, STATS_TOL = 0.75, 0.8, 5e-2


def _batches():
    ds = SyntheticSegDataset(length=K * BATCH, t=4, hw=HW, num_classes=NC)
    out = []
    for k in range(K):
        samples = [ds.get(k * BATCH + i) for i in range(BATCH)]
        out.append({
            "image": np.stack([s["image"] for s in samples]),
            "label": np.stack([s["label"] for s in samples])})
    return out


class _AdamWithoutBiasCorrection(torch.optim.Optimizer):
    """A planted fault: Adam's moments without their bias correction."""

    def __init__(self, params, lr):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["m"], st["v"] = torch.zeros_like(p), torch.zeros_like(p)
                st["m"].mul_(0.9).add_(p.grad, alpha=0.1)
                st["v"].mul_(0.999).addcmul_(p.grad, p.grad, value=0.001)
                p.sub_(group["lr"] * st["m"] / (st["v"].sqrt() + 1e-8))


@pytest.fixture(scope="module")
def jax_run():
    """The batches, the seeded start and the JAX package's k steps from
    it: its losses and its variables after them."""
    batches = _batches()
    port = _small_model()
    cfg = SegTrainConfig()
    jm = JTswinPlus(num_classes=NC, swin_dim=64, swin_depths=(2, 2))
    tx = joptim.make_adam(cfg.lr)
    jstate = jtrain.SegTrainState.create(_jax_variables(port), tx)
    jstep = jtrain.make_seg_train_step(jm, tx, loss_type="ohem",
                                       ohem_thresh=cfg.ohem_thresh)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jnp.asarray(b["image"]),
                          jnp.asarray(b["label"]))
        jlosses.append(float(m["loss"]))
    return batches, jlosses, {"params": jstate.params,
                              "batch_stats": jstate.batch_stats}


def _port_misses(jax_run, order=range(K), fault_opt=False) -> list:
    """k port steps on the batches in `order` (with `fault_opt`, Adam
    without bias correction); returns the bounds the run misses."""
    batches, jlosses, new_vars = jax_run
    cfg = SegTrainConfig()
    port = _small_model()
    start = {n: t.clone() for n, t in port.state_dict().items()}
    opt, schedule = make_tx(cfg, K, port)
    if fault_opt:
        opt = _AdamWithoutBiasCorrection(port.parameters(), cfg.lr)
    step = train_seg.make_seg_train_step(port, opt, schedule, "ohem",
                                         ohem_thresh=cfg.ohem_thresh)
    losses = [m["loss"] for m in train_steps(
        step, [batches[i] for i in order], K, torch.device("cpu"))]
    assert len(losses) == len(jlosses) == K
    assert losses[-1] != losses[0]
    misses = [f"loss at step {k + 1}: {got} vs {want}" for k, (got, want, tol)
              in enumerate(zip(losses, jlosses, LOSS_TOL))
              if got != pytest.approx(want, rel=tol)]
    zero_grad = {f"{n}.conv.bias" for n, mod in port.named_modules()
                 if isinstance(mod, ConvBNRelu)}
    for name, t in port.state_dict().items():
        coll, path = jax_path(name, t.dim())
        want = _leaf(new_vars[coll], path)
        got = to_jax_layout(name, t.numpy())
        if coll == "batch_stats":
            if _rel(got, want) > STATS_TOL:
                misses.append(f"{name}: {_rel(got, want)}")
            continue
        s = to_jax_layout(name, start[name].numpy())
        got, want = (got - s).ravel(), (want - s).ravel()
        if np.abs(got - want).max() > 2 * K * cfg.lr * 1.001:
            misses.append(f"{name}: element {np.abs(got - want).max()}")
        if name in zero_grad:
            continue
        norm = np.linalg.norm(want)
        if norm == 0:
            if got.any():
                misses.append(f"{name}: moved where the JAX one did not")
            continue
        if np.linalg.norm(got - want) > MOVE_TOL * norm:
            misses.append(f"{name}: displacement "
                          f"{np.linalg.norm(got - want) / norm} apart")
        if got @ want < MOVE_COS * np.linalg.norm(got) * norm:
            misses.append(f"{name}: cosine "
                          f"{got @ want / np.linalg.norm(got) / norm}")
    return misses


def test_four_stage1_steps_match_jax(jax_run):
    assert _port_misses(jax_run) == []


@pytest.mark.parametrize("fault", ["no_bias_correction", "other_batches"])
def test_bounds_catch_a_planted_fault(jax_run, fault):
    """The port's run with a planted fault misses the bounds above:
    Adam without bias correction, or steps 2-4 fed the other batches."""
    if fault == "no_bias_correction":
        misses = _port_misses(jax_run, fault_opt=True)
    else:
        misses = _port_misses(jax_run, order=(0, 3, 1, 2))
    assert misses
