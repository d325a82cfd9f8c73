"""The port's data-parallel layer (`stswincl_tpu_torch/parallel/`) against
the JAX package on the CPU: two gloo ranks, spawned with
`torch.multiprocessing` (`tests/torch_parallel_ranks.py`), each on its
contiguous half of a global batch, against the JAX functions on the whole
batch (the collectives under `shard_map` on `make_mesh(2)`).

Held: the collectives; a synced `BatchNorm` (output, input and parameter
gradients, running statistics) against flax's on the global batch; OHEM's
global selection in both branches with ties straddling the ranks; the CE,
dice and BCE normalisers; rank-0 checkpoints; the LR's host count (and
`run_contrast_pretraining` over two ranks on the one-process LR, reaching
the one-process weights); the kernel launcher's per-thread device. The halves differ in valid and hard
pixel counts, so each reduction done per rank (the planted faults) misses
its bound at least tenfold. The group's collective timeout covers rank
0's evaluation.

A loss all-reduced differentiably is the global loss on every rank, and
its backward gives each rank W times its shard's share of the global
gradient (W = 2 ranks), which DDP's mean divides out: the gradients below
are compared after that division.
"""

import datetime
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from stswincl_tpu.ops import ohem as johem  # noqa: E402
from stswincl_tpu.parallel import collectives as jcoll  # noqa: E402
from stswincl_tpu.parallel import make_mesh  # noqa: E402
from stswincl_tpu.train import train_seg as jtrain  # noqa: E402
from stswincl_tpu_torch import cli, kernels, parallel  # noqa: E402
from stswincl_tpu_torch.ckpt import load_checkpoint  # noqa: E402
from stswincl_tpu_torch.configs import (ContrastTrainConfig,  # noqa: E402
                                        DataConfig, ModelConfig)
from stswincl_tpu_torch.data.loader import Loader  # noqa: E402
from stswincl_tpu_torch.ops import swin_block  # noqa: E402
from stswincl_tpu_torch.pipelines.contrast import (  # noqa: E402
    contrast_lr, run_contrast_pretraining)
from tests import torch_parallel_ranks as ranks  # noqa: E402

W = ranks.WORLD
NC = 5
# Stated bounds (fp32 on both sides, sums taken in another order):
# values 1e-5 relative; gradients 1e-4 relative + 1e-7 absolute per
# element; BatchNorm outputs and statistics 1e-5.
VAL_TOL, GRAD_RTOL, GRAD_ATOL, BN_TOL = 1e-5, 1e-4, 1e-7, 1e-5


def _ohem_cases(rng):
    """Flat per-pixel losses, 2000 a rank, whose halves differ in their
    hard counts: the threshold branch; the top-k branch; and a top-k
    whose k-th value v* = 0.2 is tied on both ranks (30 + 10 hard values
    of 0.5 above it, n_min 200), so the tie term straddles the ranks."""
    n = 2000
    thr = np.concatenate([rng.uniform(0.0, 3.0, n), rng.uniform(0.0, 0.5, n)])
    topk = rng.uniform(0.0, 0.3, 2 * n)
    topk[rng.choice(n, 40, replace=False)] = rng.uniform(0.5, 1.0, 40)
    ties = np.full(2 * n, 0.2)
    ties[:30] = 0.5
    ties[n:n + 10] = 0.5
    return {"threshold": (thr.astype(np.float32), 200, 0.7),
            "top-k": (topk.astype(np.float32), 200, 0.7),
            "ties": (ties.astype(np.float32), 200, 0.7)}


def _labels(rng):
    """(4, 8, 8) labels: rank 0's half 60 % ignored (-1), rank 1's 5 %."""
    lab = rng.integers(0, NC, (4, 8, 8))
    ignored = np.concatenate([rng.random((2, 8, 8)) < 0.6,
                              rng.random((2, 8, 8)) < 0.05])
    return np.where(ignored, -1, lab).astype(np.int32)


def _inputs(tmp):
    rng = np.random.default_rng(0)
    bn_x = rng.standard_normal((8, 3, 4, 6)).astype(np.float32)
    bn_x[:4] = bn_x[:4] * 2.0 + 1.5  # the halves' statistics differ
    return {
        "x": rng.standard_normal((4, 3)).astype(np.float32),
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "bn_x": bn_x,
        "bn_g": rng.standard_normal(bn_x.shape).astype(np.float32),
        "bn_state": {
            "weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.standard_normal(6).astype(np.float32) * 0.3,
            "running_mean": rng.standard_normal(6).astype(np.float32) * 0.1,
            "running_var": rng.uniform(0.5, 1.5, 6).astype(np.float32)},
        "ohem": _ohem_cases(rng),
        "logits_cf": (rng.standard_normal((4, NC, 8, 8)) * 2).astype(
            np.float32),
        "labels": _labels(rng),
        # 0.7 takes the threshold branch on these logits, 0.02 the top-k
        "n_min": 24, "thresh": {"ohem_cf": 0.7, "ohem_last": 0.02},
        "bce_ignore": 3,
        "ckpt_dir": os.path.join(tmp, "ckpt"),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs(str(tmp_path_factory.mktemp("parallel")))
    return inputs, ranks.run_world(ranks.reductions, inputs)


def _shard(a, r):
    return ranks.shard(a, r, W)


def _sharded(fn, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=make_mesh(W), in_specs=P("data"),
                                 out_specs=out_specs))


@pytest.mark.parametrize("name", ["sum", "mean", "collect", "bn_stats"])
def test_collectives_match_jax_shard_map(world, name):
    inputs, outs = world
    x = jnp.asarray(inputs["x"])
    if name == "bn_stats":
        def fn(xs):
            m, v = jcoll.cross_replica_batch_norm_stats(xs)
            return m[None], v[None]
        jm, jv = _sharded(fn, (P("data"), P("data")))(x)
        for r in range(W):
            np.testing.assert_allclose(outs[r]["bn_stats"][0], jm[r],
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(outs[r]["bn_stats"][1], jv[r],
                                       rtol=1e-6, atol=1e-7)
        return
    fn = {"sum": jcoll.reduce_sum, "mean": jcoll.reduce_mean,
          "collect": jcoll.dist_collect}[name]
    want = np.asarray(_sharded(fn, P("data"))(x))
    per = want.shape[0] // W
    for r in range(W):
        np.testing.assert_allclose(outs[r][name], want[r * per:(r + 1) * per],
                                   rtol=1e-6, atol=1e-7)


def test_dist_collect_gradient(world):
    """The gradient of a rank's slice of the gathered tensor is the sum of
    the ranks' gradients of it: W * w[slice] for sum(gathered * w)."""
    inputs, outs = world
    for r in range(W):
        np.testing.assert_allclose(outs[r]["collect_grad"],
                                   W * _shard(inputs["w"], r), rtol=1e-6)


def _flax_bn(inputs):
    """flax's train-mode BatchNorm on the global batch: output, running
    statistics, and the vjp of sum(y * g)."""
    st = inputs["bn_state"]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": st["weight"], "bias": st["bias"]},
                 "batch_stats": {"mean": st["running_mean"],
                                 "var": st["running_var"]}}

    def f(params, x):
        return bn.apply({"params": params,
                         "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])
    x = jnp.asarray(inputs["bn_x"])
    y, upd = f(variables["params"], x)
    dparams, dx = jax.grad(lambda p, x: jnp.sum(
        f(p, x)[0] * inputs["bn_g"]), argnums=(0, 1))(variables["params"], x)
    return dict(y=np.asarray(y), dx=np.asarray(dx),
                dweight=np.asarray(dparams["scale"]),
                dbias=np.asarray(dparams["bias"]),
                mean=np.asarray(upd["batch_stats"]["mean"]),
                var=np.asarray(upd["batch_stats"]["var"]))


def test_synced_batchnorm_matches_flax_on_the_global_batch(world):
    """Each rank's output and input gradient are its shard of flax's; the
    ranks' parameter gradients sum to flax's (the cotangent is given per
    shard, not through a reduced loss); both ranks' running statistics
    are flax's."""
    inputs, outs = world
    want = _flax_bn(inputs)
    for r in range(W):
        got = outs[r]["bn_True"]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], _shard(want[k], r),
                                       rtol=BN_TOL, atol=BN_TOL, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=k)
    for k in ("dweight", "dbias"):
        np.testing.assert_allclose(sum(o["bn_True"][k] for o in outs),
                                   want[k], rtol=BN_TOL, atol=BN_TOL,
                                   err_msg=k)


def test_local_batchnorm_misses_the_bound(world):
    """Planted fault: the same BatchNorm without `sync_batchnorm`
    normalises by its shard's statistics."""
    inputs, outs = world
    want = _flax_bn(inputs)
    for r in range(W):
        got = outs[r]["bn_False"]
        assert np.abs(got["y"] - _shard(want["y"], r)).max() > 10 * BN_TOL
        assert np.abs(got["mean"] - want["mean"]).max() > 10 * BN_TOL


def test_synced_buffers_need_no_ddp_broadcast(world):
    """DDP's per-forward buffer broadcast is off, and a synced BatchNorm's
    running statistics come out equal on both ranks without it."""
    _, outs = world
    assert not outs[0]["ddp_broadcasts_buffers"]
    for a, b in zip(outs[0]["ddp_buffers"], outs[1]["ddp_buffers"]):
        np.testing.assert_array_equal(a, b)


def _close(value, grads, want, jgrad):
    """(value within VAL_TOL, each rank's gradient / W within the gradient
    bound of its shard of jgrad)."""
    ok = abs(value - want) <= VAL_TOL * abs(want)
    return ok and all(np.allclose(g / W, _shard(jgrad, r), rtol=GRAD_RTOL,
                                  atol=GRAD_ATOL) for r, g in enumerate(grads))


@pytest.mark.parametrize("case", ["threshold", "top-k", "ties"])
def test_ohem_select_is_global(world, case):
    """`_ohem_select` under the group against the JAX `_ohem_select` (and
    its sort oracle) on the global vector: the same value on both ranks,
    the global gradient; selected per rank (the planted fault) it is not
    (every branch: the hard counts of the halves differ)."""
    inputs, outs = world
    loss, n_min, thresh = inputs["ohem"][case]
    want, jgrad = jax.value_and_grad(
        lambda v: johem._ohem_select(v, n_min, thresh))(jnp.asarray(loss))
    sort = johem._ohem_select_sort(jnp.asarray(loss), n_min, thresh)
    assert float(want) == pytest.approx(float(sort), rel=1e-6)
    vals = [o[f"ohem_{case}_True"][0] for o in outs]
    assert vals[0] == vals[1]
    assert _close(vals[0], [o[f"ohem_{case}_True"][1] for o in outs],
                  float(want), np.asarray(jgrad))
    for o in outs:
        local = o[f"ohem_{case}_False"][0]
        assert abs(local - float(want)) > 10 * VAL_TOL * abs(float(want))


def _jax_loss(name, inputs):
    lab = jnp.asarray(inputs["labels"])
    n_min, thresh = inputs["n_min"], inputs["thresh"].get(name)

    def f(lg):
        last = lg.transpose(0, 2, 3, 1)
        if name == "ohem_cf":
            return johem.ohem_cross_entropy_channels_first(
                lg, lab, n_min, thresh, -1)
        if name == "ohem_last":
            return johem.ohem_cross_entropy(last, lab, n_min, thresh, -1)
        if name == "ce":
            ce = johem.per_pixel_ce_channels_first(lg, lab, -1)
            return jnp.sum(ce) / jnp.maximum(jnp.sum(lab != -1), 1)
        if name == "dice":
            return jtrain.dice_loss(last, lab, NC)
        return jtrain.bce_loss(last, lab, NC, inputs["bce_ignore"])
    value, grad = jax.value_and_grad(f)(jnp.asarray(inputs["logits_cf"]))
    return float(value), np.asarray(grad)


@pytest.mark.parametrize("name", ["ohem_cf", "ohem_last", "ce", "dice",
                                  "bce"])
def test_step_losses_are_global(world, name):
    """Each loss of the stage-1 step on logits, under the group, against
    the JAX loss on the global batch (OHEM channels first at its threshold
    branch, classes last at its top-k branch, CE's valid count, dice's
    sums, BCE's per-class means with an ignored class): value and
    gradient; normalised per rank (the planted fault) each misses."""
    inputs, outs = world
    want, jgrad = _jax_loss(name, inputs)
    vals = [o[f"{name}_True"][0] for o in outs]
    assert vals[0] == vals[1]
    assert _close(vals[0], [o[f"{name}_True"][1] for o in outs], want,
                  jgrad)
    for o in outs:
        assert abs(o[f"{name}_False"][0] - want) > 10 * VAL_TOL * abs(want)


def test_only_rank_0_writes_checkpoints_and_every_rank_reads_them(world):
    _, outs = world
    assert [o["ckpt"][0] for o in outs] == [1, 0]
    for o in outs:
        np.testing.assert_array_equal(o["ckpt"][1], [0.0, 0.0])


def test_shard_batch_cuts_what_the_loader_gives_each_rank():
    class _Ids:
        def __len__(self):
            return 16

        def get(self, i, rng):
            return {"i": np.asarray(i)}
    full = next(Loader(_Ids(), 8, seed=3, num_workers=1).epoch(0))["i"]
    for r in range(W):
        got = next(Loader(_Ids(), 8, seed=3, num_workers=1, shard_index=r,
                          num_shards=W).epoch(0))["i"]
        np.testing.assert_array_equal(
            parallel.shard_batch({"i": full}, r, W)["i"], got)
    with pytest.raises(ValueError):
        parallel.shard_batch(np.zeros(3), 0, 2)


def _torchrun_env(monkeypatch, world, local_world):
    for k, v in dict(RANK="0", WORLD_SIZE=str(world), LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE=str(local_world)).items():
        monkeypatch.setenv(k, v)


def test_contrast_lr_scales_by_hosts_not_ranks(monkeypatch):
    """Step 0 (b): two ranks on one host get the one-process LR, as the
    JAX package scales by `jax.process_count()`; two hosts of two double
    it."""
    cfg = ContrastTrainConfig(data=DataConfig(batch_size=16))
    one = contrast_lr(cfg)
    assert parallel.host_count() == 1
    _torchrun_env(monkeypatch, 2, 2)
    assert parallel.host_count() == 1 and contrast_lr(cfg) == one
    _torchrun_env(monkeypatch, 4, 2)
    assert parallel.host_count() == 2 and contrast_lr(cfg) == 2 * one


def test_single_process_needs_no_group():
    """Without a launcher nothing joins a group, and every collective is
    the identity."""
    assert parallel.initialize_distributed("cpu") == torch.device("cpu")
    assert not parallel.initialized()
    x = torch.arange(3.0)
    for fn in (parallel.reduce_sum, parallel.reduce_mean,
               parallel.dist_collect, parallel.broadcast):
        assert torch.equal(fn(x), x)
    model = torch.nn.Linear(2, 2)
    assert parallel.data_parallel(model, "cpu") is model
    assert parallel.max_param_difference(model) == 0.0


def test_the_group_waits_out_rank_0s_evaluation(monkeypatch):
    """The group is made with a collective timeout that covers rank 0's
    evaluation, during which the other ranks wait in a broadcast: an hour
    (NCCL's default is 10 minutes), or what `STSWIN_DIST_TIMEOUT` says."""
    made = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: made.append(k))
    _torchrun_env(monkeypatch, 2, 2)
    monkeypatch.delenv("STSWIN_DIST_TIMEOUT", raising=False)
    parallel.initialize_distributed("cpu")
    monkeypatch.setenv("STSWIN_DIST_TIMEOUT", "7200")
    parallel.initialize_distributed("cpu")
    assert [k["timeout"] for k in made] == [datetime.timedelta(hours=1),
                                            datetime.timedelta(hours=2)]
    assert not parallel.initialized()


def test_cli_test_refuses_ranks(monkeypatch, capsys):
    _torchrun_env(monkeypatch, 2, 2)
    with pytest.raises(SystemExit, match="one process"):
        cli.main(["test", "--device", "cpu"])


class _StubLibrary:
    """The kernel library's device entry and one launch entry, recording
    the calling thread and the device each call saw."""

    def __init__(self):
        self.device = {}  # thread -> the runtime's current device
        self.set_calls, self.launches = [], []

    def stswin_set_device(self, index):
        self.set_calls.append((threading.get_ident(), index))
        self.device[threading.get_ident()] = index
        return 0

    def stswin_fake(self, *args):
        self.launches.append((threading.get_ident(),
                              self.device.get(threading.get_ident(), 0)))
        return 0

    def stswin_whole_block_slots(self, T, C, heads, ws, out):
        out._obj.value = 100 + self.device.get(threading.get_ident(), 0)
        return 0


@pytest.fixture
def stub_library(monkeypatch):
    stub = _StubLibrary()
    monkeypatch.setattr(kernels, "load", lambda verbose=False: stub)
    monkeypatch.setattr(kernels, "_thread", threading.local())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    return stub


def test_launch_follows_the_device_per_thread(stub_library):
    """Step 0 (a): `kernels.launch` sets the library runtime's device
    whenever the tensors' device differs from the one last set on the
    calling thread, and each thread keeps its own (autograd's device
    threads start at 0); nothing refuses a device other than cuda:0."""
    stub = stub_library
    main = threading.get_ident()
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    kernels.launch("stswin_fake", d1, 1, 2)
    kernels.launch("stswin_fake", d1, 3)
    kernels.launch("stswin_fake", d0)
    worker = []

    def on_thread():
        worker.append(threading.get_ident())
        kernels.launch("stswin_fake", d1)
        kernels.launch("stswin_fake", d1)
    t = threading.Thread(target=on_thread)
    t.start()
    t.join()
    assert stub.set_calls == [(main, 1), (main, 0), (worker[0], 1)]
    assert stub.launches == [(main, 1), (main, 1), (main, 0),
                             (worker[0], 1), (worker[0], 1)]


def test_launch_raises_when_the_device_cannot_be_set(stub_library,
                                                     monkeypatch):
    monkeypatch.setattr(stub_library, "stswin_set_device", lambda i: 101)
    with pytest.raises(RuntimeError, match="stswin_set_device"):
        kernels.launch("stswin_fake", torch.device("cuda", 3))


def test_whole_block_slots_are_asked_of_each_device(stub_library):
    """Row 16's workspace slots come from the occupancy of the card they
    launch on, cached per device."""
    swin_block._slots.cache_clear()
    try:
        assert swin_block._slots(4, 512, 4, 8, 1) == 101
        assert swin_block._slots(4, 512, 4, 8, 0) == 100
        assert swin_block._slots(4, 512, 4, 8, 1) == 101
    finally:
        swin_block._slots.cache_clear()


# Stage 2 through its entry point (2 LARS steps): the two-rank run's
# parameters and statistics lie within 1e-5 + 1e-4 relative of the
# one-process run's, elementwise: the runs share every formula and differ
# in the order of their fp32 sums.
PIPE_RTOL, PIPE_ATOL = 1e-4, 1e-5
PIPE_HW = (64, 128)
PIPE_MODEL = dict(num_classes=NC, swin_dim=64, swin_depths=(1, 1),
                  dtype="float32")


def test_run_contrast_pretraining_over_two_ranks(tmp_path):
    """One epoch (32 samples at batch 16: 2 steps) on two ranks against
    one process: the same LR schedule (one host), equal ranks, and the
    one-process run's query and key weights and statistics."""
    kw = dict(data=dict(dataset="synthetic", crop_hw=PIPE_HW, batch_size=16,
                        num_classes=NC, num_workers=2),
              model=PIPE_MODEL, num_epochs=1)
    one_kw = dict(kw, ckpt_dir=f"{tmp_path}/one", log_dir=f"{tmp_path}/l1")
    cfg = ContrastTrainConfig(data=DataConfig(**kw["data"]),
                              model=ModelConfig(**PIPE_MODEL), num_epochs=1,
                              ckpt_dir=one_kw["ckpt_dir"],
                              log_dir=one_kw["log_dir"])
    state = run_contrast_pretraining(cfg, device="cpu")
    outs = ranks.run_world(ranks.contrast_pipeline, dict(
        kw, ckpt_dir=f"{tmp_path}/two", log_dir=f"{tmp_path}/l2"))
    lr = [state.opt.schedule(k) for k in range(4)]
    for o in outs:
        assert o["step"] == state.step == 2
        assert o["lr"] == lr
    for branch in ("query", "key"):
        for k in outs[0][branch]:
            np.testing.assert_array_equal(outs[0][branch][k],
                                          outs[1][branch][k], err_msg=k)
        for k, v in getattr(state, branch).state_dict().items():
            np.testing.assert_allclose(outs[0][branch][k], v.numpy(),
                                       rtol=PIPE_RTOL, atol=PIPE_ATOL,
                                       err_msg=k)
    assert load_checkpoint(f"{tmp_path}/two")["step"] == 2
