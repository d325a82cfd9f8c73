"""Rank bodies of `tests/test_torch_parallel*.py`.

`run_world(fn, *args)` spawns two processes that join one gloo group on
the CPU through `parallel.initialize_distributed` (torchrun's variables
set by hand), runs `fn(rank, world, *args)` in each and returns what each
returned, rank by rank. Only this module and the port are imported in the
ranks: JAX stays in the test process, which computes the references.
"""

import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, out_dir, fn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from stswincl_tpu_torch.parallel import initialize_distributed, shutdown
    initialize_distributed("cpu")
    try:
        out = fn(rank, world, *args)
    finally:
        shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(fn, *args, world: int = WORLD, timeout: float = 300.0):
    """[fn(0, world, *args), ..., fn(world - 1, world, *args)], each run in
    its own gloo rank on the CPU. A rank that fails fails the call (the
    others are stopped); ranks still running after `timeout` seconds are
    killed and the call raises, so a hung collective cannot hang the
    suite."""
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_entry, args=(world, _free_port(), d, fn,
                                               args),
                                 nprocs=world, start_method="spawn",
                                 join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {timeout} s")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def shard(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _np(t):
    return t.detach().numpy().copy()


# ---- collectives, BatchNorm and the losses ----------------------------------

def reductions(rank, world, inputs):
    """Each reduction of the port on this rank's shard of `inputs`' global
    arrays: synced and (the planted fault) local."""
    import torch.distributed as dist
    from stswincl_tpu_torch.models.norm import BatchNorm
    from stswincl_tpu_torch.ops import ohem
    from stswincl_tpu_torch.parallel import (collectives,
                                             data_parallel, sync_batchnorm)
    from stswincl_tpu_torch.train import train_seg
    T = lambda a: torch.from_numpy(shard(a, rank, world).copy())  # noqa
    group = dist.group.WORLD
    out = {}

    x = T(inputs["x"]).requires_grad_()
    w = torch.from_numpy(inputs["w"])
    gathered = collectives.dist_collect(x)
    (gathered * w).sum().backward()
    out["collect"], out["collect_grad"] = _np(gathered), _np(x.grad)
    out["sum"] = _np(collectives.reduce_sum(x.detach()))
    out["mean"] = _np(collectives.reduce_mean(x.detach()))
    mean, var = collectives.cross_replica_batch_norm_stats(x.detach())
    out["bn_stats"] = (_np(mean), _np(var))

    for sync in (True, False):
        bn = BatchNorm(inputs["bn_x"].shape[-1])
        bn.load_state_dict({k: torch.from_numpy(v)
                            for k, v in inputs["bn_state"].items()})
        if sync:
            sync_batchnorm(bn)
        xb = T(inputs["bn_x"]).requires_grad_()
        y = bn.train()(xb)
        (y * T(inputs["bn_g"])).sum().backward()
        out[f"bn_{sync}"] = dict(
            y=_np(y), dx=_np(xb.grad), dweight=_np(bn.weight.grad),
            dbias=_np(bn.bias.grad), mean=_np(bn.running_mean),
            var=_np(bn.running_var))
    # a synced BatchNorm inside a DDP wrap: its buffers move alike, so
    # DDP need not broadcast them
    bn = sync_batchnorm(BatchNorm(inputs["bn_x"].shape[-1]))
    ddp = data_parallel(bn, "cpu")
    ddp.train()(T(inputs["bn_x"])).sum().backward()
    out["ddp_buffers"] = (_np(bn.running_mean), _np(bn.running_var))
    out["ddp_broadcasts_buffers"] = ddp.broadcast_buffers

    for case, (loss, n_min, thresh) in inputs["ohem"].items():
        for g in (group, None):
            v = T(loss).requires_grad_()
            got = ohem._ohem_select(v, n_min, thresh, g)
            got.backward()
            out[f"ohem_{case}_{g is not None}"] = (float(got), _np(v.grad))

    logits_cf, labels = inputs["logits_cf"], inputs["labels"]
    n_min, thresh = inputs["n_min"], inputs["thresh"]
    for name in ("ohem_cf", "ohem_last", "ce", "dice", "bce"):
        for g in (group, None):
            lg = T(logits_cf).requires_grad_()
            lab = T(labels).long()
            last = lg.permute(0, 2, 3, 1)
            if name == "ohem_cf":
                got = ohem.ohem_cross_entropy_channels_first(
                    lg, lab, n_min, thresh[name], -1, g)
            elif name == "ohem_last":
                got = ohem.ohem_cross_entropy(last, lab, n_min,
                                              thresh[name], -1, g)
            elif name == "ce":
                got = train_seg.cross_entropy_loss(lg, lab, -1, g)
            elif name == "dice":
                got = train_seg.dice_loss(last, lab, lg.shape[1], g)
            else:
                got = train_seg.bce_loss(last, lab, lg.shape[1],
                                         inputs["bce_ignore"], g)
            got.backward()
            out[f"{name}_{g is not None}"] = (float(got), _np(lg.grad))

    # checkpoints: rank 0 writes, every rank reads after the barrier
    from stswincl_tpu_torch.ckpt import checkpoint
    saves, real_save = [], torch.save

    def counting_save(obj, f, *a, **k):
        saves.append(str(f))
        return real_save(obj, f, *a, **k)
    torch.save = counting_save
    try:
        checkpoint.save_checkpoint(inputs["ckpt_dir"], 3, {
            "w": torch.full((2,), float(rank))})
    finally:
        torch.save = real_save
    out["ckpt"] = (len(saves), _np(
        checkpoint.load_checkpoint(inputs["ckpt_dir"])["w"]))
    return out


# ---- one train step of stage 1 and of stage 2 -------------------------------

def unreduced_on_rank_1(state, bucket):
    """A DDP comm hook with a planted fault: every rank joins the
    all-reduce, but rank 1 keeps its own, unreduced gradient."""
    import torch.distributed as dist
    buf = bucket.buffer()
    local = buf.clone()
    world = dist.get_world_size()
    fut = dist.all_reduce(buf, async_op=True).get_future()
    return fut.then(lambda f: local if dist.get_rank() == 1
                    else f.value()[0].div_(world))


def _grads_at_step(opt, named):
    """The gradients the optimizer steps on (after DDP's reduce)."""
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.numpy().copy() for n, p in named}))
    return grads


def seg_steps(rank, world, spec):
    """One stage-1 step of a small TswinPlus for each of spec["variants"]
    ((loss_type, ohem_thresh, fault)) from the same weights, on this
    rank's shard of the global batch. "remat" is sound: the swin blocks
    recomputed in the backward (non-reentrant checkpoints under DDP).
    Faults: "bn_local" (no sync_batchnorm), "loss_local" (the losses
    reduce nothing), "unreduced" (rank 1's gradient not reduced)."""
    from stswincl_tpu_torch.configs import SegTrainConfig
    from stswincl_tpu_torch.models import TswinPlus
    from stswincl_tpu_torch.parallel import (data_parallel,
                                             max_param_difference,
                                             sync_batchnorm)
    from stswincl_tpu_torch.pipelines.seg import make_tx
    from stswincl_tpu_torch.train import train_seg
    images = torch.from_numpy(shard(spec["images"], rank, world).copy())
    labels = torch.from_numpy(shard(spec["labels"], rank, world)).long()

    def model(remat=False):
        m = TswinPlus(spec["num_classes"], **spec["model"], remat=remat)
        m.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state"].items()})
        return m

    out = {}
    try:  # Step 0 (d): an unwrapped model under a group of two refuses
        train_seg.make_seg_train_step(model(), None)
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    for loss_type, thresh, fault in spec["variants"]:
        m = model(remat=fault == "remat")
        if fault != "bn_local":
            sync_batchnorm(m)
        ddp = data_parallel(m, "cpu")
        if fault == "unreduced":
            ddp.register_comm_hook(None, unreduced_on_rank_1)
        opt, schedule = make_tx(SegTrainConfig(), 10, m)
        step = train_seg.make_seg_train_step(ddp, opt, schedule, loss_type,
                                             ohem_thresh=thresh)
        if fault == "loss_local":
            step.group = None
        grads = _grads_at_step(opt, list(m.named_parameters()))
        metrics = step(images, labels)
        out[(loss_type, thresh, fault)] = dict(
            loss=float(metrics["loss"]),
            grad_norm=float(metrics["grad_norm"]), grads=grads,
            state={k: _np(v) for k, v in m.state_dict().items()},
            parted=max_param_difference(m))
    return out


def contrast_steps(rank, world, spec):
    """One stage-2 step for each of spec["variants"] ((ins_loss_weight,
    fault)) from the same query and key weights, on this rank's shard.
    Fault "key_local": the key encoder's BatchNorms not synced."""
    from stswincl_tpu_torch.models import ContrastEncoder
    from stswincl_tpu_torch.parallel import (data_parallel,
                                             max_param_difference, replicate,
                                             sync_batchnorm)
    from stswincl_tpu_torch.train import optim
    from stswincl_tpu_torch.train import train_contrast as tc
    clips = torch.from_numpy(shard(spec["clips"], rank, world).copy())
    labels = torch.from_numpy(shard(spec["labels"], rank, world)).long()
    out = {}
    for ins, fault in spec["variants"]:
        def enc(which):
            m = ContrastEncoder(spec["num_classes"], with_instance=ins > 0,
                                **spec["model"])
            m.load_state_dict({k: torch.from_numpy(v) for k, v
                               in spec[which][ins > 0].items()})
            return m
        query, key = enc("query"), enc("key")
        key.requires_grad_(False)
        opt = optim.make_lars(query.parameters(), optim.warmup_cosine_schedule(
            *spec["schedule"]))
        state = tc.ContrastTrainState(query, key, opt)
        sync_batchnorm(query)
        if fault != "key_local":
            sync_batchnorm(key)
        replicate(key)
        step = tc.make_contrast_train_step(
            state, spec["num_classes"], spec["schedule"][2],
            ins_loss_weight=ins, query=data_parallel(query, "cpu"))
        grads = _grads_at_step(opt, list(query.named_parameters()))
        metrics = step(clips, labels)
        out[(ins, fault)] = dict(
            metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
            query={k: _np(v) for k, v in query.state_dict().items()},
            key={k: _np(v) for k, v in key.state_dict().items()},
            parted=max_param_difference(query) + max_param_difference(key))
    return out


# ---- the entry points ---------------------------------------------------------

def seg_pipeline(rank, world, cfgs, bn_local=False):
    """`run_seg_training(device="cpu")` for each config of `cfgs` (kwargs of
    `SegTrainConfig` and its data and model configs) in turn, recording
    this rank's model at each checkpoint and its evaluations. With
    `bn_local` (a planted fault) the pipeline's BatchNorms stay unsynced."""
    from stswincl_tpu_torch.configs import (DataConfig, ModelConfig,
                                            SegTrainConfig)
    from stswincl_tpu_torch.pipelines import seg
    if bn_local:
        seg.sync_batchnorm = lambda model, group=None: model
    rec = {"saved": [], "evaluated": 0, "best": []}
    real_save, real_eval = seg.save_checkpoint, seg.evaluate_split

    def recording_save(ckpt_dir, step, state):
        rec["saved"].append((ckpt_dir, step, {
            k: _np(v) for k, v in state["model"].items()}))
        return real_save(ckpt_dir, step, state)

    def counting_eval(*a, **k):
        rec["evaluated"] += 1
        return real_eval(*a, **k)
    seg.save_checkpoint, seg.evaluate_split = recording_save, counting_eval
    for kw in cfgs:
        kw = dict(kw)
        cfg = SegTrainConfig(data=DataConfig(**kw.pop("data")),
                             model=ModelConfig(**kw.pop("model")), **kw)
        rec["best"].append(seg.run_seg_training(cfg, device="cpu"))
    return rec


def contrast_pipeline(rank, world, kw):
    """`run_contrast_pretraining(device="cpu")`: the final state and the
    LR schedule it ran on."""
    from stswincl_tpu_torch.configs import (ContrastTrainConfig, DataConfig,
                                            ModelConfig)
    from stswincl_tpu_torch.pipelines.contrast import run_contrast_pretraining
    kw = dict(kw)
    cfg = ContrastTrainConfig(data=DataConfig(**kw.pop("data")),
                              model=ModelConfig(**kw.pop("model")), **kw)
    state = run_contrast_pretraining(cfg, device="cpu")
    return dict(step=state.step, lr=[state.opt.schedule(k) for k in range(4)],
                query={k: _np(v) for k, v in state.query.state_dict().items()},
                key={k: _np(v) for k, v in state.key.state_dict().items()})
