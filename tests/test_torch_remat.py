"""`remat` (`TswinPlus(remat=True)`, `model.remat=true`) on the CPU at a
small size (swin_dim 64, depths (2, 3), 128x128 clips, fp32; at depths
(2, 2) the last stage-2 layer feeds no output): each swin
block call under grad runs under a non-reentrant `torch.utils.checkpoint`
and is recomputed once in the backward, while the patch merge is not.
The recompute runs the same twins on the same input, so the loss and
every gradient equal those without remat bit for bit on each `attn_impl`
route and with `whole_block` (the kernel routes through their autograd
Functions' CPU twins); every swin parameter gets a non-zero gradient (the
working copies stay casts in the graph). A stage-1 step with remat
matches the JAX `TswinPlus(remat=True)` step to the bounds of
`test_torch_train.py`, and eval and `no_grad` forwards are unchanged."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from stswincl_tpu_torch.configs import DataConfig, ModelConfig  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.init import init_weights  # noqa: E402
from stswincl_tpu_torch.models.swin import (PatchMerging,  # noqa: E402
                                            SpaceTimeSwinBlock)
from stswincl_tpu_torch.pipelines.common import build_model  # noqa: E402
from stswincl_tpu_torch.train.train_seg import SegTrainStep  # noqa: E402
from tests.test_torch_train import (HW, NC, _batch,  # noqa: E402
                                    check_train_step_matches_jax)

torch.set_num_threads(2)

# (attn_impl, whole_block, kernels): the kernel routes through their
# autograd Functions (the twins on the CPU), 'einsum' has no kernel
ROUTES = [("pallas_full", False, True), ("pallas", False, True),
          ("pallas_windows", False, True), ("einsum", False, False),
          ("pallas_full", True, True)]


def _model(remat, route="pallas_full", whole_block=False, kernels=True):
    model = TswinPlus(NC, swin_dim=64, swin_depths=(2, 3), input_hw=HW,
                      attn_impl=route, whole_block=whole_block,
                      kernels=kernels, remat=remat)
    return init_weights(model, torch.Generator().manual_seed(0))


class _Calls:
    """Counts the block computations (`SpaceTimeSwinBlock.block`, the
    forward and each recompute) and the patch merges of a model."""

    def __init__(self, monkeypatch):
        self.block = self.merge = 0
        real_block, real_merge = (SpaceTimeSwinBlock.block,
                                  PatchMerging.forward)

        def block(mod, *a, **k):
            self.block += 1
            return real_block(mod, *a, **k)

        def merge(mod, *a, **k):
            self.merge += 1
            return real_merge(mod, *a, **k)
        monkeypatch.setattr(SpaceTimeSwinBlock, "block", block)
        monkeypatch.setattr(PatchMerging, "forward", merge)


def _loss_and_grads(model, calls):
    images, labels = _batch()
    model.train()
    loss = SegTrainStep(model, opt=None).loss(torch.from_numpy(images),
                                              torch.from_numpy(labels).long())
    forward = (calls.block, calls.merge)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, forward, (calls.block, calls.merge)


@pytest.mark.parametrize("route,whole_block,kernels", ROUTES)
def test_remat_gives_the_same_loss_and_gradients(monkeypatch, route,
                                                 whole_block, kernels):
    """Bit for bit, and each block computed once more in the backward."""
    calls = _Calls(monkeypatch)
    loss0, grads0, fwd0, end0 = _loss_and_grads(
        _model(False, route, whole_block, kernels), calls)
    calls.block = calls.merge = 0
    loss1, grads1, fwd1, end1 = _loss_and_grads(
        _model(True, route, whole_block, kernels), calls)
    assert torch.equal(loss0, loss1)
    assert sorted(grads0) == sorted(grads1)
    for n, g in grads0.items():
        assert g is not None and grads1[n] is not None, n
        assert torch.equal(g, grads1[n]), n
    swin = [n for n in grads1 if n.startswith("swin.layers_")]
    assert len(swin) > 0
    for n in swin:
        assert grads1[n].abs().sum() > 0, n
    # without remat the backward computes no block; with it each block
    # call's forward runs again, the patch merge once
    n_blocks = fwd0[0]
    assert n_blocks > 0 and fwd0 == end0 == fwd1 == (n_blocks, 1)
    assert end1 == (2 * n_blocks, 1)


@pytest.mark.parametrize("mode", ["eval", "no_grad"])
def test_remat_changes_nothing_without_grad(monkeypatch, mode):
    calls = _Calls(monkeypatch)
    images = torch.from_numpy(_batch()[0])
    outs = []
    for remat in (False, True):
        model = _model(remat)
        calls.block = 0
        if mode == "eval":
            model.eval()
            with torch.no_grad():
                outs.append((model(images), calls.block))
        else:
            model.train()
            with torch.no_grad():
                outs.append((model(images, channels_first_logits=True),
                             calls.block))
    (a, na), (b, nb) = outs
    assert torch.equal(a, b) and na == nb > 0


def test_build_model_passes_remat():
    data_cfg = DataConfig(dataset="synthetic", crop_hw=HW)
    for remat in (False, True):
        model_cfg = ModelConfig(num_classes=NC, swin_dim=64,
                                swin_depths=(2, 2), remat=remat)
        model, _ = build_model(model_cfg, data_cfg, device="cpu")
        blocks = [m for m in model.modules()
                  if isinstance(m, SpaceTimeSwinBlock)]
        assert len(blocks) == 8 and all(b.remat == remat for b in blocks)


def test_remat_train_step_matches_jax():
    """The port with remat against the JAX `TswinPlus(remat=True)` step
    (its CPU route 'einsum'), to the bounds of `test_torch_train.py`."""
    check_train_step_matches_jax(remat=True, jax_kw={"remat": True})


def test_kernel_functions_run_twice_a_block_with_remat(monkeypatch):
    """At depths (3, 3) a train step makes 14 swin block calls and one
    patch merge. With remat the forwards of K1's and K2's autograd
    Functions (the twins here, the kernels on the card) run twice a
    block call, the second time in the backward; K3's once: the launch
    counts that `chip_smoke.py` phase 10 (c) holds on the card."""
    from stswincl_tpu_torch.ops import add_ln_mlp, block_attention, patch_merge
    counts = {}
    for key, fn in (("K1", block_attention.BlockAttentionFn),
                    ("K2", add_ln_mlp.EpilogueFn),
                    ("K3", patch_merge.PatchMergeFn)):
        def counted(*a, _real=fn.forward, _key=key, **k):
            counts[_key] = counts.get(_key, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(fn, "forward", staticmethod(counted))
    images, labels = _batch()
    for remat in (False, True):
        counts.clear()
        model = init_weights(TswinPlus(NC, swin_dim=32, swin_depths=(3, 3),
                                       input_hw=HW, kernels=True,
                                       remat=remat),
                             torch.Generator().manual_seed(0)).train()
        loss = SegTrainStep(model, opt=None).loss(
            torch.from_numpy(images), torch.from_numpy(labels).long())
        forward = dict(counts)
        loss.backward()
        assert forward == {"K1": 14, "K2": 14, "K3": 1}
        assert counts == ({"K1": 28, "K2": 28, "K3": 1} if remat
                          else forward)
