"""The port's reference-checkpoint importer (`ckpt/torch_import.py`)
against the JAX package's, bit for bit: the `state_dict` of the test-only
reference replica `tests/torch_ref.py` (bare, with DataParallel's
`module.` prefix, and under the PixPro pretraining prefixes with momentum
twins and a projector), and torchvision-resnet18 keys built here, go
through the port's importer and through the JAX importer followed by
`ckpt/from_jax.state_dict_from_jax`: the same names, the same tensors to
the bit, the same unmatched keys. A port TswinPlus loaded this way gives
the replica's logits within the tolerance of
`tests/test_reference_parity.py` (1e-4), and a `.pth` file in the
pretraining format (with its `argparse.Namespace`) reads back through
`ckpt.torch_import.import_reference`."""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
import torch.nn as nn  # noqa: E402

from stswincl_tpu.ckpt import torch_import as jimport  # noqa: E402
from stswincl_tpu_torch.ckpt import state_dict_from_jax  # noqa: E402
from stswincl_tpu_torch.ckpt import torch_import as pimport  # noqa: E402
from stswincl_tpu_torch.models import TswinPlus  # noqa: E402
from stswincl_tpu_torch.models.pixpro import ProjHead  # noqa: E402
from stswincl_tpu_torch.models.resnet import ResNet18OS8  # noqa: E402
from tests.torch_ref import TResNetOS8, TTswinPlus  # noqa: E402

torch.set_num_threads(2)
H, W, NC = 128, 192, 12
LOGIT_TOL = 1e-4  # tests/test_reference_parity.py


def _randomise_bn(model):
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(torch.rand(mod.running_mean.shape,
                                                  generator=g) * 0.4 - 0.2)
                mod.running_var.copy_(torch.rand(mod.running_var.shape,
                                                 generator=g) * 0.6 + 0.7)
                mod.weight.copy_(torch.rand(mod.weight.shape,
                                            generator=g) + 0.5)
                mod.bias.copy_(torch.rand(mod.bias.shape, generator=g) - 0.5)
    return model


@pytest.fixture(scope="module")
def replica():
    torch.manual_seed(0)
    return _randomise_bn(TTswinPlus(NC, resolution=(H // 8, W // 8))).eval()


def _port_model(classifier=True):
    return TswinPlus(NC, input_hw=(H, W), classifier=classifier)


def _via_jax(jax_out, model):
    """The JAX importer's (params, batch_stats, unmatched) as the port's
    `state_dict` through `state_dict_from_jax`; every JAX leaf must land."""
    params, stats, unmatched = jax_out
    sd, left = state_dict_from_jax({"params": params, "batch_stats": stats},
                                   model)
    assert left == []
    return sd, unmatched


def _same(got, want):
    (gsd, gum), (wsd, wum) = got, want
    assert gum == wum
    assert sorted(gsd) == sorted(wsd)
    for k in gsd:
        assert gsd[k].dtype == wsd[k].dtype == torch.float32, k
        assert torch.equal(gsd[k], wsd[k]), k


@pytest.mark.parametrize("prefix", ["", "module."])
def test_tswinplus_import_matches_jax(replica, prefix):
    sd = {prefix + k: v for k, v in replica.state_dict().items()}
    sd[prefix + "aux_head.weight"] = torch.ones(3)  # unmatched
    got = pimport.import_tswinplus_state_dict(sd)
    want = _via_jax(jimport.import_tswinplus_state_dict(
        {k: v.numpy() for k, v in sd.items()}), _port_model())
    _same(got, want)
    assert got[1] == ["aux_head.weight"]
    assert sorted(got[0]) == sorted(_port_model().state_dict())


def _pixpro_state_dict(replica):
    """The replica's encoder under the PixPro pretraining prefixes, the
    momentum twins (other values), a projector, no classifier."""
    g = torch.Generator().manual_seed(9)
    prefix = {"resnet.": "pixpro.encoder_1.", "swin.": "pixpro.encoder_2.",
              "aspp.": "pixpro.encoder_3.", "project1.": "pixpro.proj1.",
              "project2.": "pixpro.proj2.", "project3.": "pixpro.proj3."}
    sd = {}
    for k, v in replica.state_dict().items():
        for src, dst in prefix.items():
            if k.startswith(src):
                sd[dst + k[len(src):]] = v
                momentum = dst.replace("encoder_", "encoder_k_").replace(
                    "proj", "proj_k_")
                sd[momentum + k[len(src):]] = v + 1.0
    for head in ("pixpro.projector.", "pixpro.projector_k."):
        for name, shape in (("linear1.weight", (512, 400, 1, 1)),
                            ("linear1.bias", (512,)),
                            ("bn1.weight", (512,)), ("bn1.bias", (512,)),
                            ("bn1.running_mean", (512,)),
                            ("bn1.running_var", (512,)),
                            ("linear2.weight", (256, 512, 1, 1)),
                            ("linear2.bias", (256,))):
            sd[head + name] = torch.rand(shape, generator=g)
        sd[head + "bn1.num_batches_tracked"] = torch.tensor(3)
    sd["pixpro.queue"] = torch.zeros(4)  # no encoder: unmatched
    return sd


@pytest.mark.parametrize("include_momentum", [False, True])
def test_pixpro_import_matches_jax(replica, include_momentum):
    sd = _pixpro_state_dict(replica)
    got = pimport.import_pixpro_state_dict(sd, include_momentum)
    holder = _port_model(classifier=False)
    holder.projector = ProjHead()
    want = _via_jax(jimport.import_pixpro_state_dict(
        {k: v.numpy() for k, v in sd.items()}, include_momentum), holder)
    _same(got, want)
    assert sorted(got[0]) == sorted(holder.state_dict())
    shift = 1.0 if include_momentum else 0.0
    torch.testing.assert_close(got[0]["resnet.stem.conv.weight"],
                               replica.resnet.resnet[0].weight + shift,
                               rtol=0, atol=0)


def test_torchvision_resnet18_import_matches_jax():
    torch.manual_seed(1)
    tm = _randomise_bn(TResNetOS8())
    sd = {}
    for k, v in tm.state_dict().items():
        for src, dst in (("resnet.0.", "conv1."), ("resnet.1.", "bn1."),
                         ("resnet.4.", "layer1."), ("resnet.5.", "layer2.")):
            if k.startswith(src):
                sd[dst + k[len(src):]] = v
    sd["layer3.0.conv1.weight"] = torch.zeros(2)  # skipped
    sd["fc.weight"] = torch.zeros(2)              # skipped
    sd["avgpool.extra"] = torch.zeros(2)          # unmatched
    got = pimport.import_torchvision_resnet18(sd)
    want = _via_jax(jimport.import_torchvision_resnet18(
        {k: v.numpy() for k, v in sd.items()}), ResNet18OS8())
    _same(got, want)
    assert got[1] == ["avgpool.extra"]
    assert "layer1_0.cb1.conv.weight" in got[0]
    assert not any(k.startswith(("layer4", "layer5")) for k in got[0])


def test_imported_model_gives_the_replicas_logits(replica, tmp_path):
    """The replica's weights through a pretraining-format `.pth` file and
    `import_reference` (query branch, no classifier), then its own
    classifier through the segmentation importer: the port's logits equal
    the replica's within 1e-4."""
    path = tmp_path / "ckpt_epoch_1.pth"
    torch.save({"model": _pixpro_state_dict(replica),
                "opt": argparse.Namespace(lr=1.0), "epoch": 1}, path)
    sd, unmatched = pimport.import_reference(str(path))
    assert unmatched == ["pixpro.queue"]
    head, _ = pimport.import_tswinplus_state_dict(
        {k: v for k, v in replica.state_dict().items()
         if k.startswith("classifier.")})
    model = _port_model()
    missing = model.load_state_dict({**sd, **head}, strict=False)
    assert missing.missing_keys == []
    assert all(k.startswith("projector.") for k in missing.unexpected_keys)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 4, H, W, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
        want = replica(torch.from_numpy(
            x.transpose(0, 1, 4, 2, 3)).contiguous()).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 2, 3, 1),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
