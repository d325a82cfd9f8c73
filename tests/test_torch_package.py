"""The port stands alone: no module of `stswincl_tpu_torch/` (its
`parallel/` too), not `chip_smoke.py` and not the rank bodies of the
data-parallel tests (`tests/torch_parallel_ranks.py`) imports JAX, flax
or the JAX package; the port's copies
of the configs, of the CaDIS tables (class counts, video splits, the
experiment remapping), of the normalisation constants and of the
RandAugment tables equal the JAX package's; and `build_model` puts the model on the card unless asked
for the CPU."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import stswincl_tpu.configs as jconfigs
import stswincl_tpu.data.cadis as jcadis
import stswincl_tpu.data.contrastive as jcontrastive
import stswincl_tpu.data.endovis18 as jendovis
import stswincl_tpu.data.rand_augment as jrand_augment
import stswincl_tpu_torch.configs as pconfigs
import stswincl_tpu_torch.data.cadis as pcadis
import stswincl_tpu_torch.data.contrastive as pcontrastive
import stswincl_tpu_torch.data.endovis18 as pendovis
import stswincl_tpu_torch.data.rand_augment as prand_augment
from stswincl_tpu.data.cadis import CADIS_CLASS_NUM as J_CADIS
from stswincl_tpu_torch.data.cadis import CADIS_CLASS_NUM as P_CADIS
from stswincl_tpu_torch.pipelines.common import build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stswincl_tpu")
CONFIGS = ("DataConfig", "ModelConfig", "SegTrainConfig",
           "ContrastTrainConfig")


def _port_sources():
    return sorted((ROOT / "stswincl_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 30
    port = ROOT / "stswincl_tpu_torch"
    tools = port / "tools"
    assert {tools / "profile_swin_kernels.py",
            tools / "profile_conv_kernel.py",
            tools / "profile_contrast.py"} <= set(sources)
    assert {port / "cli.py", port / "data" / "endovis18.py",
            port / "data" / "cadis.py", port / "eval" / "__init__.py",
            port / "eval" / "metrics_endovis.py",
            port / "eval" / "metrics_cadis.py",
            port / "eval" / "visualization.py",
            port / "ckpt" / "torch_import.py",
            port / "pipelines" / "evaluate.py",
            port / "pipelines" / "seg.py",
            port / "data" / "rand_augment.py",
            port / "data" / "prepare_endovis.py",
            port / "utils" / "profiling.py",
            port / "models" / "resnet.py",
            port / "models" / "stswin.py",
            port / "parallel" / "__init__.py",
            port / "parallel" / "collectives.py",
            port / "parallel" / "distributed.py",
            port / "parallel" / "mesh.py"} <= set(sources)
    # the data-parallel tests' rank bodies run without JAX too
    sources.append(ROOT / "tests" / "torch_parallel_ranks.py")
    bad = [(str(p.relative_to(ROOT)), m) for p in sources
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copies_match(name):
    j, p = getattr(jconfigs, name), getattr(pconfigs, name)
    jf, pf = dataclasses.fields(j), dataclasses.fields(p)
    assert [(f.name, str(f.type)) for f in pf] == [
        (f.name, str(f.type)) for f in jf]
    assert dataclasses.asdict(p()) == dataclasses.asdict(j())
    assert pconfigs.to_json(p()) == jconfigs.to_json(j())


def test_config_helpers_match(tmp_path):
    overrides = ["lr=1e-3", "model.swin_depths=(2,2)", "data.crop_hw=(64,96)",
                 "model.gelu_exact=false", "loss=ce", "resume=1"]
    j = jconfigs.apply_overrides(jconfigs.SegTrainConfig(), overrides)
    p = pconfigs.apply_overrides(pconfigs.SegTrainConfig(), overrides)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    path = tmp_path / "cfg.json"
    path.write_text(pconfigs.to_json(p))
    loaded = pconfigs.load_config(pconfigs.SegTrainConfig, str(path))
    assert isinstance(loaded.model, pconfigs.ModelConfig)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(
        jconfigs.load_config(jconfigs.SegTrainConfig, str(path)))


def test_cadis_class_table_matches():
    assert P_CADIS == J_CADIS


def test_cadis_tables_match():
    for name in ("TRAIN_VIDEOS", "VAL_VIDEOS", "TEST_VIDEOS",
                 "VIDEO_SPLITS", "_REMAPPINGS"):
        assert getattr(pcadis, name) == getattr(jcadis, name), name
    for tag in J_CADIS:
        np.testing.assert_array_equal(pcadis._remap_lut(tag),
                                      jcadis._remap_lut(tag))


def test_endovis_tables_match():
    for name in ("TRAIN_SEQUENCES", "TRAIN_FRAMES", "TEST_FRAMES"):
        assert getattr(pendovis, name) == getattr(jendovis, name), name


@pytest.mark.parametrize("name", ["IMAGENET_MEAN", "IMAGENET_STD",
                                  "CENTERNET_MEAN", "CENTERNET_STD"])
def test_normalisation_constants_match(name):
    got, want = getattr(pcontrastive, name), getattr(jcontrastive, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pcadis.MEAN, jcadis.MEAN)
    np.testing.assert_array_equal(pcadis.STD, jcadis.STD)


def test_rand_augment_tables_match():
    """The op menu's names, both transform lists and weight set 0."""
    assert sorted(prand_augment.OPS) == sorted(jrand_augment.OPS)
    for name in ("RAND_TRANSFORMS", "RAND_TRANSFORMS_CMC",
                 "RAND_CHOICE_WEIGHTS_0", "MAX_LEVEL", "FILL", "LABEL_FILL"):
        assert getattr(prand_augment, name) == getattr(jrand_augment,
                                                       name), name
    assert sorted(prand_augment.GEOMETRIC_COEFFS) == sorted(
        jrand_augment.GEOMETRIC_COEFFS)


def test_build_model_runs_on_the_card_unless_asked_for_the_cpu():
    model_cfg = pconfigs.ModelConfig(num_classes=5, swin_dim=64,
                                     swin_depths=(1, 1))
    data_cfg = pconfigs.DataConfig(dataset="synthetic", crop_hw=(128, 128))
    cpu, _ = build_model(model_cfg, data_cfg, device="cpu")
    assert {p.device.type for p in cpu.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        card, _ = build_model(model_cfg, data_cfg)
        assert {p.device.type for p in card.parameters()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(model_cfg, data_cfg)
