"""One fp32 stage-1 train step on the 'pallas' route (Pallas row 10) and
with `whole_block` (row 16), on the CPU, against the JAX package's fp32
`make_seg_train_step` on the same route, routed as on its TPU with its
Pallas kernels interpreted (`jax_routes` of test_torch_fp32_routes.py),
from the same seeded weights and batch. The port's model has
`kernels=None`: on the CPU its Functions run their twins, the functions
the card's fp32 forms are held to; row 10's backward is autograd of its
twin and row 16's the K1 + K2 pair's, as in the JAX package. The bounds
are those of `test_fp32_stage1_step_matches_jax_tpu_routing`
(test_torch_fp32_train.py): the loss to 1e-5, every gradient to 1e-2
plus 1e-6 plus 8x the port's own spread on clips perturbed by 1e-7, the
BatchNorm statistics to 1e-4, the parameters after one Adam step."""

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from stswincl_tpu.models import TswinPlus as JTswinPlus  # noqa: E402
from stswincl_tpu_torch.configs import ModelConfig  # noqa: E402
from test_torch_fp32 import jax_tpu_interpreted  # noqa: E402,F401
from test_torch_fp32_routes import (ROUTES, fp32_route_model,  # noqa: E402
                                    jax_routes)  # noqa: F401
from test_torch_fp32_train import (MODEL, NC,  # noqa: E402
                                   check_fp32_stage1_step)

torch.set_num_threads(1)

# the JAX kernels a train step reaches on each route: its forward kernels
# (their custom VJPs differentiate the XLA references); no resize + argmax
TRAIN_KERNELS = {
    "pallas": {"windowed_attention_image", "fused_swin_block_epilogue",
               "fused_patch_merge"},
    "whole_block": {"fused_whole_swin_block", "fused_swin_block_attention",
                    "fused_swin_block_epilogue_shifted",
                    "fused_patch_merge"},
}


@pytest.mark.parametrize("route", sorted(TRAIN_KERNELS))
def test_fp32_route_step_matches_jax_tpu_routing(jax_routes, route):
    """The port's fp32 model on `route` (`build_model(attn_impl="pallas")`,
    or `TswinPlus(whole_block=True)`) takes one stage-1 step as the JAX
    fp32 model on that route does, the route's JAX kernels reached."""
    jax_kw = {k: v for k, v in ROUTES[route][0].items() if k == "attn_impl"}
    check_fp32_stage1_step(
        jax_routes, ModelConfig(num_classes=NC, dtype="float32", **jax_kw,
                                **MODEL),
        JTswinPlus(num_classes=NC, **jax_kw, **MODEL), TRAIN_KERNELS[route],
        make=lambda: fp32_route_model(route))
