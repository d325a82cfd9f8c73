"""Data of the port: the segmentation datasets (`endovis18`, `cadis`),
clip augmentations (`transforms`, `rand_augment`), the six-view
contrastive sampler (`contrastive`), the loader and the synthetic datasets
(`loader`), and the raw EndoVis18 converter (`prepare_endovis`, run as a
module). The names below are the JAX package's exports."""

from stswincl_tpu_torch.data.cadis import (CADIS_CLASS_NUM, CadisDataset,
                                           remap_experiment)
from stswincl_tpu_torch.data.contrastive import ContrastiveClipDataset
from stswincl_tpu_torch.data.endovis18 import EndovisDataset
from stswincl_tpu_torch.data.loader import (Loader, SyntheticContrastDataset,
                                            SyntheticSegDataset)
from stswincl_tpu_torch.data.rand_augment import (ClipRandAugment,
                                                  RandAugment,
                                                  rand_augment_transform)

__all__ = ["CADIS_CLASS_NUM", "CadisDataset", "ClipRandAugment",
           "ContrastiveClipDataset", "EndovisDataset", "Loader",
           "RandAugment", "SyntheticContrastDataset", "SyntheticSegDataset",
           "rand_augment_transform", "remap_experiment"]
