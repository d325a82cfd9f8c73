"""Data of the port: the CaDIS tables (`cadis`), clip augmentations
(`transforms`), the six-view contrastive sampler (`contrastive`), the
loader and the synthetic datasets (`loader`). The segmentation datasets
are not ported yet."""
