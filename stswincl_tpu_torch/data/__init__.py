"""Data of the port: the segmentation datasets (`endovis18`, `cadis`),
clip augmentations (`transforms`), the six-view contrastive sampler
(`contrastive`), the loader and the synthetic datasets (`loader`)."""
