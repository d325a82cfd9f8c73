"""Training of the port: optimizers and schedules (`optim`), the
supervised segmentation step and its losses (`train_seg`)."""
