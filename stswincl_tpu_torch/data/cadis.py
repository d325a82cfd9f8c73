"""CaDIS class counts: the one table of `stswincl_tpu/data/cadis.py` that
the port needs (`pipelines/common.build_model`), copied so that the port
imports nothing of the JAX package."""

# class count per experiment tag INCLUDING the ignore class
CADIS_CLASS_NUM = {"1": 9, "2": 18, "3": 26}
