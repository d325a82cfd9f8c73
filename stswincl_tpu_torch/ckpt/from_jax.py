"""JAX variables -> the port's `state_dict`.

Counterpart of `stswincl_tpu/ckpt/torch_import.py`, in the other
direction. A JAX `{"params", "batch_stats"}` tree of arrays (any nesting
of mappings; numpy or JAX arrays) maps leaf for leaf onto the port's
parameter names, which follow the JAX tree paths:

  params/<path>/kernel (4-D, HWIO)  -> <path>.weight (OIHW)
  params/<path>/kernel (2-D, (I, O)) -> <path>.weight (O, I)
  params/<path>/scale               -> <path>.weight
  params/<path>/bias                -> <path>.bias
  params/<path>/relative_position_bias_table -> same name
  batch_stats/<path>/mean, var      -> <path>.running_mean, running_var

`jax_path` and `to_jax_layout` run the map backwards (port name -> JAX
tree path and layout), so gradients, updated parameters and batch
statistics of the two packages compare leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "relative_position_bias_table"):
        "relative_position_bias_table",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


_PORT_LEAF = {"bias": "bias",
              "relative_position_bias_table": "relative_position_bias_table",
              "running_mean": "mean", "running_var": "var"}


def jax_path(name: str, ndim: int) -> Tuple[str, Tuple[str, ...]]:
    """Port parameter / buffer name (and its rank) -> (collection, JAX tree
    path): `a.b.weight` of rank 2 or 4 -> ("params", ("a", "b", "kernel")),
    of rank 1 -> (..., "scale"); running stats -> "batch_stats"."""
    *mod, leaf = name.split(".")
    if leaf == "weight":
        jleaf = "kernel" if ndim in (2, 4) else "scale"
    else:
        jleaf = _PORT_LEAF[leaf]
    coll = "batch_stats" if leaf.startswith("running_") else "params"
    return coll, tuple(mod) + (jleaf,)


def to_jax_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """A port tensor (as numpy) in the JAX leaf's layout: OIHW -> HWIO,
    (out, in) -> (in, out); everything else unchanged."""
    if name.endswith(".weight") and arr.ndim == 4:
        return arr.transpose(2, 3, 1, 0)
    if name.endswith(".weight") and arr.ndim == 2:
        return arr.T
    return arr


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(variables: Mapping, model: nn.Module
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Convert JAX `variables` for `model`. Returns (state_dict, unmatched)
    where `unmatched` lists the JAX leaves ("coll/path/leaf") that have no
    port parameter of the converted shape."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unmatched: List[str] = []
    for coll, tree in variables.items():
        for path, leaf in _walk(tree):
            name = _LEAF.get((coll, path[-1]))
            key = ".".join(path[:-1] + (name,)) if name else None
            arr = np.array(leaf, dtype=np.float32)  # a writable copy
            if path[-1] == "kernel":
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                       else arr.T)
            if key not in target or tuple(target[key].shape) != arr.shape:
                unmatched.append("/".join((coll,) + path))
                continue
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out, unmatched


def load_from_jax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load JAX `variables` into `model` in place. Raises if a JAX leaf
    is left over or a port parameter is not covered."""
    sd, unmatched = state_dict_from_jax(variables, model)
    missing = sorted(set(model.state_dict()) - set(sd))
    if unmatched or missing:
        raise ValueError(f"JAX leaves without a port parameter: "
                         f"{unmatched[:10]}; port parameters not covered: "
                         f"{missing[:10]}")
    model.load_state_dict(sd, strict=True)
    return model
