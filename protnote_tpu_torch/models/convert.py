"""Weights into the port.

* :func:`from_jax_tree` turns the JAX package's train-state bundle (its
  pytrees as numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, ts)``)
  into the port's tensors.
* :func:`proteinfer_from_tf_pickle` reads the reference's TF1 ProteInfer
  pickle (``GO_model_weights*.pkl``), as the JAX package's loader of the same
  name does.

The port keeps the JAX tree structure and names.  Linear kernels stay
``(in, out)``; conv kernels are the one layout change, from JAX's
``(k, cin, cout)`` to torch's ``(cout, cin, k)``.  Reading the JAX package's
``PNTPU1`` checkpoints (flax msgpack) is not ported yet.
"""

from __future__ import annotations

import pickle
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from protnote_tpu_torch.models.layers import Params

# Train-state entries that inference never reads (the JAX ServingEngine
# drops the same two).
_DROPPED = ("opt_state", "step")


def _convert(node: Any, key: Optional[str] = None) -> Any:
    if isinstance(node, dict):
        return {k: _convert(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_convert(v) for v in node)
    if node is None:
        return None
    arr = np.array(node)  # a copy: the tensor owns its memory
    if key == "kernel" and arr.ndim == 3:  # conv: (k, cin, cout) -> (cout, cin, k)
        arr = np.ascontiguousarray(arr.transpose(2, 1, 0))
    return torch.from_numpy(arr)


def from_jax_tree(numpy_tree: Dict[str, Any]) -> Dict[str, Any]:
    """JAX train-state bundle (``trainable``/``model_state``/``enc_params``/
    ``enc_state``...) as numpy arrays -> the same bundle as CPU tensors.

    ``opt_state`` and ``step`` are dropped."""
    return {k: _convert(v) for k, v in numpy_tree.items() if k not in _DROPPED}


# ----------------------------------------------------------------------
# TF pickle -> ProteInfer params


def _order_tf_values_by_name(tf_weights: Dict[str, np.ndarray],
                             num_blocks: int) -> Optional[List[np.ndarray]]:
    """TF variables in slot order by variable name (conv stem, then per block
    bn1, conv_dilated, bn2, conv_1x1, then the dense head), as the JAX
    loader orders them; None when the names do not fit that schema."""
    groups: Dict[str, Dict[str, np.ndarray]] = defaultdict(dict)
    for name, arr in tf_weights.items():
        parts = name.split("/")
        groups["/".join(parts[:-1])][parts[-1].split(":")[0]] = np.asarray(arr)

    def scope_index(scope: str) -> int:
        m = re.search(r"_(\d+)$", scope.split("/")[-1])
        return int(m.group(1)) if m else 0

    convs, bns, denses = [], [], []
    for scope, g in groups.items():
        if {"gamma", "beta", "moving_mean", "moving_variance"} <= set(g):
            bns.append((scope_index(scope), g))
        elif "kernel" in g and "bias" in g and g["kernel"].ndim in (2, 3):
            (convs if g["kernel"].ndim == 3 else denses).append((scope_index(scope), g))
        else:
            return None
    if (len(convs) != 1 + 2 * num_blocks or len(bns) != 2 * num_blocks
            or len(denses) != 1 or len({i for i, _ in convs}) != len(convs)
            or len({i for i, _ in bns}) != len(bns)):
        return None
    convs = [g for _, g in sorted(convs, key=lambda t: t[0])]
    bns = [g for _, g in sorted(bns, key=lambda t: t[0])]
    values = [convs[0]["kernel"], convs[0]["bias"]]
    for i in range(num_blocks):
        for bn, conv in ((bns[2 * i], convs[1 + 2 * i]), (bns[2 * i + 1], convs[2 + 2 * i])):
            values += [bn["gamma"], bn["beta"], bn["moving_mean"],
                       bn["moving_variance"], conv["kernel"], conv["bias"]]
    dense = denses[0][1]
    return values + [dense["kernel"], dense["bias"]]


def proteinfer_from_tf_pickle(weights_path: str, cfg) -> Tuple[Params, Params]:
    """Reference TF1 pickle -> the port's ProteInfer (params, state) on the
    CPU: variables matched by name, else in the pickle's order (the
    reference's positional zip).  TF kernels are in the JAX layout."""
    from protnote_tpu_torch.models.proteinfer import init_proteinfer

    with open(weights_path, "rb") as fh:
        tf_weights = {k: v for k, v in dict(pickle.load(fh)).items()
                      if not k.split("/")[-1].startswith("global_step")}
    values = _order_tf_values_by_name(tf_weights, cfg.num_resnet_blocks)
    if values is None:
        values = list(tf_weights.values())
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    slots: List[Tuple[Dict, str]] = [(params["conv1"], "kernel"), (params["conv1"], "bias")]
    for bp, bs in zip(params["blocks"], state["blocks"]):
        for bn, conv in (("bn1", "conv_dilated"), ("bn2", "conv_1x1")):
            slots += [(bp[bn], "scale"), (bp[bn], "bias"), (bs[bn], "mean"),
                      (bs[bn], "var"), (bp[conv], "kernel"), (bp[conv], "bias")]
    slots += [(params["output"], "kernel"), (params["output"], "bias")]
    if len(values) != len(slots):
        raise ValueError(f"TF pickle has {len(values)} arrays; expected {len(slots)}")
    for (container, key), arr in zip(slots, values):
        t = _convert(np.asarray(arr, dtype=np.float32), key)
        if tuple(t.shape) != tuple(container[key].shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(np.shape(arr))} "
                             f"vs {tuple(container[key].shape)}")
        container[key] = t
    return params, state
