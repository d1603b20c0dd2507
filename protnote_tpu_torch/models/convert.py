"""Weights into the port.

* :func:`from_jax_tree` turns the JAX package's train-state bundle (its
  pytrees as numpy arrays, e.g. ``jax.tree_util.tree_map(np.asarray, ts)``,
  or the tree of a ``PNTPU1`` checkpoint) into the port's tensors, optax's
  Adam state into the port's optimizer state; :func:`to_jax_tree` is the
  inverse, for the checkpoint writer.
* :func:`proteinfer_from_tf_pickle` reads the reference's TF1 ProteInfer
  pickle (``GO_model_weights*.pkl``), as the JAX package's loader of the same
  name does.
* :func:`load_reference_checkpoint` reads a reference ProtNote ``.pt`` file
  (``torch.save`` of a ``model_state_dict``, optionally ``module.``-prefixed
  from DDP) by module name, as the JAX package's loader of the same name.

The port keeps the JAX tree structure and names.  Linear kernels stay
``(in, out)``; conv kernels are the one layout change, from JAX's
``(k, cin, cout)`` to torch's ``(cout, cin, k)``.  The JAX package's
``PNTPU1`` checkpoints are read by
:mod:`protnote_tpu_torch.core.checkpoint`.
"""

from __future__ import annotations

import pickle
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from protnote_tpu_torch.models.layers import Params

_TRAIN_ONLY = ("opt_state", "step")


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

    ``step`` becomes an int, ``opt_state`` the port's optimizer state
    (:func:`opt_state_from_jax`)."""
    out = {k: _convert(v) for k, v in numpy_tree.items() if k not in _TRAIN_ONLY}
    if "step" in numpy_tree:
        out["step"] = int(np.asarray(numpy_tree["step"]))
    if "opt_state" in numpy_tree:
        out["opt_state"] = opt_state_from_jax(numpy_tree["opt_state"], out["trainable"])
    return out


def _state_dict(node: Any) -> Any:
    """flax's ``to_state_dict`` layout: named tuples keyed by field, other
    tuples and lists keyed "0".."n-1"."""
    if hasattr(node, "_fields"):
        return {f: _state_dict(getattr(node, f)) for f in node._fields}
    if isinstance(node, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(node)}
    if isinstance(node, dict):
        return {k: _state_dict(v) for k, v in node.items()}
    return node


def _find(node: Any, fields) -> Optional[Dict[str, Any]]:
    """The first dict (depth first) that holds every key of ``fields``."""
    if isinstance(node, dict):
        if set(fields) <= set(node):
            return node
        for v in node.values():
            found = _find(v, fields)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state: Any, trainable: Dict[str, Any]) -> Dict[str, Any]:
    """An optax state of ``make_optimizer`` (named tuples, or the
    state-dict layout of a checkpoint) -> the port's optimizer state
    (:mod:`protnote_tpu_torch.train.optim`): ``ScaleByAdamState`` gives
    ``count``, ``mu`` and ``nu`` (trees like ``trainable``), ``MultiStepsState``
    gives ``mini_step``, ``gradient_step`` and ``acc_grads``.  SGD's state
    holds no arrays (no moments)."""
    from protnote_tpu_torch.core.checkpoint import merge_into_template
    from protnote_tpu_torch.train.optim import MASK_LATER

    sd = _state_dict(opt_state)
    if _find(sd, ("inner_states",)) is not None:
        raise NotImplementedError(MASK_LATER)
    like = lambda tree: merge_into_template(trainable, tree, "/opt_state")  # noqa: E731
    out: Dict[str, Any] = {"count": 0, "mu": None, "nu": None}
    adam = _find(sd, ("count", "mu", "nu"))
    if adam is not None:
        out.update(count=int(np.asarray(adam["count"])), mu=like(adam["mu"]),
                   nu=like(adam["nu"]))
    multi = _find(sd, ("mini_step", "gradient_step", "inner_opt_state", "acc_grads"))
    if multi is not None:
        out.update(mini_step=int(np.asarray(multi["mini_step"])),
                   gradient_step=int(np.asarray(multi["gradient_step"])),
                   acc_grads=like(multi["acc_grads"]))
    return out


def _to_numpy(node: Any, key: Optional[str] = None) -> Any:
    if isinstance(node, dict):
        return {k: _to_numpy(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_numpy(v) for v in node]
    if not isinstance(node, torch.Tensor):
        return node
    t = node.detach().cpu()
    if key == "kernel" and t.dim() == 3:  # conv: (cout, cin, k) -> (k, cin, cout)
        t = t.permute(2, 1, 0)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        from protnote_tpu_torch.core.checkpoint import _BF16Array

        return _BF16Array(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def to_jax_tree(ts: Dict[str, Any], optimizer=None) -> Dict[str, Any]:
    """The port's train state -> the JAX train-state tree with numpy leaves
    (bfloat16 leaves as their bits): conv kernels back to ``(k, cin, cout)``,
    ``step`` an int32 scalar, ``text_params`` None, and ``opt_state`` in the
    layout of ``make_optimizer``'s optax state for ``optimizer``'s config
    (:meth:`~protnote_tpu_torch.train.optim.Optimizer.jax_opt_state`)."""
    out = {k: _to_numpy(v) for k, v in ts.items() if k not in _TRAIN_ONLY}
    out.setdefault("text_params", None)
    if "step" in ts:
        out["step"] = np.asarray(ts["step"], np.int32)
    if "opt_state" in ts:
        if optimizer is None:
            raise ValueError("writing opt_state needs the optimizer that made it")
        out["opt_state"] = optimizer.jax_opt_state(ts["opt_state"], _to_numpy)
    return out


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


# ----------------------------------------------------------------------
# reference torch state dict -> the port's trees


def _strip_ddp(sd: Dict[str, Any]) -> Dict[str, Any]:
    if sd and next(iter(sd)).startswith("module."):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _to_tensor(v: Any) -> torch.Tensor:
    """A CPU float32 copy: the tree owns its memory, so a later in-place
    change of the state dict cannot reach it."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v), dtype=torch.float32)


def _group_sequential(sd: Dict[str, Any], prefix: str) -> List[Dict[str, Any]]:
    """A flat torch Sequential's entries grouped by integer path, in index
    order (robust to Dropout/ReLU gaps and dropout-wrapper nesting)."""
    groups: Dict[Tuple[int, ...], Dict[str, Any]] = defaultdict(dict)
    plen = len(prefix) + 1
    for key, val in sd.items():
        if not key.startswith(prefix + "."):
            continue
        parts = key[plen:].split(".")
        idx = tuple(int(p) for p in parts[:-1] if p.isdigit())
        groups[idx][parts[-1]] = _to_tensor(val)
    return [groups[k] for k in sorted(groups)]


def _classify(groups) -> Tuple[List[Dict], List[Dict]]:
    """Split sequential groups into (linears, batchnorms)."""
    linears, bns = [], []
    for g in groups:
        if "running_mean" in g:
            bns.append(g)
        elif "weight" in g and g["weight"].dim() == 2:
            linears.append(g)
    return linears, bns


def _assign_linear(dst: Params, g: Dict[str, Any]) -> None:
    dst["kernel"] = _to_tensor(g["weight"]).T.contiguous().to(dst["kernel"].dtype)
    if "bias" in dst and "bias" in g:
        dst["bias"] = _to_tensor(g["bias"]).to(dst["bias"].dtype)


def _assign_bn(dst_p: Params, dst_s: Params, g: Dict[str, Any]) -> None:
    dst_p["scale"] = _to_tensor(g["weight"])
    dst_p["bias"] = _to_tensor(g["bias"])
    dst_s["mean"] = _to_tensor(g["running_mean"])
    dst_s["var"] = _to_tensor(g["running_var"])


def proteinfer_from_torch_state_dict(sd: Dict[str, Any], cfg) -> Tuple[Params, Params]:
    """Reference torch ProteInfer (protein_encoders.py:70-123) -> the port's
    (params, state).  Torch conv weights are already ``(cout, cin, k)``."""
    from protnote_tpu_torch.models.proteinfer import init_proteinfer

    sd = _strip_ddp(dict(sd))
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)

    def conv(dst: Params, w, b) -> None:
        w = _to_tensor(w)
        if tuple(w.shape) != tuple(dst["kernel"].shape):
            raise ValueError(f"conv kernel shape {tuple(w.shape)} vs "
                             f"{tuple(dst['kernel'].shape)}")
        dst["kernel"] = w
        dst["bias"] = _to_tensor(b)

    def bn(pre: str) -> Dict[str, Any]:
        return {k: sd[f"{pre}.{k}"] for k in ("weight", "bias", "running_mean",
                                               "running_var")}

    conv(params["conv1"], sd["conv1.weight"], sd["conv1.bias"])
    for i, (bp, bs) in enumerate(zip(params["blocks"], state["blocks"])):
        pre = f"resnet_blocks.{i}"
        _assign_bn(bp["bn1"], bs["bn1"], bn(f"{pre}.bn_activation_1.0"))
        conv(bp["conv_dilated"], sd[f"{pre}.masked_conv1.weight"],
             sd[f"{pre}.masked_conv1.bias"])
        _assign_bn(bp["bn2"], bs["bn2"], bn(f"{pre}.bn_activation_2.0"))
        conv(bp["conv_1x1"], sd[f"{pre}.masked_conv2.weight"],
             sd[f"{pre}.masked_conv2.bias"])
    _assign_linear(params["output"], {"weight": sd["output_layer.weight"],
                                      "bias": sd["output_layer.bias"]})
    return params, state


def protnote_from_torch_state_dict(sd: Dict[str, Any], cfg, proteinfer_cfg=None):
    """Reference torch ProtNote state dict -> ``(params, state, encoder)``:
    the W_p/W_l projection heads, the output-layer MLP, the optional
    attention scorer and, when the state dict embeds a ``sequence_encoder``
    and ``proteinfer_cfg`` is given, the encoder's (params, state) (else
    ``encoder`` is None).  Counts of linears and batchnorms are checked: an
    unchecked zip would keep random-init layers silently."""
    from protnote_tpu_torch.models.fusion import init_protnote

    sd = _strip_ddp(dict(sd))
    params, state = init_protnote(torch.Generator().manual_seed(0), cfg)

    for head in ("W_p", "W_l"):
        linears, bns = _classify(_group_sequential(sd, head))
        if len(linears) != len(params[head]["layers"]):
            raise ValueError(f"{head}: {len(linears)} linears in checkpoint vs "
                             f"{len(params[head]['layers'])} expected")
        for dst, g in zip(params[head]["layers"], linears):
            _assign_linear(dst, g)
        if len(bns) != len(params[head]["bns"]):
            raise ValueError(f"{head}: {len(bns)} batchnorms in checkpoint vs "
                             f"{len(params[head]['bns'])} expected")
        for dst_p, dst_s, g in zip(params[head]["bns"], state[head]["bns"], bns):
            _assign_bn(dst_p, dst_s, g)

    if cfg.feature_fusion.startswith("concatenation"):
        linears, bns = _classify(_group_sequential(sd, "output_layer"))
        om_p, om_s = params["output_mlp"], state.get("output_mlp")
        if len(linears) != len(om_p["layers"]) + 1:
            raise ValueError(f"output_layer: {len(linears)} linears vs "
                             f"{len(om_p['layers']) + 1} expected")
        for dst, g in zip(om_p["layers"], linears[:-1]):
            _assign_linear(dst, g)
        _assign_linear(om_p["out"], linears[-1])
        if om_s is not None:
            if len(bns) != len(om_p["bns"]):
                raise ValueError(f"output_layer: {len(bns)} batchnorms in "
                                 f"checkpoint vs {len(om_p['bns'])} expected")
            for dst_p, dst_s, g in zip(om_p["bns"], om_s["bns"], bns):
                _assign_bn(dst_p, dst_s, g)

    if "raw_attn_scorer.weight" in sd and "attn" in params:
        _assign_linear(params["attn"], {"weight": sd["raw_attn_scorer.weight"],
                                        "bias": sd["raw_attn_scorer.bias"]})

    encoder = None
    if proteinfer_cfg is not None and any(k.startswith("sequence_encoder.") for k in sd):
        enc_sd = {k[len("sequence_encoder."):]: v for k, v in sd.items()
                  if k.startswith("sequence_encoder.")}
        encoder = proteinfer_from_torch_state_dict(enc_sd, proteinfer_cfg)
    return params, state, encoder


def load_reference_checkpoint(path: str, cfg, proteinfer_cfg=None):
    """A reference ``.pt`` file -> ``(params, state, encoder, meta)``.

    The file is a pickle (``torch.save``), read with ``weights_only=False``
    as the JAX loader reads it: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    params, state, encoder = protnote_from_torch_state_dict(sd, cfg, proteinfer_cfg)
    meta = {"epoch": ckpt.get("epoch"), "best_val_metric": ckpt.get("best_val_metric")}
    return params, state, encoder, meta
