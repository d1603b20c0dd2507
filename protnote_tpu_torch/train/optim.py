"""Optimizers of the port with optax's semantics.

Port of ``protnote_tpu/train/optim.py``, which builds the optax chain
``[clip_by_global_norm(CLIP_VALUE)] -> Adam | AdamW | SGD``, optionally
partitioned by a trainable mask (frozen leaves get a zero update) and
wrapped in ``MultiSteps`` for ``GRADIENT_ACCUMULATION_STEPS``.  The port
applies the same arithmetic in place on the parameter tensors:

* **clip**, optax's rule: ``g`` unchanged while ``||g|| < clip``, else
  ``(g / ||g||) * clip``.  (``torch.nn.utils.clip_grad_norm_`` divides by
  ``||g|| + 1e-6`` instead.)
* **Adam**: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
  ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` with eps = 1e-8
  outside the square root; **AdamW** adds ``wd * p`` to ``u``.
  ``OPTIMIZER_MOMENT_DTYPE: bfloat16`` stores mu in bf16 as optax's
  ``mu_dtype`` does, with the arithmetic of the JAX train step, where XLA
  compiles the update: b1 is rounded to bf16 (JAX rounds a Python scalar to
  the array's dtype), ``b1 * mu`` and its sum with ``(1 - b1) g`` are f32
  and feed ``u``, and mu is rounded to bf16 only when it is stored; nu stays
  f32.  (Eager optax also rounds the product ``b1 * mu`` to bf16; XLA's
  fusion does not.)  **SGD** is
  ``u = g`` (plus ``wd * p`` before it when WEIGHT_DECAY is set: the
  reference's L2 decay, after clipping).  Then ``p += -lr * u``.
* **accumulation** over k steps: the running mean of the k gradients, then
  one update of the inner chain (clip included) and a reset; the steps in
  between leave the parameters and the moments alone.

A **trainable mask** (a bool tree like the trainable tree; the JAX CLI
builds one for the label tower's last-n-layer unfreezing) has the
semantics of ``optax.multi_transform({"train": base, "freeze":
set_to_zero()})`` after the clip: the clip (and ``grad_norm``) runs over
**every** gradient, frozen ones included; Adam updates only the masked
leaves and keeps moments only for them (optax's ``MaskedNode`` elsewhere);
frozen leaves get a zero update, so their bits do not change.

The state is a dict: ``count`` (updates applied), ``mu``/``nu`` (trees
shaped like the trainable tree, None at frozen leaves; None for SGD) and,
with accumulation, ``mini_step``, ``gradient_step`` and ``acc_grads``.
:meth:`Optimizer.jax_opt_state` writes it in the layout of the JAX train
state's ``opt_state`` (with a mask, the ``PartitionState`` of
``multi_transform``); :func:`protnote_tpu_torch.models.convert.from_jax_tree`
reads that layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

Tree = Any

MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam / optax.adamw defaults


def tree_leaves(tree: Tree, keep_none: bool = False) -> List[Any]:
    """Leaves in a fixed order: dict keys sorted (as jax.tree_util does),
    lists in order; None is no leaf (or, with ``keep_none``, a leaf, so a
    masked moment tree lines up with its parameters)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], keep_none)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, keep_none)]
    return [tree] if keep_none or tree is not None else []


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(x^2))`` in float32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in leaves))


class Optimizer:
    """The optax chain of ``make_optimizer`` for one parameter config."""

    def __init__(self, params_cfg: Dict[str, Any], trainable_mask: Optional[Tree] = None):
        self.name = params_cfg.get("OPTIMIZER", "Adam")
        if self.name not in ("Adam", "AdamW", "SGD"):
            raise ValueError(f"Unknown optimizer {self.name}")
        mu_dtype = params_cfg.get("OPTIMIZER_MOMENT_DTYPE")
        if mu_dtype and str(mu_dtype) not in MOMENT_DTYPES:
            raise ValueError(f"OPTIMIZER_MOMENT_DTYPE {mu_dtype!r}: one of {sorted(MOMENT_DTYPES)}")
        self.mu_dtype = MOMENT_DTYPES[str(mu_dtype)] if mu_dtype else torch.float32
        self.lr = float(params_cfg.get("LEARNING_RATE", 3e-4))
        self.wd = float(params_cfg.get("WEIGHT_DECAY", 0.0) or 0.0)
        clip = params_cfg.get("CLIP_VALUE")
        self.clip = None if clip is None else float(clip)
        self.accum = int(params_cfg.get("GRADIENT_ACCUMULATION_STEPS", 1) or 1)
        self.trainable_mask = trainable_mask

    @property
    def adam(self) -> bool:
        return self.name in ("Adam", "AdamW")

    def _masked(self, fn: Callable, trainable: Tree) -> Tree:
        """``fn`` of each trained leaf, None at frozen ones."""
        if self.trainable_mask is None:
            return tree_map(fn, trainable)
        return tree_map(lambda t, m: fn(t) if m else None, trainable, self.trainable_mask)

    def init(self, trainable: Tree) -> Dict[str, Any]:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        state: Dict[str, Any] = {"count": 0, "mu": None, "nu": None}
        if self.adam:
            state["mu"] = self._masked(lambda t: torch.zeros_like(t, dtype=self.mu_dtype),
                                       trainable)
            state["nu"] = self._masked(zeros, trainable)
        if self.accum > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=tree_map(zeros, trainable))
        return state

    @torch.no_grad()
    def update(self, grads: Tree, trainable: Tree, state: Dict[str, Any]) -> Dict[str, Any]:
        """Apply one step of gradients ``grads`` (a tree like ``trainable``)
        to the parameters of ``trainable`` in place; returns the new state."""
        g = [x.float() for x in tree_leaves(grads)]
        if self.accum > 1:
            n = state["mini_step"]
            acc = tree_leaves(state["acc_grads"])
            for a, x in zip(acc, g):
                a.add_((x - a) / (n + 1))
            if n < self.accum - 1:
                return dict(state, mini_step=n + 1)
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state = dict(state, mini_step=0, gradient_step=state["gradient_step"] + 1)
        self._apply(g, trainable, state)
        return state

    def _apply(self, g: List[torch.Tensor], trainable: Tree, state: Dict[str, Any]) -> None:
        params = tree_leaves(trainable)
        if self.clip is not None:
            norm = global_norm(g)
            keep = norm < self.clip
            g = [torch.where(keep, x, (x / norm) * self.clip) for x in g]
        train = ([True] * len(params) if self.trainable_mask is None
                 else [bool(m) for m in tree_leaves(self.trainable_mask)])
        state["count"] += 1
        t = state["count"]
        if self.adam:
            bc1 = 1 - torch.tensor(B1, dtype=torch.float32) ** t
            bc2 = 1 - torch.tensor(B2, dtype=torch.float32) ** t
            mus = tree_leaves(state["mu"], keep_none=True)
            nus = tree_leaves(state["nu"], keep_none=True)
        for i, (p, x) in enumerate(zip(params, g)):
            if not train[i]:
                continue
            if self.adam:
                mu, nu = mus[i], nus[i]
                # b1 in the moment dtype (bf16 with OPTIMIZER_MOMENT_DTYPE), the
                # new moment in f32, rounded to the moment dtype when stored
                b1 = float(torch.tensor(B1, dtype=self.mu_dtype))
                m = (1 - B1) * x + b1 * mu.float()
                mu.copy_(m.to(self.mu_dtype))
                nu.copy_((1 - B2) * (x * x) + B2 * nu)
                u = (m / bc1.to(m.device)) / (torch.sqrt(nu / bc2.to(nu.device)) + EPS)
                if self.name == "AdamW":
                    u = u + self.wd * p
            else:
                u = x + self.wd * p if self.wd else x
            p.add_((-self.lr * u).to(p.dtype))

    # ---------------- the JAX opt_state layout ----------------

    def jax_opt_state(self, state: Dict[str, Any], to_numpy: Callable) -> Dict[str, Any]:
        """``state`` in the layout ``flax.serialization.to_state_dict`` gives
        the ``opt_state`` of a JAX train state built by ``make_optimizer``
        with the same config: tuples and lists as dicts keyed "0".., optax's
        named-tuple states keyed by field.  ``to_numpy`` converts a tree of
        tensors (the JAX tree layout) to numpy."""
        import numpy as np

        empty: Dict[str, Any] = {}

        def moments(node: Tree) -> Tree:  # optax's MaskedNode is an empty map
            if isinstance(node, dict):
                return {k: moments(v) for k, v in node.items()}
            if isinstance(node, list):
                return [moments(v) for v in node]
            return {} if node is None else node

        if self.adam:
            adam = {"count": np.asarray(state["count"], np.int32),
                    "mu": moments(to_numpy(state["mu"])), "nu": moments(to_numpy(state["nu"]))}
            base = ({"0": adam, "1": empty} if self.name == "Adam"
                    else {"0": adam, "1": empty, "2": empty})
        else:
            base = {"0": empty, "1": empty}  # sgd: identity, scale_by_learning_rate
            if self.wd:
                base = {"0": empty, "1": base}  # add_decayed_weights first
        if self.trainable_mask is not None:  # multi_transform's PartitionState
            base = {"inner_states": {"freeze": {"inner_state": empty},
                                     "train": {"inner_state": base}}}
        inner = {"0": empty, "1": base} if self.clip is not None else {"0": base}
        if self.accum == 1:
            return inner
        return {"mini_step": np.asarray(state["mini_step"], np.int32),
                "gradient_step": np.asarray(state["gradient_step"], np.int32),
                "inner_opt_state": inner, "acc_grads": to_numpy(state["acc_grads"]),
                "skip_state": empty}
