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
  outside the square root; **AdamW** adds ``wd * p`` to ``u``; **SGD** is
  ``u = g`` (plus ``wd * p`` before it when WEIGHT_DECAY is set: the
  reference's L2 decay, after clipping).  Then ``p += -lr * u``.
* **accumulation** over k steps: the running mean of the k gradients, then
  one update of the inner chain (clip included) and a reset; the steps in
  between leave the parameters and the moments alone.

The state is a dict: ``count`` (updates applied), ``mu``/``nu`` (trees
shaped like the trainable tree; None for SGD) and, with accumulation,
``mini_step``, ``gradient_step`` and ``acc_grads``.  :meth:`Optimizer.jax_opt_state`
writes it in the layout of the JAX train state's ``opt_state``;
:func:`protnote_tpu_torch.models.convert.from_jax_tree` reads that layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

Tree = Any

MOMENT_DTYPE_LATER = ("OPTIMIZER_MOMENT_DTYPE (a bfloat16 Adam first moment) is not "
                      "ported (ROADMAP.md queue 1, item 5g); leave it null")
MASK_LATER = ("a trainable mask comes with the trainable label encoder (K8, ROADMAP.md "
              "queue 1, item 8); its optax multi_transform state is not read")

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam / optax.adamw defaults


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in a fixed order: dict keys sorted (as jax.tree_util does),
    lists in order; None is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


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
        if params_cfg.get("OPTIMIZER_MOMENT_DTYPE"):
            raise NotImplementedError(MOMENT_DTYPE_LATER)
        self.lr = float(params_cfg.get("LEARNING_RATE", 3e-4))
        self.wd = float(params_cfg.get("WEIGHT_DECAY", 0.0) or 0.0)
        clip = params_cfg.get("CLIP_VALUE")
        self.clip = None if clip is None else float(clip)
        self.accum = int(params_cfg.get("GRADIENT_ACCUMULATION_STEPS", 1) or 1)
        self.trainable_mask = trainable_mask

    @property
    def adam(self) -> bool:
        return self.name in ("Adam", "AdamW")

    def init(self, trainable: Tree) -> Dict[str, Any]:
        zeros = lambda t: torch.zeros_like(t, dtype=torch.float32)  # noqa: E731
        state: Dict[str, Any] = {"count": 0, "mu": None, "nu": None}
        if self.adam:
            state["mu"] = tree_map(zeros, trainable)
            state["nu"] = tree_map(zeros, trainable)
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
            mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        for i, (p, x) in enumerate(zip(params, g)):
            if not train[i]:
                continue
            if self.adam:
                mu, nu = mus[i], nus[i]
                mu.copy_((1 - B1) * x + B1 * mu)
                nu.copy_((1 - B2) * (x * x) + B2 * nu)
                u = (mu / bc1.to(mu.device)) / (torch.sqrt(nu / bc2.to(nu.device)) + EPS)
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

        if self.trainable_mask is not None:
            raise NotImplementedError(MASK_LATER)
        empty: Dict[str, Any] = {}
        if self.adam:
            adam = {"count": np.asarray(state["count"], np.int32),
                    "mu": to_numpy(state["mu"]), "nu": to_numpy(state["nu"])}
            base = ({"0": adam, "1": empty} if self.name == "Adam"
                    else {"0": adam, "1": empty, "2": empty})
        else:
            base = {"0": empty, "1": empty}  # sgd: identity, scale_by_learning_rate
            if self.wd:
                base = {"0": empty, "1": base}  # add_decayed_weights first
        inner = {"0": empty, "1": base} if self.clip is not None else {"0": base}
        if self.accum == 1:
            return inner
        return {"mini_step": np.asarray(state["mini_step"], np.int32),
                "gradient_step": np.asarray(state["gradient_step"], np.int32),
                "inner_opt_state": inner, "acc_grads": to_numpy(state["acc_grads"]),
                "skip_state": empty}
