"""NN primitives with the JAX package's numerics.

Port of ``protnote_tpu/models/layers.py``.  Parameters are plain nested dicts
of tensors with the JAX package's names and layouts (Linear kernels are
``(in, out)``), so a JAX parameter tree converts one to one
(:func:`protnote_tpu_torch.models.convert.from_jax_tree`).  BatchNorm follows
torch semantics as the JAX package does: biased batch variance to normalise
in training, running statistics in eval, and a running update with the
unbiased batch variance.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]


def gemm_precision(dtype: torch.dtype) -> None:
    """Full float32 products for float32 compute.

    Counterpart of the JAX ``gemm_precision`` (Precision.HIGHEST for f32
    operands).  On the card a float32 matmul is full f32 by default, but a
    float32 cuDNN convolution runs in TF32 unless told otherwise, which keeps
    about three decimal digits (the JAX package once saw a 1.1e-2 conv error
    from the same kind of gap).  The two flags are process-wide; the port only
    ever wants full precision from a float32 product, so they are set and
    never restored.  bfloat16 compute leaves them alone.
    """
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in ``x``'s dtype, as the JAX ``linear``."""
    gemm_precision(x.dtype)
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def batchnorm_apply(p: Params, s: Params, x: torch.Tensor, eps: float,
                    channel_dim: int = -1) -> torch.Tensor:
    """Eval-mode BatchNorm from running statistics, computed in float32 and
    cast back to ``x``'s dtype (JAX ``batchnorm_apply(train=False)``)."""
    inv = torch.rsqrt(s["var"].float() + eps) * p["scale"].float()
    shift = p["bias"].float() - s["mean"].float() * inv
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    y = x.float() * inv.view(shape) + shift.view(shape)
    return y.to(x.dtype)


def batchnorm_train(p: Params, s: Params, x: torch.Tensor, eps: float = 1e-5,
                    momentum: float = 0.1, reduce_axes: Tuple[int, ...] = (0,),
                    mask: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Params]:
    """Train-mode BatchNorm over ``reduce_axes`` (channel = last axis):
    ``(y, new_state)``, the JAX ``batchnorm_apply(train=True)``.

    ``mask`` restricts the statistics to valid positions (it may be of lower
    rank, e.g. (B, 1, 1) for (B, T, C)).  ``count`` replaces the divisor by
    the reference's padded position count: its BatchNorm ran over tensors
    zero-padded to the batch's longest sequence, so the variance gains the
    ``(count - n_valid) * mean^2`` the zero pads contribute.  Normalisation
    uses the biased variance; the running update (detached) the unbiased
    one, ``var * n / max(n - 1, 1)``."""
    xf = x.float()
    if mask is not None:
        m = mask.float()
        m_full = torch.broadcast_to(m, xf.shape[:-1] + (1,))
        n_valid = torch.clamp(m_full.sum(dim=reduce_axes), min=1.0)
        n = n_valid if count is None else torch.as_tensor(count, dtype=torch.float32,
                                                           device=x.device)
        mean = (xf * m).sum(dim=reduce_axes) / n
        var = (((xf - mean) ** 2 * m).sum(dim=reduce_axes) + (n - n_valid) * mean ** 2) / n
    else:
        n = 1.0
        for a in reduce_axes:
            n = n * x.shape[a]
        mean = xf.mean(dim=reduce_axes)
        shape = [1 if i in reduce_axes else d for i, d in enumerate(x.shape)]
        var = ((xf - mean.reshape(shape)) ** 2).mean(dim=reduce_axes)
    unbiased = (var * (n / max(n - 1.0, 1.0)) if isinstance(n, float)
                else var * (n / torch.clamp(n - 1.0, min=1.0))).detach()
    new_state = {
        "mean": (1 - momentum) * s["mean"] + momentum * mean.detach().to(s["mean"].dtype),
        "var": (1 - momentum) * s["var"] + momentum * unbiased.to(s["var"].dtype),
    }
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    shift = p["bias"].float() - mean * inv
    return (xf * inv + shift).to(x.dtype), new_state


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale by its
    inverse (the JAX ``dropout``), with bits drawn from ``generator`` (on
    ``x``'s device).  A no-op outside training or at rate 0."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def fold_batchnorm(p: Params, s: Params, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN as an affine (scale, shift) pair for kernel fusion."""
    inv = p["scale"] / torch.sqrt(s["var"] + eps)
    shift = p["bias"] - s["mean"] * inv
    return inv, shift


# Random init runs on the host from an explicit CPU ``torch.Generator``, so a
# seed gives the same weights whatever device they are moved to
# (:func:`tree_to`).


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) float32 (torch's Linear/Conv1d default init, as the
    JAX package's ``init_linear``/``_init_conv``)."""
    return torch.rand(shape, generator=generator) * (2.0 * bound) - bound


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                use_bias: bool = True) -> Params:
    bound = 1.0 / in_dim ** 0.5
    p: Params = {"kernel": uniform((in_dim, out_dim), bound, generator)}
    if use_bias:
        p["bias"] = uniform((out_dim,), bound, generator)
    return p


def init_batchnorm(dim: int) -> Tuple[Params, Params]:
    params = {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict/list parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
