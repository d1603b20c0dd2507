"""protnote_tpu_torch: the PyTorch and CUDA port of protnote_tpu for NVIDIA
Hopper (H100).

The JAX package ``protnote_tpu`` is the reference; this package mirrors its
layout module for module, so ``protnote_tpu/<path>`` has its counterpart at
``protnote_tpu_torch/<path>``.  It imports torch and never jax.  Ported
so far are the serving path (ProteInfer encoder in eval mode, projection
heads, the folded pair scorer with its hand-written CUDA kernel, the eval
step, ``ServingEngine``, ``cli.serve``) and the test-set evaluation path
(the ``PNTPU1`` checkpoint reader and reference ``.pt`` loader, the
on-device eval accumulator with its CUDA kernels, ``Trainer.evaluate``,
``cli.main``); the kernels live in ``csrc/``.  Host-only modules of the
JAX package that never import jax (``protnote_tpu.data``, the jax-free
parts of ``protnote_tpu.core.config``, and ``ServingStats``,
``topk_from_probs`` and ``make_http_server`` from ``protnote_tpu.serving``)
are imported, not copied.
"""

__version__ = "0.1.0"
