"""protnote_tpu_torch: the PyTorch and CUDA port of protnote_tpu for NVIDIA
Hopper (H100).

The JAX package ``protnote_tpu`` is the reference; this package mirrors its
layout module for module, so ``protnote_tpu/<path>`` has its counterpart at
``protnote_tpu_torch/<path>``.  It imports torch and never jax, and
nothing of ``protnote_tpu``: the host-only modules it needs (the data
layer, the jax-free config functions, the request side of serving) are
copied into it.  Ported so far are the serving path (bf16 and int8), the
test-set evaluation path and training; the hand-written CUDA kernels live
in ``csrc/`` (K1 bf16 pair scorer, K2 int8 pair scorer, K3 eval
accumulator, K4 training pair GEMM, K5 BN+ReLU).
"""

__version__ = "0.1.0"
