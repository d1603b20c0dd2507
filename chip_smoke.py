#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, evaluation, training, int8,
label-text-tower, encoder-training and streamed-training paths on one CUDA
card (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device: card name, power limit, CUDA and nvcc versions;
2. build: compiles every ``protnote_tpu_torch/csrc/*.cu`` with nvcc, one
   nvcc per source, all at once, and prints each one's ptxas lines;
3. the pair-scorer kernel (K1) against its plain PyTorch version at the full
   serving width (32 sequences x 64,204 label rows, d=1024, H=3072, bf16),
   with both times from CUDA events; then K1 in parts: its ptxas registers,
   spills and shared memory, each of its four launch modes alone on one
   chunk (the first layer forms A from a and c, the last takes the dot with
   w_out), the whole call at three chunk sizes in turns, the float32 side
   products, and ``gemm_ms``: ``torch.matmul`` on the two H x H products
   over materialised bf16 activations of the same rows (a yardstick, not the
   same function);
4. serving: a full-width ``ServingEngine`` (ProteInfer 1100 channels x 5
   blocks, 32,102 labels x 2 descriptions) behind the stdlib HTTP server,
   answering /v1/predict and /healthz requests (K7's forward launches
   counted); the ProteInfer encoder alone (K7: 11 ``masked_conv_forward``
   launches on TMA + wgmma and the pool) at buckets 512 and 1024 from CUDA
   events (with a new lengths tensor a call, and with one kept) beside the
   plain chain (the cuDNN conv1d chain of K7's ``*_reference`` functions),
   the pooled embeddings against it, the 11 conv launches alone on their
   recorded inputs against the plain convs, the 11 cuDNN conv1d calls alone
   (K7's library time) and the pool alone; TFLOP/s, share of the bound and
   the conv kernels' ptxas registers and spills;
5. serving parity: ``engine.score`` against a forward through the plain
   pair scorer on the same device tensors;
6. the eval-accumulator kernels (K3) against their plain version at full
   width (32 rows x 32,102 labels x 512 bins, 8 batches with padded rows,
   a label_mask with zeros and one label-subset batch): the update (one
   launch a batch, its row tail folded in, its scratch left zero) and the
   finalize, with both times and their ptxas figures;
7. evaluation: a 256-sequence FASTA -> ``ProteinDataset`` -> ``BucketBatcher``
   (device label gather) -> ``PrefetchBatcher`` -> the port's
   ``Trainer.evaluate`` (eval step with K1, then a K3 update per batch, K3
   finalize), then a second pass over the same batches that feeds each
   logits tensor to the kernel and to the plain accumulator; then
   7a. the threshold-sweep kernels (K9) against their plain version (the
   lax.map loop) at full width (8 batches of 32 rows x 32,102 labels
   padded to 32,256 columns, padded rows, NaN logits), with the CLI's 99
   thresholds and an unsorted set with a duplicate: counts exact up to the
   counted (element, threshold) pairs within 1e-6; update and finalize
   times beside their bounds and the plain version's;
   7b. ``Trainer.evaluate(threshold_sweep=...)`` on the phase-7 FASTA in
   turns with the same evaluation without the sweep: seqs/s of both, the
   chosen threshold, K9's and K3's launches;
   7c. the exact host AUPRC (``estimate_map=False``) on the same FASTA:
   seqs/s; a pass by hand split into device, readback and host-update ms a
   batch, its logits also into K3 and a host histogram (equal up to counted
   edge elements); the binned estimate must equal the exact computation on
   the probabilities quantised to its bins (1e-6), and the threshold metrics
   of the two paths must agree (counts exactly, samplewise sums to 1e-6);
8. the training kernels: at full width with 8 sequences (the reference's
   per-card batch, where the plain scorer still fits), the decomposed
   scorer through K4, K4-bwd and K5 against its plain version on the same
   device tensors (logits, new BN running statistics, the gradients of P_e,
   L_e and every output-MLP parameter); then K4's forward, K5's forward and
   K5's backward alone at the training path's 32-sequence shapes
   (1,027,264 x 3072 pre-activations) against their plain versions (K5's
   in 512-column slices), with both times; K4's ptxas registers, spills and
   shared memory, TFLOP/s and share of its bound, and ``gemm_ms``:
   ``torch.matmul`` on the materialised bf16 x1 of the same rows (a
   yardstick, not the same function); then K4-bwd's two kernels (dX with
   the gate and side sums, dW) alone at the same shapes against the plain
   backward, which runs whole: their times, TFLOP/s, shares of the 39.2 ms
   bound, ptxas figures, and cuBLAS on the two bare products over a
   materialised x1 as the yardstick;
9. training: a generated FASTA (352 training and 64 validation sequences
   over the 32,102-label vocabulary) -> weighted, shuffled ``BucketBatcher``
   -> ``PrefetchBatcher`` -> the port's ``Trainer.train`` for one epoch at
   full width and 32 sequences a step (train steps through K4 + K4-bwd + K5,
   FocalLoss, clipped Adam; validation through K1 + K3; checkpoints), each
   step's loss and time, one ``torch.profiler`` pass for the device idle
   share and the top kernels, peak memory, and a checkpoint written,
   restored and scored to the same logits; then the same epoch with
   ``GRADIENT_CHECKPOINTING`` (step ms and peak memory beside the
   default's), with a shuffled 8,192-label subset and a bf16 Adam first
   moment (validated on a fixed 8,192-label subset, then evaluated on a
   shuffled one through K3's ``cols`` path), and with in-batch labels
   shipped in every batch.

10. the int8 pair scorer (K2) alone at the full serving width (the same
    shapes as phase 3), with static scales from ``calibrate_act_scales``
    and with dynamic per-row scales, against its plain version on the same
    device tensors: max |Δlogit|, the carried layer-1 rows of two label
    chunks compared element by element, the code pass (layer 1's static
    codes) and the row-scale pass (dynamic scales and codes) against their
    plain versions, each launch of one chunk timed alone with its ptxas
    figures, one profiled call of each mode, times from CUDA events
    beside the 39.2 ms int8 bound, and ``torch._int_mm`` on the same GEMM
    shapes as the yardstick;
11. int8 serving: a full-width ``ServingEngine`` with ``PAIR_BACKEND
    tiled_int8`` calibrated from random sequences (``calibrate_from``),
    warmed up, then full batches (batch ms, seqs/s, peak memory), its
    probabilities against a forward through the plain int8 scorer, and the
    drift from the bf16 engine on the same weights (printed, not gated);
12. int8 evaluation: ``Trainer.evaluate`` on the phase-7 FASTA with
    ``tiled_int8``, auto-calibrated (static, K2's layer kernel), then with
    ``INT8_CALIBRATE`` off (dynamic: the row-scale kernel too): seqs/s, the
    scales and mAP beside the bf16 pass (random weights: printed only);
13. the text tower's kernels alone, masked attention (K8a) and residual
    LayerNorm (K8b), at E5-large width (16 heads of 64, H 1024) against their
    plain versions on the same device tensors at three shapes: (a) B 128 x
    T 128, lengths 40-128 (GO descriptions with the E5 instruction), (b)
    B 32 x T 512, lengths up to 510 (the longest bucket), (c) the BioGPT
    causal form at B 128 x T 128; each with one all-masked filler row; times
    from CUDA events beside the bound, the plain version's and the library
    call's (SDPA with the same additive mask, ``F.layer_norm`` after the bf16
    add), which the port never calls; for K8b and ``F.layer_norm`` also the
    device time a call from ``torch.profiler`` and the host time a call;
14. the text tower: E5-large (24 layers, vocab 250,002, bf16, random weights
    from a seeded CUDA generator) and BioGPT against the plain tower (the
    plain K8a and K8b) on one chunk of (a) and (c): pooled (mean) embeddings;
    then 64 chunks of (a), 8,192 rows with one filler row, through
    ``NativeLabelEncoder.embed_ids`` on pre-tokenized ids: descriptions/s, ms a
    chunk, peak memory and each kernel's launches; a ``torch.profiler`` pass
    over 4 chunks for the device idle share and the top kernels;
15. zero-shot scoring: those 8,192 rows as 4,096 new labels x 2 descriptions
    behind a full-width ``ServingEngine`` (the earlier phases' random
    ProtNote weights, label embedding width 1024 = the tower's H), one full
    batch of 32 sequences through K1: batch ms, K1's launches, and the
    probabilities against the same chain through the plain tower and the
    plain pair scorer;
16. the tower's backward kernels alone, K8a-bwd (``csrc/text_attention_bwd.cu``:
    its one-pass kernel at (a) and (c), its two kernels at (b)) and K8b-bwd
    (``csrc/layer_norm.cu``), at phase 13's three shapes against their plain
    backward: dq, dk, dv, dx, dscale and dbias each within 2^-6 of the plain
    tensor's largest |value|, each the same bits twice; at (a) and (c) the
    two-kernel form on the same tensors too; K8a-bwd and SDPA's backward
    timed in turns (medians of 5 rounds, SDPA's time being noisy), CUDA
    event times, ``torch.profiler`` device times, and the backward of
    ``F.layer_norm`` after a bf16 add as K8b-bwd's yardstick;
17. training the tower at full width through ``Trainer.train``: 32 sequences
    a step with in-batch label sampling, every description row given random
    token ids of 16-128 tokens padded to 128; E5-large (24 layers, float32
    master weights, bf16 compute) with LoRA (rank 4, alpha 8) on its last 2
    layers for 9 steps, then with the whole tower trainable and its last 2
    layers unfrozen (so the backward runs through all 24 layers) for 9
    steps, and BioGPT with LoRA for 3 steps (K8a-bwd causal); each run's
    step times, seqs/s, descriptions/s, peak memory, the launches of every
    kernel, a validation pass through the tower on a 1,024-label subset, the
    idle share of 3 profiled steps, and one step's gradients: the tower
    alone under one fixed cotangent on its pooled output, each trained leaf
    (the LoRA adapters or the unfrozen layers) through the kernels within
    5e-2 of the plain chain's (L2) and of the plain backward's on the
    kernels' forward (largest |value|), and the whole step's ``grad_norm``
    within 5e-2 of the plain chain's;
18. K7's backward kernels alone at full width (32 sequences at bucket 512):
    ``masked_conv_dx`` on the 10 block convs, ``masked_conv_dw`` (dW and
    dbias; the same bits on a second call) on all 11 and the train-mode
    masked BN + ReLU forward and backward on the 10 BatchNorms, against the
    plain chain's autograd (within 2^-6 of each tensor's largest |value|),
    their times beside the bound, the plain versions' and cuDNN's conv
    backward (dX also without its dy copy and weight re-layout; dW on x and
    dy at the padded pitch, as training passes them, and from contiguous
    tensors, which it copies), TFLOP/s, share of the bound, ptxas;
19. training the encoder through ``Trainer.train`` at full width, 32
    sequences a step at bucket 512: ``TRAIN_SEQUENCE_ENCODER`` for 9 steps
    (step ms, seqs/s, peak memory, K7's launches, a validation pass), 3
    profiled steps (idle share, top kernels), the encoder's gradients under
    one fixed cotangent leaf by leaf within 5e-2 (L2) of the plain chain's
    and its new running statistics within 1e-2, a PNTPU1 checkpoint with
    ``trainable["encoder"]`` round-tripped, 2 steps at bucket 1024 (the
    peak there); then ``ENCODER_BN_TRAIN_MODE`` for 3 steps (the running
    statistics move, the weights do not);
20. the streamed exact-BN training scorer (``TRAIN_STREAMING_LABEL_TILE
    2048``): (a) K6's six kernels (``csrc/streamed_bn.cu``: the tile's
    shifted moments, the fixed affine + ReLU and the fused head, each with
    its backward) alone on one tile of 32 sequences (65,536 x 3072) against
    their plain versions, with their times beside the bound and the plain
    version's; (b) the streamed scorer at 32 sequences x 32,102 labels, z1
    cache by the rule and off, against the decomposed scorer through K4 +
    K5 (logits, running statistics, every gradient) and against its own
    plain version; (c) ``Trainer.train`` with the tile for 9 steps at 32
    sequences and a validation pass beside the decomposed step's 9, K4,
    K4-bwd and K6 launched as often as ``streamed_launches`` says and K5
    never, 3 profiled steps, one step of each scorer under the memory
    history (the largest allocations live at its peak, by source line),
    and 2 steps of 128 sequences with the cache off and 2 by the rule.

The serving, evaluation and training paths each assert K7's forward
launches (and none of its training kernels).  Then one JSON line with
every kernel: its launches on its path (K1 and K3
in the training run, whose validation evaluates; K9 in the first sweep
evaluation of 7b; K4, K4-bwd and K5 in training; K2
in the int8 serving and evaluation runs; K8a and K8b in the 64-chunk tower
run; K8a-bwd and K8b-bwd summed over the three tower-training runs, each
K8b-bwd call two kernel launches and each K8a-bwd call at 128 tokens one,
all counted; K7's forward and pool
in the training run, its backward and BN kernels in phase 19's
``TRAIN_SEQUENCE_ENCODER`` run, one a wrapper call; K6's in phase 20's
32-sequence streamed run; each count set to 0 just
before the path and read just after), its error against the plain version, its time,
the plain version's, the least time the card could take for the same work
(``bound_ms``: the larger of its bytes over 3.35 TB/s and its operations
over the dense peak of their type) and, where one PyTorch call computes the
same function, that call's time; then the card's name and power limit, and
last the line ``{"ok": true, "device": {...}}``.  Weights, label
embeddings and sequences are random, made from fixed seeds.  There is no
CPU path: without a CUDA device the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# full serving width: configs/base.yaml defaults
B = 32
NUM_LABELS = 32102
K_DESCRIPTIONS = 2  # INFERENCE_GO_DESCRIPTIONS: name+label
D_LATENT = 1024
H = 3 * D_LATENT  # OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR x latent
LABEL_TILE = 512

# stated tolerances (see PERF.md): the kernel and the plain version both
# round x2 and x3 to bf16, but sum in other orders (and the logits with
# atomics), so an activation can round to the neighbouring bf16 value
PROB_ATOL = 1e-2
LOGIT_ATOL = 5e-2

KERNEL_SOURCES = ("pair_scorer", "eval_accumulator", "pair_train", "pair_train_bwd", "bn_relu",
                  "pair_scorer_int8", "text_attention", "text_attention_bwd", "layer_norm",
                  "threshold_sweep", "masked_conv", "masked_conv_bwd", "masked_bn",
                  "streamed_bn")

# H100 SXM dense peaks for the bounds (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12  # float32 outside the tensor cores

# K2 (int8): the carried layer-1 rows of these label chunks are compared
# element by element (the first and the ragged last of 126), and must be
# equal: kernel and plain version round every step alike
K2_CHUNKS = ((0, LABEL_TILE), (125 * LABEL_TILE, NUM_LABELS * K_DESCRIPTIONS - 125 * LABEL_TILE))
INT8_SEQUENCES = 32  # calibrate_from's random sequences

# K3 (ESTIMATE_MAP evaluation): 512 AUPRC bins, DECISION_TH 0.5.  Kernel and
# plain version read the same logits; the integer state must agree exactly
# except for elements within EDGE of a bin edge or of the threshold (two
# exponentials may differ by an ulp there), whose count is printed; the
# float32 sums agree to SUM_RTOL, AP to AP_ATOL.
NUM_BINS = 512
THRESHOLD = 0.5
EDGE = 1e-6
SUM_RTOL = 1e-6
AP_ATOL = 1e-6
EVAL_SEQUENCES = 256
K3_SUBSET, K3_SUBSET_WIDTH = 20000, 20096  # the label-subset (cols) batch
# K9 (the threshold sweep): the CLI's 99 thresholds, and an unsorted set with
# a duplicate and thresholds outside (0, 1); label columns padded past L.
# Counts must agree exactly except for (element, threshold) pairs within
# EDGE of each other, whose count is printed.
ODD_THRESHOLDS = (0.7, 0.2, 0.5, 0.2, 0.95, 0.05, -0.1, 1.5)
K9_WIDTH = 32256

# training (configs/base.yaml): 32 sequences a step, FocalLoss gamma 2, Adam
# 3e-4 with global-norm clip 1 (WEIGHT_DECAY is unused by Adam), label
# noising alpha 20, weighted sampling
TRAIN_B = 32
TRAIN_SEQUENCES, VAL_SEQUENCES = 352, 64
TRAIN_PARAMS = {"LOSS_FN": "FocalLoss", "FOCAL_LOSS_GAMMA": 2, "FOCAL_LOSS_ALPHA": -1,
                "OPTIMIZER": "Adam", "LEARNING_RATE": 3e-4, "WEIGHT_DECAY": 0.001,
                "CLIP_VALUE": 1}
NOISING_ALPHA = 20.0
PROFILE_STEPS = 3
K45_B = 8  # the reference's per-card batch: the plain scorer still fits
K5_PLAIN_COLS = 512  # K5's plain version alone at 32 sequences, in column slices
# K4/K5 tolerances (see PERF.md).  Kernel and plain version round the same
# bf16 values but sum in other orders (the GEMM, the column reductions), so
# an element can land one bf16 step (2^-8 relative) apart: each kernel
# output within 2^-6 of its plain version's largest |value|.  Through the
# whole scorer such steps add up: logits within 5e-2, new running statistics
# within 1e-2 and every gradient within 5e-2 of the plain version's largest
# |value| of that tensor.
K45_REL_TOL = 2.0 ** -6
TRAIN_LOGIT_ATOL = 5e-2
STATS_REL_TOL = 1e-2
GRAD_REL_TOL = 5e-2
# a restored checkpoint scores the same logits; K1 adds its row sums with
# atomics in no fixed order, so two scorings of one weight set agree to ~1e-6
ROUNDTRIP_ATOL = 1e-4

# the label text tower (E5-large, bf16): the shapes of K8a/K8b alone, (name,
# batch, tokens, shortest and longest real length, causal)
K8_BWD_ROUNDS = 5  # K8a-bwd and SDPA's backward timed in turns, medians of these rounds
K8_SHAPES = (("a", 128, 128, 40, 128, False), ("b", 32, 512, 200, 510, False),
             ("c", 128, 128, 40, 128, True))
TOWER_CHUNKS = 64  # 8,192 descriptions = 4,096 new labels x 2
ZERO_SHOT_LABELS = 4096
# K8a and K8b against their plain versions on the same bf16 inputs: the sums
# run in other orders, so a probability or an output can round to the
# neighbouring bf16 value; within 1e-2 of the plain output's largest |value|
K8_REL_TOL = 1e-2
# the whole tower against the plain tower: such one-step differences pass
# through 24 layers; the pooled (mean) embeddings within 5e-2 of their
# largest |value|
TOWER_REL_TOL = 5e-2
# training the tower (phase 17): 32 sequences a step with in-batch label
# sampling (~128 descriptions), random token ids of 16-128 tokens padded to
# 128; LoRA rank 4, alpha 8, or the whole tower with the last 2 layers
# unfrozen; validation on a 1,024-label subset
TOWER_TRAIN_LENGTHS = (16, 128)
TOWER_TRAIN_LAYERS = 2
TOWER_LORA_RANK, TOWER_LORA_ALPHA = 4, 8.0
TOWER_VAL_LABELS = 1024
# K7 (the encoder's masked dilated conv chain): each kernel against its
# plain version on the same bf16 inputs within 2^-6 of the plain output's
# largest |value| (K45_REL_TOL: the conv sums in another order and the bias
# and the residual round again; the backward rounds each gradient once from
# a float32 sum in another order), the pool and the BN's running statistics
# to 1e-5, dscale and dbias to 1e-3 (float32 sums over 16,384 rows in other
# orders); the pooled embeddings of the whole chain, where such bf16 steps
# pass through 11 convs and 10 BatchNorms, within 5e-2 of their largest
# |value|
K7_FORWARD = ("masked_conv_fwd", "masked_mean_pool")
KERNEL_FIELDS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
K7_POOLED_REL_TOL = 5e-2
K7_F32_REL_TOL = 1e-5
K7_SUMS_REL_TOL = 1e-3
# training the encoder (TRAIN_SEQUENCE_ENCODER): 32 sequences a step at
# bucket 512; the peak memory also at 1024
ENCODER_TRAIN_STEPS, ENCODER_BN_STEPS, ENCODER_1024_STEPS = 9, 3, 2
# the streamed scorer (TRAIN_STREAMING_LABEL_TILE, K6): the default tile of
# 2,048 labels; its kernels alone on one tile of 32 sequences; the scorer
# against the decomposed one at 32 sequences; 9 training steps at 32
# sequences (the decomposed step beside it), 2 at 128 with the z1 cache off
# and 2 with the rule's choice.  K6's float32 sums (moments, dinv, dshift,
# logits, db) within 1e-3 of the plain version's largest |value| (float32
# sums in other orders over 65,536 rows), its bf16 outputs within 2^-6
STREAM_TILE = 2048
STREAM_STEPS, STREAM_BIG_B, STREAM_BIG_STEPS = 9, 128, 2
K6_SUMS_REL_TOL = 1e-3
K6_KERNELS = ("stream_moments", "stream_moments_backward", "affine_relu",
              "affine_relu_backward", "stream_head", "stream_head_backward")
DECOMPOSED_KERNELS = ("pair_train_hidden", "pair_train_dx", "pair_train_dw", "bn_relu_forward",
                      "bn_relu_backward")
MEMORY_TOP = 12  # the largest allocations printed at a step's peak


def bound(nbytes: float = 0.0, ops: float = 0.0, peak: float = BF16_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); the port's smoke run needs the card")
    if not os.path.isdir(os.path.join(ROOT, "protnote_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(protnote_tpu_torch/ not found beside this script)")
    from protnote_tpu_torch.ops.kernels import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("device", name=torch.cuda.get_device_name(0), card=card_line(),
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], count=torch.cuda.device_count())


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from protnote_tpu_torch.ops.kernels import load_kernel_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(load_kernel_library, KERNEL_SOURCES))
    for lib in libs:
        ptxas = [line.strip() for line in lib.build_log.splitlines()
                 if "registers" in line or "spill" in line]
        log("build", library=os.path.relpath(lib.path, ROOT),
            seconds=lib.build_seconds, ptxas=ptxas)
    log("build_all", wall_seconds=time.perf_counter() - t0)


def random_folded(gen, d: int, hidden: int, n_hidden: int, device):
    """Folded output-MLP weights with He-uniform scales, so activations keep
    their size through the layers and the logits are O(1)."""
    import torch

    from protnote_tpu_torch.ops.pair_scorer import FoldedOutputMLP

    def u(shape, fan_in):
        bound = (6.0 / fan_in) ** 0.5
        return ((torch.rand(shape, generator=gen) * 2 - 1) * bound).to(device)

    bf16 = torch.bfloat16
    return FoldedOutputMLP(
        w1_p=u((d, hidden), 2 * d).to(bf16), w1_l=u((d, hidden), 2 * d).to(bf16),
        b1=(0.1 * u((hidden,), 2 * d)).to(bf16), w1_prod=None,
        hidden=[(u((hidden, hidden), hidden).to(bf16),
                 (0.1 * u((hidden,), hidden)).to(bf16)) for _ in range(n_hidden)],
        w_out=u((hidden,), hidden).to(bf16),
        b_out=torch.tensor(-0.5, device=device),
    )


def phase_kernel(card: str):
    """K1 at full width against the plain version on the same inputs."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    folded = random_folded(gen, D_LATENT, H, 2, dev)
    P_e = torch.randn(B, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        got = ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE)
        want = ps.pair_logits_tiled_reference(folded, P_e, L_e, LABEL_TILE)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("kernel logits are not all finite")
        err = (got - want).abs().max().item()
        perr = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
        log("kernel_check", shape=list(got.shape), max_abs_logit_err=err,
            max_abs_prob_err=perr, logit_atol=LOGIT_ATOL, prob_atol=PROB_ATOL,
            logit_std=want.std().item())
        if not (err <= LOGIT_ATOL and perr <= PROB_ATOL):
            raise AssertionError(f"kernel disagrees with the plain version: "
                                 f"logit {err} (atol {LOGIT_ATOL}), prob {perr} "
                                 f"(atol {PROB_ATOL})")
        ms = cuda_time_ms(lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE), 3)
        plain_ms = cuda_time_ms(
            lambda: ps.pair_logits_tiled_reference(folded, P_e, L_e, LABEL_TILE), 2)
        parts = k1_parts(folded, P_e, L_e)
    flop = 2.0 * 2 * H * H * B * L_e.shape[0]
    log("kernel_time", ms=ms, plain_ms=plain_ms, tflops=flop / ms / 1e9,
        plain_tflops=flop / plain_ms / 1e9, launches_a_batch=len(parts["plan"].launches()),
        chunk_labels=parts["plan"].chunk, block_n=parts["plan"].block_n, card=card)
    log("kernel_parts", **{k: v for k, v in parts.items() if k != "plan"},
        gemm_tflops=flop / parts["gemm_ms"] / 1e9, card=card)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(ops=flop),
            "library_ms": None}


def ptxas_by_kernel(build_log: str, pattern: str) -> list:
    """(the regex groups of a kernel's mangled name, its ptxas registers
    line, its spill line) for each kernel of a build log whose name matches
    ``pattern``."""
    import re

    out, name, spills = [], None, None
    for line in build_log.splitlines():
        m = re.search(pattern, line)
        if m:
            name = m.groups()
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            out.append((name, line.strip(), spills))
            name = None
    return out


def k1_variants():
    """Each of K1's compiled variants (column tile, where A comes from, where
    the epilogue goes): its ptxas registers, barriers and spills, and the
    dynamic shared memory its launch asks for."""
    import ctypes

    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("pair_scorer")
    smem = lib.lib.pair_mlp_layer_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    out = []
    for (bn, formed, dot), ptxas, spills in ptxas_by_kernel(
            lib.build_log, r"pair_mlp_layer_kernelILi(\d+)ELb([01])ELb([01])E"):
        bn, formed, dot = int(bn), formed == "1", dot == "1"
        out.append({"block_n": bn, "a": "formed" if formed else "read",
                    "epilogue": "dot" if dot else "store", "ptxas": ptxas,
                    "spills": spills, "smem_bytes": smem(bn, int(formed) | 2 * int(dot))})
    return out


def k1_parts(folded, P_e, L_e):
    """K1 in parts at full width: the first-layer launch (A formed from a and
    c, bf16 store) and the last-layer launch (A from the workspace, dot with
    w_out) of one full chunk, each from CUDA events and scaled to the batch's
    chunks, beside the other two launch modes; the whole call at other chunk
    sizes; the float32 side products; and the cuBLAS yardstick:
    ``torch.matmul`` on the two H x H products over materialised bf16
    activations of the same pair rows (``gemm_ms``, not the same function:
    no a + c, bias, ReLU or w_out, and the activations in device memory)."""
    import dataclasses

    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    # the four launch modes on one full chunk: (A formed | A read) x (store |
    # dot); three hidden layers give modes 1, 0, 2, one gives mode 3
    (W1, b1), (W2, b2) = folded.hidden
    modes = {}
    for hidden, layers in (([(W1, b1), (W2, b2), (W1, b1)], ((0, 1), (1, 0), (2, 2))),
                           ([(W1, b1)], ((0, 3),))):
        k = ps._K1Kernel(dataclasses.replace(folded, hidden=hidden), P_e, L_e, torch.bfloat16)
        ch = k.plan.chunks[0]
        logits = k.new_logits()
        with torch.cuda.device(P_e.device):
            for i, mode in layers:
                modes[mode] = cuda_time_ms(lambda: k.launch(ch, i, mode, logits), 20)
        del k, logits
    first, last = modes[1], modes[2]
    plan = ps.launch_plan(B, L_e.shape[0], H, 2,
                          torch.cuda.get_device_properties(P_e.device).multi_processor_count)
    rows = B * L_e.shape[0]
    chunk_rows = B * plan.chunks[0].nl_pad
    # chunk sizes in turns (A B C C B A), each the mean of its two readings
    by_chunk, default = {}, ps.TARGET_ROWS
    try:
        for target in (8192, 16384, 32768, 32768, 16384, 8192):
            ps.TARGET_ROWS = target
            by_chunk.setdefault(target, []).append(cuda_time_ms(
                lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e), 3))
    finally:
        ps.TARGET_ROWS = default
    by_chunk = {k: sum(v) / len(v) for k, v in by_chunk.items()}
    # outside the launches: the float32 per-side products a = P_e @ W1p and
    # c = L_e @ W1l + b1, which the wrapper computes first (as the JAX path)
    side_ms = cuda_time_ms(lambda: ps._side_partials(folded, P_e, L_e, torch.bfloat16), 5)
    # one profiled call: device busy time against the wall, and by kernel
    wall, busy, top = device_profile(lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e), 2)
    profile = {"wall_ms_per_call": wall * 1e3 / 2,
               "device_busy_ms_per_call": None if busy is None else busy * 1e3 / 2,
               "top_kernels_ms_per_call": top}
    x = torch.randn(chunk_rows, H, device=P_e.device).to(torch.bfloat16)
    W = folded.hidden[0][0].contiguous()
    product = cuda_time_ms(lambda: torch.matmul(x, W), 20)
    return {"plan": plan, "variants": k1_variants(), "chunk_rows": chunk_rows,
            "first_layer_launch_ms": first, "last_layer_launch_ms": last,
            "launch_ms_by_mode": {"read_store": modes[0], "formed_store": modes[1],
                                  "read_dot": modes[2], "formed_dot": modes[3]},
            "first_layer_batch_ms": first * rows / chunk_rows,
            "last_layer_batch_ms": last * rows / chunk_rows,
            "ms_by_target_rows": by_chunk, "side_partials_ms": side_ms, "profile": profile,
            "gemm_product_ms": product,
            "gemm_ms": 2 * product * rows / chunk_rows}


def he_scale_linears(tree) -> None:
    """Scale every Linear kernel of a ProtNote tree from the default init
    (bound 1/sqrt(fan_in)) to He-uniform (sqrt(6/fan_in)), so activations keep
    their size and the logits spread over O(1) instead of collapsing onto
    b_out: the parity check then compares logits that differ."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "kernel" and v.dim() == 2:
                v.mul_(6 ** 0.5)
            else:
                he_scale_linears(v)
    elif isinstance(tree, list):
        for v in tree:
            he_scale_linears(v)


def random_models():
    """Full-width configs (configs/base.yaml, bf16) and seeded random
    weights, the ProtNote linears He-scaled."""
    import torch

    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer

    pi_cfg = ProteInferConfig(compute_dtype=torch.bfloat16)
    pn_cfg = ProtNoteConfig.from_params(
        {}, protein_embedding_dim=pi_cfg.output_channels, label_embedding_dim=D_LATENT,
        inference_descriptions_per_label=K_DESCRIPTIONS, label_tile=LABEL_TILE,
        compute_dtype=torch.bfloat16)
    pi_params, pi_state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_params, pn_state = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    he_scale_linears(pn_params)
    ts = {"trainable": {"protnote": pn_params}, "model_state": pn_state,
          "enc_params": pi_params, "enc_state": pi_state}
    return pi_cfg, pn_cfg, ts


def random_label_matrix():
    """(32,102 x 2, 1024) float32 label-embedding rows from a fixed seed."""
    import torch

    gen = torch.Generator().manual_seed(2)
    return torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT, generator=gen).numpy()


def build_engine():
    import numpy as np
    import torch

    from protnote_tpu_torch.serving import ServingEngine

    pi_cfg, pn_cfg, ts = random_models()
    matrix = random_label_matrix()
    vocab = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    t0 = time.perf_counter()
    engine = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, buckets=(512, 1024),
                           max_batch=B, device="cuda")
    torch.cuda.synchronize()
    return engine, time.perf_counter() - t0, np.random.default_rng(3)


def random_sequences(rng, lengths):
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    return ["".join(rng.choice(aas, n)) for n in lengths]


def tensors_of(tree):
    import torch

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def post(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = json.loads(resp.read())
    return body, (time.perf_counter() - t0) * 1e3


def phase_serving(engine, rng, card: str):
    """Drive the engine through the HTTP front end; count K1's launches and
    the batches (one encoder pass each); then time full batches and the
    encoder alone."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.serving import make_http_server

    torch.cuda.reset_peak_memory_stats()
    placed = tensors_of(engine.ts) + [engine.latents]
    if not all(t.device.type == "cuda" for t in placed):
        raise AssertionError("engine tensors are not all on cuda")
    engine.warmup()
    torch.cuda.synchronize()
    requests = [random_sequences(rng, [300]),
                random_sequences(rng, [50, 200, 511, 700, 1500]),
                random_sequences(rng, [900])]
    server, batcher = make_http_server(engine, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    stats0 = engine.stats.snapshot()
    ps.LAUNCHES = 0
    reset_k7_launches()
    try:
        latencies = []
        for seqs in requests:
            body, ms = post(url + "/v1/predict", {"sequences": seqs, "top_k": 10})
            latencies.append(ms)
            preds = body["predictions"]
            if len(preds) != len(seqs) or any(len(p) != 10 for p in preds):
                raise AssertionError(f"top-k shapes wrong: {[len(p) for p in preds]}")
            probs = np.array([p for row in preds for _, p in row])
            if not (np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()):
                raise AssertionError("top-k probabilities not finite in (0, 1)")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        launches = ps.LAUNCHES
        k7_launches = dict(k7.LAUNCHES)
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    if health.get("status") != "ok" or health.get("labels") != NUM_LABELS:
        raise AssertionError(f"bad /healthz: {health}")
    if launches <= 0:
        raise AssertionError("the serving path never launched the K1 kernel")
    check_k7_forward(k7_launches, "serving")
    batches = health["batches"] - stats0["batches"]
    n_seqs = sum(len(r) for r in requests)
    log("serving", requests=len(requests), sequences=n_seqs, batches=batches,
        k1_launches=launches, k7_launches=k7_launches, request_ms=latencies,
        batch_ms=(health["total_device_ms"] - stats0["total_device_ms"]) / batches,
        device=str(engine.device), card=card)

    # full batches through the engine: latency per batch and seqs/s
    full = random_sequences(rng, rng.integers(100, 512, size=B))
    engine.score(full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        engine.score(full)
    sec = (time.perf_counter() - t0) / reps
    log("serving_full_batch", batch=B, bucket=512, batch_ms=sec * 1e3,
        seqs_per_s=B / sec, pair_scores_per_s=B * NUM_LABELS * K_DESCRIPTIONS / sec,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, card=card)
    return phase_encoder(engine, full, batches, card)


def reset_k7_launches() -> None:
    from protnote_tpu_torch.ops import masked_conv as k7

    for name in k7.LAUNCHES:
        k7.LAUNCHES[name] = 0


def decomposed_launches() -> dict:
    """The launches of the decomposed scorer's kernels (K4, K4-bwd, K5)
    since the counts were set to 0; raises if the run launched a K6 kernel
    (the streamed scorer is off on those paths)."""
    from protnote_tpu_torch.ops import streaming_train as st

    if any(st.LAUNCHES.get(k, 0) for k in K6_KERNELS):  # 0 in a tree without K6
        raise AssertionError(f"a decomposed-scorer run launched K6: {st.LAUNCHES}")
    return {k: st.LAUNCHES[k] for k in DECOMPOSED_KERNELS}


def check_k7_forward(launches: dict, path: str) -> None:
    """The path ran K7's forward kernels, and no backward one."""
    if any(launches[k] <= 0 for k in K7_FORWARD):
        raise AssertionError(f"the {path} path skipped K7's forward: {launches}")
    if any(v for k, v in launches.items() if k not in K7_FORWARD):
        raise AssertionError(f"the {path} path launched a K7 training kernel: {launches}")


def conv_rows(lengths, T: int, taps: int, dilation: int) -> int:
    """The (output row, tap) pairs a masked conv needs for these lengths:
    valid output rows whose shifted input row is valid too (the work
    without the taps and rows that only read the zero padding)."""
    half, n = (taps - 1) // 2, 0
    for length in lengths:
        L = min(max(int(length), 0), T)
        for j in range(taps):
            s = dilation * (j - half)
            n += max(0, min(L, L - s) - max(0, -s))
    return n


def k7_convs(params, cfg):
    """(name, parameters, dilation) of the chain's 11 convs in order."""
    out = [("conv1", params["conv1"], 1)]
    for i, bp in enumerate(params["blocks"]):
        out += [(f"block{i}_dilated", bp["conv_dilated"], cfg.dilation_base ** i),
                (f"block{i}_1x1", bp["conv_1x1"], 1)]
    return out


def k7_flops(lengths, T: int, params, cfg, skip_conv1: bool = False) -> float:
    """The bf16 products of the chain's convs for these lengths (2 x C_in x
    C_out a needed (row, tap) pair)."""
    return sum(2.0 * p["kernel"].shape[1] * p["kernel"].shape[2]
               * conv_rows(lengths, T, p["kernel"].shape[0], d)
               for name, p, d in k7_convs(params, cfg) if not (skip_conv1 and name == "conv1"))


def k7_eval_calls(params, state, onehot, lengths, cfg):
    """The eval chain through K7's kernels, recording the arguments of each
    ``masked_conv_forward`` call (positional: those of the plain version;
    keyword: the cached weight layout): ``(calls, the last block's
    output)``."""
    from protnote_tpu_torch.models.proteinfer import proteinfer_embed
    from protnote_tpu_torch.ops import masked_conv as k7

    calls, kernel = [], k7.masked_conv_cuda

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    k7.masked_conv_cuda = record
    try:
        proteinfer_embed(params, state, onehot, lengths, cfg)
    finally:
        k7.masked_conv_cuda = kernel
    if len(calls) != 1 + 2 * cfg.num_resnet_blocks:
        raise AssertionError(f"the eval chain made {len(calls)} conv calls")
    args, kwargs = calls[-1]
    return calls, kernel(*args, **kwargs)


def k7_ptxas(library: str) -> dict:
    """The ptxas registers and spills of the conv mainloop's modes (0 the
    forward, 1 with the BN prologue, 2 dX) in a library's build log."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    return {f"mode{m}": [regs, spills] for (m,), regs, spills in ptxas_by_kernel(
        load_kernel_library(library).build_log, r"conv_tma_kernelILi(\d)E")}


def rel_max(got, want) -> tuple:
    """(max |got - want|, that over the largest |want|)."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def phase_encoder(engine, seqs, passes: int, card: str):
    """K7's forward chain as the port runs it (``embed_from_ids``: 11
    ``masked_conv_forward`` launches with the eval-mode BN + ReLU prologue
    and the bias/mask/residual epilogue, then ``masked_mean_pool``) for one
    32-sequence batch at buckets 512 and 1024, beside the plain chain (the
    cuDNN conv1d chain of the ``*_reference`` functions), its pooled
    embeddings against the plain chain's; then the 11 conv launches alone on
    their recorded inputs against the plain convs on the same inputs and the
    11 cuDNN conv1d calls alone (the library time), and the pool alone.
    The chain is timed with a new lengths tensor a call (the lengths' read-
    back and the tile plans in the time, as a serving batch pays them) and
    with one kept (plans built once).  Bounds: the convs' products for these
    lengths (taps and rows that only read padding left out) over the bf16
    peak, and the padded count beside it; the pool's bytes over the memory
    rate.  The conv mainloop's ptxas registers and spills beside."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.proteinfer import (
        embed_from_ids,
        one_hot_sequences,
        proteinfer_embed_reference,
    )
    from protnote_tpu_torch.ops import masked_conv as k7

    cfg, ts = engine.pi_cfg, engine.ts
    params, state = ts["enc_params"], ts["enc_state"]
    C, Cb, k = cfg.output_channels, cfg.bottleneck_channels, cfg.kernel_size
    out = {}
    with torch.inference_mode():
        for bucket in (512, 1024):
            aa, lens = engine._assemble(engine._encode(seqs), bucket)
            aa, lengths = torch.from_numpy(aa).cuda(), torch.from_numpy(lens).cuda()
            onehot = one_hot_sequences(aa, cfg.input_channels, torch.bfloat16)
            # a new lengths tensor a call, as a serving batch brings: the
            # read-back of the lengths and the tile plans are in the time
            ms = cuda_time_ms(lambda: embed_from_ids(params, state, aa, lengths.clone(), cfg), 10)
            cached_ms = cuda_time_ms(lambda: embed_from_ids(params, state, aa, lengths, cfg), 10)
            plain_ms = cuda_time_ms(lambda: proteinfer_embed_reference(
                params, state, onehot, lengths, cfg), 10)
            got, _ = embed_from_ids(params, state, aa, lengths, cfg)
            want, _ = proteinfer_embed_reference(params, state, onehot, lengths, cfg)
            pooled_err, pooled_rel = rel_max(got, want)
            calls, feats = k7_eval_calls(params, state, onehot, lengths, cfg)
            conv_errs = [rel_max(k7.masked_conv_cuda(*a, **kw), k7.masked_conv_reference(*a))
                         for a, kw in calls]
            conv_ms = cuda_time_ms(lambda: [k7.masked_conv_cuda(*a, **kw) for a, kw in calls], 10)
            conv_plain_ms = cuda_time_ms(
                lambda: [k7.masked_conv_reference(*a) for a, _ in calls], 10)
            pool_err = rel_max(k7.masked_mean_pool_cuda(feats, lengths),
                               k7.masked_mean_pool_reference(feats, lengths))
            pool_ms = cuda_time_ms(lambda: k7.masked_mean_pool_cuda(feats, lengths), 20)
            pool_plain_ms = cuda_time_ms(lambda: k7.masked_mean_pool_reference(feats, lengths),
                                         20)
            flop = k7_flops(lens, bucket, params, cfg)
            flop_padded = 2.0 * B * bucket * (cfg.input_channels * C * k
                                              + cfg.num_resnet_blocks * (C * Cb * k + Cb * C))
            valid = int(np.minimum(lens, bucket).sum())
            conv = {"max_abs_err": max(e for e, _ in conv_errs),
                    "max_rel_err": max(r for _, r in conv_errs), "ms": conv_ms,
                    "plain_ms": conv_plain_ms, **bound(ops=flop),
                    "library_ms": conv_alone_ms(params, cfg, bucket),
                    "tflops": flop / conv_ms / 1e9}
            conv["share_of_bound"] = conv["bound_ms"] / conv_ms
            pool = {"max_abs_err": pool_err[0], "ms": pool_ms, "plain_ms": pool_plain_ms,
                    **bound(nbytes=2.0 * valid * C + 4.0 * B + 4.0 * B * C),
                    "library_ms": None}
            out[bucket] = {"chain_ms": ms, "chain_cached_plans_ms": cached_ms,
                           "chain_plain_ms": plain_ms,
                           "pooled_max_abs_err": pooled_err, "pooled_rel_err": pooled_rel,
                           "chain_bound_ms": bound(ops=flop)["bound_ms"],
                           "padded_bound_ms": bound(ops=flop_padded)["bound_ms"],
                           "valid_rows": valid, "masked_conv_fwd": conv,
                           "masked_mean_pool": pool}
            if pooled_rel > K7_POOLED_REL_TOL or conv["max_rel_err"] > K45_REL_TOL \
                    or pool_err[1] > K7_F32_REL_TOL:
                raise AssertionError(f"K7's forward disagrees with its plain version at "
                                     f"bucket {bucket}: {out[bucket]}")
    log("encoder", batch=B, passes_on_serving_path=passes, buckets=out,
        rel_tol={"pooled": K7_POOLED_REL_TOL, "conv": K45_REL_TOL, "pool": K7_F32_REL_TOL},
        ptxas=k7_ptxas("masked_conv"), card=card)
    return out


def conv_alone_ms(enc_params, cfg, bucket: int) -> float:
    """The chain's 11 cuDNN conv1d calls alone (the first conv, then each
    block's dilated conv and 1 x 1 conv), one pass on bf16 inputs of the
    shapes a 32-sequence batch gives them at ``bucket``: the library time of
    K7's forward, without the masks, biases, BatchNorms, ReLUs, residuals and
    pooling around them.  The port never calls it."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(14)
    calls = []
    for _, p, dilation in k7_convs(enc_params, cfg):
        w = p["kernel"].permute(2, 1, 0).contiguous().to(torch.bfloat16)  # (cout, cin, k)
        x = torch.randn((B, w.shape[1], bucket), device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        calls.append((x, w, dilation * (w.shape[-1] - 1) // 2, dilation))
    return cuda_time_ms(lambda: [F.conv1d(x, w, padding=pad, dilation=d)
                                 for x, w, pad, d in calls], 10)


def plain_probs(engine, seqs, latents=None):
    """(n, labels) probabilities of ``seqs`` through a forward with the plain
    pair scorer (bf16 or int8, as the engine's backend) on the engine's
    device tensors (or on ``latents`` in place of the engine's)."""
    import torch

    from protnote_tpu_torch.models.fusion import ensemble_logits, projection_head_apply
    from protnote_tpu_torch.models.proteinfer import embed_from_ids
    from protnote_tpu_torch.ops import pair_scorer as ps

    aa, lengths = engine._assemble(engine._encode(seqs), 512)
    ts, cfg = engine.ts, engine.pn_cfg
    pn, state = ts["trainable"]["protnote"], ts["model_state"]
    with torch.inference_mode():
        P_f, _ = embed_from_ids(ts["enc_params"], ts["enc_state"],
                                torch.from_numpy(aa).cuda(), torch.from_numpy(lengths).cuda(),
                                engine.pi_cfg)
        P_e, _ = projection_head_apply(pn["W_p"], state["W_p"], P_f.to(cfg.compute_dtype))
        folded = ps.fold_output_mlp(pn["output_mlp"], state["output_mlp"], cfg.feature_fusion,
                                    cfg.latent_dim, dtype=cfg.compute_dtype)
        latents = engine.latents if latents is None else latents
        if cfg.pair_backend == "tiled_int8":
            logits = ps.pair_logits_tiled_int8_reference(
                ps.quantize_folded(folded, act_scales=cfg.int8_act_scales), P_e,
                latents, cfg.label_tile, cfg.compute_dtype)
        else:
            logits = ps.pair_logits_tiled_reference(folded, P_e, latents,
                                                    cfg.label_tile, cfg.compute_dtype)
        want = torch.sigmoid(ensemble_logits(logits, K_DESCRIPTIONS))[: len(seqs)]
    return want.float().cpu().numpy()


def phase_parity(engine, rng, name="serving_parity"):
    """engine.score against a forward through the plain pair scorer on the
    same device tensors (the engine reads logits back in f16)."""
    import numpy as np

    seqs = random_sequences(rng, [120, 333, 480, 77])
    got = engine.score(seqs)
    want = plain_probs(engine, seqs)
    err = float(np.abs(got - want).max())
    log(name, sequences=len(seqs), max_abs_prob_err=err, prob_atol=PROB_ATOL,
        prob_std=float(want.std()))
    if not (np.isfinite(got).all() and err <= PROB_ATOL):
        raise AssertionError(f"engine disagrees with the plain forward: {err}")
    return seqs, got


def phase_k2(card: str):
    """K2 alone at full serving width, static and dynamic scales, against
    its plain version on the same device tensors; its launches in parts;
    the code pass and the row-scale pass alone against their plain
    versions; ``torch._int_mm`` on the GEMM shapes."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    folded = random_folded(gen, D_LATENT, H, 2, dev)
    P_e = torch.randn(B, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    rows = B * L_e.shape[0]
    ops = 2.0 * 2 * rows * H * H
    out = {}
    with torch.inference_mode():
        t0 = time.perf_counter()
        scales = ps.calibrate_act_scales(folded, P_e, L_e, LABEL_TILE)
        calib_s = time.perf_counter() - t0
        qs = {"static": ps.quantize_folded(folded, act_scales=scales),
              "dynamic": ps.quantize_folded(folded)}
        for mode, q in qs.items():
            got = ps.pair_logits_tiled_int8_cuda(q, P_e, L_e, LABEL_TILE)
            want = ps.pair_logits_tiled_int8_reference(q, P_e, L_e, LABEL_TILE)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K2 ({mode}) logits are not all finite")
            err = (got - want).abs().max().item()
            perr = (torch.sigmoid(got) - torch.sigmoid(want)).abs().max().item()
            differ = total = 0
            for l0, nl in K2_CHUNKS:
                mine = ps.int8_carry_cuda(q, P_e, L_e, l0, nl)
                theirs = ps.int8_carry_reference(q, P_e, L_e, l0, nl)
                differ += int((mine != theirs).sum())
                total += mine.numel()
            del got, want, mine, theirs
            ms = cuda_time_ms(lambda: ps.pair_logits_tiled_int8_cuda(q, P_e, L_e, LABEL_TILE), 3)
            plain_ms = cuda_time_ms(
                lambda: ps.pair_logits_tiled_int8_reference(q, P_e, L_e, LABEL_TILE), 1)
            out[mode] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            log("k2_check", mode=mode, shape=[B, L_e.shape[0]], hidden=H,
                scales=list(q.act_scales or ()), max_abs_logit_err=err, max_abs_prob_err=perr,
                logit_atol=LOGIT_ATOL, prob_atol=PROB_ATOL, carried=total,
                carried_differ=differ, ms=ms, plain_ms=plain_ms, tops=ops / ms / 1e9,
                bound_ms=ops / INT8_OPS * 1e3, calibrate_s=calib_s, card=card)
            if not (err <= LOGIT_ATOL and perr <= PROB_ATOL and differ == 0):
                raise AssertionError(f"K2 ({mode}) disagrees with the plain version: logit "
                                     f"{err}, prob {perr}, {differ} carried values differ")
        parts = k2_parts(qs, P_e, L_e)
        codes = k2_codes(qs["static"], P_e, L_e)
        rs = k2_row_scale(qs["dynamic"], P_e, L_e)
        # the yardstick: the same int8 GEMMs as one library call each, with
        # W row-major as the plain version holds it and column-major as K2
        # takes it; the faster counts
        A = torch.randint(-127, 128, (B * LABEL_TILE, H), dtype=torch.int8, device=dev)
        Wq = qs["static"].hidden_q[0][0]
        Wt = Wq.t().contiguous().t()
        n_products = 2 * -(-L_e.shape[0] // LABEL_TILE)
        int_mm = {layout: cuda_time_ms(lambda: torch._int_mm(A, w), 20) * n_products
                  for layout, w in (("row_major", Wq), ("col_major", Wt))}
        library_ms = min(int_mm.values())
    log("k2_time", static_ms=out["static"]["ms"], dynamic_ms=out["dynamic"]["ms"],
        static_plain_ms=out["static"]["plain_ms"], dynamic_plain_ms=out["dynamic"]["plain_ms"],
        int_mm_ms=int_mm, int_mm_products=n_products, bound_ms=ops / INT8_OPS * 1e3,
        codes_ms=codes["ms"], codes_plain_ms=codes["plain_ms"],
        row_scale_ms=rs["ms"], row_scale_plain_ms=rs["plain_ms"], card=card)
    log("k2_parts", **parts, card=card)
    layer = {"max_abs_err": max(v["max_abs_err"] for v in out.values()),
             "ms": out["static"]["ms"], "plain_ms": out["static"]["plain_ms"],
             **bound(ops=ops, peak=INT8_OPS), "library_ms": library_ms}
    return {"pair_int8_layer": layer, "pair_int8_codes": codes, "pair_int8_row_scale": rs}


def k2_variants():
    """Each of K2's compiled GEMM variants (column tile, epilogue, dynamic):
    its ptxas registers, barriers and spills, and its dynamic shared
    memory."""
    import ctypes
    import re

    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("pair_scorer_int8")
    smem = lib.lib.pair_int8_layer_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    out, name, spills = [], None, None
    for line in lib.build_log.splitlines():
        m = re.search(r"pair_int8_layer_kernelILi(\d+)ELi(\d)ELb([01])E", line)
        if m:
            name = (int(m.group(1)), int(m.group(2)), m.group(3) == "1")
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            bn, epi, dyn = name
            out.append({"block_n": bn, "epilogue": ("codes", "bf16", "dot")[epi],
                        "dynamic": dyn, "ptxas": line.strip(), "spills": spills,
                        "smem_bytes": smem(bn, epi)})
            name = None
    return out


def k2_parts(qs, P_e, L_e):
    """K2 in parts at full width: each launch of one full chunk alone, from
    CUDA events (static: the code pass, the GEMM with the code epilogue,
    the GEMM with the dot; dynamic: the row-scale pass from a and c and
    from bf16 rows, the GEMM with the bf16 epilogue, the GEMM with the
    dot), each also scaled to the batch's chunks; and one profiled call of
    each mode."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    launches = {}
    for mode, q in qs.items():
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
        ch = k.plan.chunks[0]
        logits = k.new_logits()
        with torch.cuda.device(P_e.device):
            for i in range(2):
                k.quantize(ch, i if mode == "dynamic" else 0)
                launches[f"{mode}_{'row_scale' if mode == 'dynamic' else 'codes'}_{i}"] = \
                    cuda_time_ms(lambda: k.quantize(ch, i if mode == "dynamic" else 0), 20)
                launches[f"{mode}_layer_{i}"] = cuda_time_ms(lambda: k.layer(ch, i, logits), 20)
        chunk_rows = B * ch.nl_pad
        del k, logits
    launches.pop("static_codes_1")  # the code pass runs for layer 1 only
    batch = {name: ms * B * L_e.shape[0] / chunk_rows for name, ms in launches.items()}
    layer_tops = {name: 2.0 * chunk_rows * H * H / ms / 1e9
                  for name, ms in launches.items() if "layer" in name}
    # one profiled call of each mode: device busy time against the wall, and
    # by kernel (the launches above are timed back to back from the host)
    profile = {}
    for mode, q in qs.items():
        wall, busy, top = device_profile(lambda: ps.pair_logits_tiled_int8_cuda(q, P_e, L_e), 1)
        profile[mode] = {"wall_ms": wall * 1e3,
                         "device_busy_ms": None if busy is None else busy * 1e3,
                         "top_kernels_ms": top}
    return {"variants": k2_variants(), "chunk_rows": chunk_rows, "launch_ms": launches,
            "batch_ms": batch, "layer_tops": layer_tops, "profile": profile}


def k2_codes(q, P_e, L_e):
    """Layer 1's static code pass alone: against ``int8_codes_reference``
    on the first and the ragged last chunk of the plan, element by element,
    and the time of its launches over a batch's chunks."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
    s0 = q.act_scales[0]
    differ, err = 0, 0
    with torch.cuda.device(P_e.device):
        for ch in (k.plan.chunks[0], k.plan.chunks[-1]):
            k.quantize(ch, 0)
            want = ps.int8_codes_reference(k.a, k.c, ch, s0)
            got = k.codes[0][:B * ch.nl_pad]
            differ += int((got != want).sum())
            err = max(err, int((got.int() - want.int()).abs().max()))

        def kernel_pass():
            for ch in k.plan.chunks:
                k.quantize(ch, 0)

        def plain_pass():
            for ch in k.plan.chunks:
                ps.int8_codes_reference(k.a, k.c, ch, s0)

        ms = cuda_time_ms(kernel_pass, 3)
        plain_ms = cuda_time_ms(plain_pass, 1)
    log("k2_codes_check", chunks=2, codes_differ=differ, max_abs_err=err)
    if differ or err:
        raise AssertionError(f"the code pass disagrees with its plain version: {differ} codes, "
                             f"largest difference {err}")
    # bytes the function needs: a and c read once, one code a pair element
    L_rows = L_e.shape[0]
    nbytes = 4.0 * (B + L_rows) * H + 1.0 * B * L_rows * H
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, **bound(nbytes=nbytes),
            "library_ms": None}


def k2_row_scale(q, P_e, L_e):
    """The row-scale pass alone: its scales and codes against
    ``int8_row_scale_reference`` on the first and the ragged last chunk
    (layer 1 from a and c, layer 2 from the kernel's bf16 carry), and the
    time of its 2 x chunks launches of a batch."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
    err, differ = 0.0, 0
    with torch.cuda.device(P_e.device):
        for ch in (k.plan.chunks[0], k.plan.chunks[-1]):
            rows = B * ch.nl_pad
            for i in range(2):
                k.quantize(ch, i)
                x = ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16) if i == 0 else k.h[:rows]
                want_s, want = ps.int8_row_scale_reference(x)
                err = max(err, float((k.row_scale[:rows] - want_s).abs().max()))
                differ += int((k.codes[0][:rows] != want).sum())
                if i == 0:
                    k.layer(ch, 0, None)  # the bf16 carry layer 2 reads

        def kernel_pass():
            for ch in k.plan.chunks:
                k.quantize(ch, 0)
                k.quantize(ch, 1)

        def plain_pass():
            for ch in k.plan.chunks:
                ps.int8_row_scale_reference(ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16))
                ps.int8_row_scale_reference(k.h[:B * ch.nl_pad])

        ms = cuda_time_ms(kernel_pass, 3)
        plain_ms = cuda_time_ms(plain_pass, 1)
    log("k2_row_scale_check", chunks=2, max_abs_err=err, codes_differ=differ)
    if err != 0.0 or differ:
        raise AssertionError(f"the row-scale pass disagrees with its plain version: scales "
                             f"{err}, {differ} codes")
    # bytes the function needs: a and c (layer 1) and the bf16 carry (layer
    # 2) read once, one code a pair element and one float32 scale a row out
    # per layer
    L_rows = L_e.shape[0]
    rows = B * L_rows
    nbytes = 4.0 * (B + L_rows) * H + 2.0 * rows * H + 2 * (1.0 * rows * H + 4.0 * rows)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(nbytes=nbytes),
            "library_ms": None}


def reset_int8_launches():
    from protnote_tpu_torch.ops import pair_scorer as ps

    for name in ps.INT8_LAUNCHES:
        ps.INT8_LAUNCHES[name] = 0


def phase_int8_serving(engine, rng, drift_seqs, drift_probs, card: str):
    """A full-width int8 engine on the bf16 engine's weights: calibrated
    from random sequences, warmed up, full batches; then parity with the
    plain int8 forward and the drift from the bf16 engine's
    ``drift_probs`` on ``drift_seqs``.  Returns K2's launches."""
    import dataclasses

    import numpy as np
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    engine8 = ServingEngine(engine.ts, engine.pi_cfg,
                            dataclasses.replace(engine.pn_cfg, pair_backend="tiled_int8"),
                            random_label_matrix(), engine.label_vocabulary,
                            buckets=engine.buckets, max_batch=B, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_int8_launches()
    t0 = time.perf_counter()
    engine8.calibrate_from(random_sequences(rng, rng.integers(100, 512, size=INT8_SEQUENCES)))
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    scales = engine8.pn_cfg.int8_act_scales
    if not scales or not all(s > 0 for s in scales):
        raise AssertionError(f"calibrate_from gave no scales: {scales}")
    engine8.warmup()
    full = random_sequences(rng, rng.integers(100, 512, size=B))
    engine8.score(full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        probs = engine8.score(full)
    sec = (time.perf_counter() - t0) / reps
    launches = dict(ps.INT8_LAUNCHES)
    if launches["pair_int8_layer"] <= 0 or not np.isfinite(probs).all():
        raise AssertionError(f"int8 serving did not run through K2: {launches}")
    log("int8_serving", batch=B, bucket=512, scales=list(scales), engine_build_s=build_s,
        calibrate_s=calib_s, batch_ms=sec * 1e3, seqs_per_s=B / sec,
        pair_scores_per_s=B * NUM_LABELS * K_DESCRIPTIONS / sec,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, launches=launches, card=card)
    phase_parity(engine8, rng, "int8_serving_parity")
    got = engine8.score(drift_seqs)
    d = got - drift_probs
    log("int8_drift", sequences=len(drift_seqs), max_abs_prob_drift=float(np.abs(d).max()),
        rms_prob_drift=float(np.sqrt(np.mean(d ** 2))), prob_std=float(drift_probs.std()))
    return launches


def phase_int8_eval(card: str, bf16_metrics: dict):
    """``Trainer.evaluate`` with ``tiled_int8`` on the phase-7 FASTA,
    auto-calibrated (static), then dynamic (``INT8_CALIBRATE`` off).
    Returns K2's launches over both."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(tmp)
    pi_cfg, pn_cfg, ts = random_models()
    pn8 = dataclasses.replace(pn_cfg, pair_backend="tiled_int8")
    total = {name: 0 for name in ps.INT8_LAUNCHES}
    for mode, calibrate in (("static", True), ("dynamic", False)):
        batcher = eval_batcher(ds)
        trainer = Trainer(ts, pi_cfg, pn8, TrainerConfig(
            decision_threshold=THRESHOLD, estimate_map=True, int8_calibrate=calibrate),
            device="cuda")
        torch.cuda.synchronize()
        reset_int8_launches()
        t0 = time.perf_counter()
        metrics = trainer.evaluate(batcher)["metrics"]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(ps.INT8_LAUNCHES)
        ran = launches["pair_int8_layer"] > 0 and \
            launches["pair_int8_codes" if calibrate else "pair_int8_row_scale"] > 0
        if not ran or (trainer.pn_cfg.int8_act_scales is not None) != calibrate:
            raise AssertionError(f"int8 evaluation ({mode}) skipped a kernel or the "
                                 f"calibration: {launches}, {trainer.pn_cfg.int8_act_scales}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite int8 metrics: {metrics}")
        for name, v in launches.items():
            total[name] += v
        log("int8_eval", mode=mode, sequences=len(ds), batches=len(batcher), seconds=sec,
            seqs_per_s=len(ds) / sec, batch_ms=sec * 1e3 / len(batcher),
            scales=list(trainer.pn_cfg.int8_act_scales or ()), launches=launches,
            map_micro=metrics["map_micro"], map_macro=metrics["map_macro"],
            bf16_map_micro=bf16_metrics["map_micro"], bf16_map_macro=bf16_metrics["map_macro"],
            loss=metrics.get("loss"), card=card)
        del trainer, batcher
        torch.cuda.empty_cache()
    return total


def edge_elements(logits, valid) -> int:
    """Valid elements whose probability lies within EDGE of a bin edge
    k/NUM_BINS or of the threshold (float64, so it does not depend on either
    float32 exponential)."""
    import torch

    p = torch.sigmoid(logits.double())
    near_bin = (p * NUM_BINS - torch.round(p * NUM_BINS)).abs() / NUM_BINS < EDGE
    near_th = (p - THRESHOLD).abs() < EDGE
    return int(((near_bin | near_th) & valid).sum())


def compare_states(kern, plain, edges: int) -> dict:
    """Integer state: the sum of |delta| of each field is at most 2 x the
    edge elements (one element on the other side of an edge moves two
    counts).  When every integer field agrees, both sides summed the same
    float32 terms, and the sums must agree to SUM_RTOL."""
    deltas = {}
    for k, v in plain.items():
        if v.dtype.is_floating_point:
            deltas[k] = abs(float(kern[k]) - float(v))
        else:
            deltas[k] = int((kern[k].long() - v.long()).abs().sum())
            if deltas[k] > 2 * edges:
                raise AssertionError(f"K3 state {k}: |delta| {deltas[k]} exceeds 2 x "
                                     f"{edges} edge elements")
    if all(deltas[k] == 0 for k, v in plain.items() if not v.dtype.is_floating_point):
        for k, v in plain.items():
            if v.dtype.is_floating_point and deltas[k] > SUM_RTOL * abs(float(v)):
                raise AssertionError(f"K3 state {k}: kernel {float(kern[k])} vs plain "
                                     f"{float(v)} (rtol {SUM_RTOL})")
    return deltas


def int_delta(deltas: dict) -> int:
    return max(v for k, v in deltas.items() if not k.endswith("_sum"))


def k3_batches(gen, dev):
    """8 full-width batches: 1-3 padded rows each, a label_mask with zeros,
    and the last batch a K3_SUBSET-label subset padded to K3_SUBSET_WIDTH
    columns (the cols path).  Logits spread over (-6, 6); about 1%
    positives."""
    import torch

    out = []
    for i in range(8):
        em = torch.ones(B)
        em[B - 1 - i % 3 :] = 0
        if i == 7:
            li = torch.randperm(NUM_LABELS, generator=gen)[:K3_SUBSET].sort().values.numpy()
            lm = torch.cat([torch.ones(K3_SUBSET), torch.zeros(K3_SUBSET_WIDTH - K3_SUBSET)])
        else:
            li, lm = None, (torch.rand(NUM_LABELS, generator=gen) < 0.98).float()
        logits = torch.randn(B, lm.numel(), generator=gen) * 2.0
        targets = (torch.rand(B, lm.numel(), generator=gen) < 0.01).float()
        out.append(([t.to(dev) for t in (logits, targets, em, lm)], li))
    return out


def phase_k3(card: str):
    """K3's two entry points at full width against the plain version on the
    same tensors: the update (one launch a batch, the row tail folded in)
    and the finalize (a warp a label)."""
    import torch

    from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    dev = torch.device("cuda")
    batches = k3_batches(torch.Generator().manual_seed(4), dev)
    kern = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev)
    plain = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev)
    edges = 0
    for (logits, targets, em, lm), li in batches:
        cols = kern.cols_for(li, logits.shape[1])
        kern.update_fn(kern.state, logits, targets, em, lm, cols)
        k3.update_reference(plain.state, logits, targets, em, lm, cols, THRESHOLD, NUM_BINS)
        edges += edge_elements(logits, (em[:, None] > 0) & (lm[None, :] > 0))
    torch.cuda.synchronize()
    deltas = compare_states(kern.state, plain.state, edges)
    if int(kern._scratch.abs().sum()) != 0:
        raise AssertionError("K3's update left its row-count scratch non-zero")
    # finalize: kernel and plain version on the same histograms
    ap, npos, out = k3.finalize_cuda(kern.state["hist"], NUM_LABELS, NUM_BINS)
    ap_p, npos_p, out_p = k3.finalize_reference(kern.state["hist"], NUM_LABELS, NUM_BINS)
    torch.cuda.synchronize()
    ap_err = float((ap - ap_p).abs().max())
    out_err = float((out - out_p).abs().max())
    if not (torch.isfinite(out).all() and ap_err <= AP_ATOL and out_err <= AP_ATOL
            and torch.equal(npos, npos_p)):
        raise AssertionError(f"K3 finalize disagrees: per-label AP {ap_err}, "
                             f"micro/macro {out_err} (atol {AP_ATOL})")
    int_err = int_delta(deltas)
    log("k3_check", batches=len(batches), labels=NUM_LABELS, bins=NUM_BINS,
        edge_elements=edges, state_deltas=deltas, max_ap_err=ap_err,
        micro_macro=out.tolist(), micro_macro_plain=out_p.tolist())

    # times, on scratch states (CUDA events; warm-up inside cuda_time_ms); the
    # update with the accumulator's kept scratch, as the eval path runs it
    (logits, targets, em, lm), _ = batches[0]
    acc_k = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev)
    s_p = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev).state
    t = {
        "update": (cuda_time_ms(lambda: acc_k.update_fn(
            acc_k.state, logits, targets, em, lm, None), 50),
            cuda_time_ms(lambda: k3.update_reference(
                s_p, logits, targets, em, lm, None, THRESHOLD, NUM_BINS), 5)),
        "finalize": (cuda_time_ms(lambda: k3.finalize_cuda(
            kern.state["hist"], NUM_LABELS, NUM_BINS), 20),
            cuda_time_ms(lambda: k3.finalize_reference(
                plain.state["hist"], NUM_LABELS, NUM_BINS), 3)),
    }
    build_log = load_kernel_library("eval_accumulator").build_log
    ptxas = {k: [r, sp] for (k,), r, sp in ptxas_by_kernel(
        build_log, r"entry function '\S*?(update_kernel|finalize_labels_kernelILi16E|"
                   r"finalize_micro_kernel)")}
    device = device_split({
        "update": lambda: acc_k.update_fn(acc_k.state, logits, targets, em, lm, None),
        "finalize": lambda: k3.finalize_cuda(kern.state["hist"], NUM_LABELS, NUM_BINS)})
    log("k3_time", **{f"{k}_ms": v[0] for k, v in t.items()},
        **{f"{k}_plain_ms": v[1] for k, v in t.items()}, device=device, ptxas=ptxas,
        card=card)
    errs = {"update": max(int_err, deltas["precision_sum"], deltas["recall_sum"]),
            "finalize": max(ap_err, out_err)}
    # bytes each entry point must move for the timed batch: the update reads
    # the logits, targets and masks, reads and writes tp/fp/fn, one
    # histogram count per valid element and the row tail's per-row counts;
    # finalize reads the histograms and writes per-label AP
    n_valid = float((em[:, None] * lm[None, :]).sum())
    nbytes = {"update": 8.0 * logits.numel() + 4 * (B + NUM_LABELS) + 24 * NUM_LABELS
              + 8 * n_valid + 12 * B + 16 * B,
              "finalize": 4.0 * 2 * NUM_LABELS * NUM_BINS + 8 * NUM_LABELS + 16 * NUM_BINS + 8}
    return {k: {"max_abs_err": errs[k], "ms": t[k][0], "plain_ms": t[k][1],
                **bound(nbytes=nbytes[k]), "library_ms": None} for k in t}


def device_split(calls: dict, reps: int = 20) -> dict:
    """For each entry point: its device ms a call (the busy time of a
    ``torch.profiler`` pass), its host ms a call (enqueueing alone), and
    each kernel's device ms a call.  Where the host time exceeds the device
    time, CUDA events around back-to-back calls time the host."""
    out = {}
    for name, fn in calls.items():
        dev_ms, host_ms = device_and_host_ms(fn, reps)
        _, _, top = device_profile(fn, reps)
        out[name] = {"device_ms": dev_ms, "host_ms": host_ms, "kernels": top}
    return out


def sweep_thresholds():
    """The CLI's candidate decision thresholds, 0.01 to 0.99."""
    import numpy as np

    return np.arange(0.01, 1.0, 0.01, dtype=np.float32)


def sweep_edges(logits, valid, thresholds) -> int:
    """How many (valid element, threshold) pairs lie within EDGE of each
    other (float64, so it depends on neither float32 exponential): each
    such pair may move two of that threshold's counts."""
    import torch

    p = torch.sigmoid(logits.double())[valid]
    th = torch.as_tensor(thresholds, dtype=torch.float64, device=p.device)
    return int(sum(int(((p - t).abs() < EDGE).sum()) for t in th))


def k9_batches(gen, dev):
    """8 full-width batches of 32 rows: 1-3 padded rows each, the label
    columns padded from 32,102 to K9_WIDTH (label padding past L), logits
    spread over (-6, 6), about 1% positives, two NaN logits a batch."""
    import torch

    out = []
    for i in range(8):
        mask = torch.ones(B)
        mask[B - 1 - i % 3:] = 0
        logits = torch.randn(B, K9_WIDTH, generator=gen) * 2.0
        logits[i, i] = logits[B - 4, NUM_LABELS - 1 - i] = float("nan")
        labels = (torch.rand(B, K9_WIDTH, generator=gen) < 0.01).float()
        out.append([t.to(dev) for t in (logits, labels, mask)])
    return out


def phase_k9(card: str):
    """K9's update and finalize at full width against the plain version
    (the lax.map loop) on the same tensors, with the CLI's 99 thresholds
    and an unsorted set with a duplicate; then their times."""
    import numpy as np
    import torch

    from protnote_tpu_torch.ops import threshold_sweep as k9

    dev = torch.device("cuda")
    batches = k9_batches(torch.Generator().manual_seed(9), dev)
    checks = {}
    for name, thresholds in (("cli_99", sweep_thresholds()),
                             ("unsorted", np.array(ODD_THRESHOLDS, np.float32))):
        sweep = k9.SweepCounter(thresholds, NUM_LABELS, dev)
        T = len(thresholds)
        plain = tuple(torch.zeros(T, NUM_LABELS, dtype=torch.int32, device=dev)
                      for _ in range(3))
        edges = 0
        for logits, labels, mask in batches:
            sweep.update(logits, labels, mask)
            k9.count_reference(plain, logits, labels, mask, sweep.thresholds)
            valid = (mask[:, None] > 0).expand(B, NUM_LABELS)
            edges += sweep_edges(logits[:, :NUM_LABELS], valid, thresholds)
        got = sweep.counts()
        torch.cuda.synchronize()
        delta = sum(int((g.long() - w.long()).abs().sum()) for g, w in zip(got, plain))
        checks[name] = {"edge_pairs": edges, "count_delta": delta,
                        "tp": int(got[0].sum()), "fn": int(got[2].sum())}
        if delta > 2 * edges or int(got[0].sum()) <= 0:
            raise AssertionError(f"K9 ({name}) disagrees: sum |delta| {delta} exceeds 2 x "
                                 f"{edges} edge pairs")
        if name == "unsorted":  # the duplicate threshold's counts are equal
            dup = [i for i, v in enumerate(thresholds) if v == thresholds[1]]
            if not all(torch.equal(c[dup[0]], c[dup[1]]) for c in got):
                raise AssertionError("K9: a duplicate threshold's counts differ")
    log("k9_check", batches=len(batches), labels=NUM_LABELS, width=K9_WIDTH, checks=checks)

    sweep = k9.SweepCounter(sweep_thresholds(), NUM_LABELS, dev)
    logits, labels, mask = batches[0]
    T = len(sweep.thresholds)
    plain = tuple(torch.zeros(T, NUM_LABELS, dtype=torch.int32, device=dev) for _ in range(3))
    t = {"update": (cuda_time_ms(lambda: sweep.update(logits, labels, mask), 50),
                    cuda_time_ms(lambda: k9.count_reference(
                        plain, logits, labels, mask, sweep.thresholds), 3)),
         "finalize": (cuda_time_ms(sweep.counts, 20),
                      cuda_time_ms(lambda: k9.finalize_reference(
                          sweep.hist, sweep.order, NUM_LABELS, T), 5))}
    device = device_split({"update": lambda: sweep.update(logits, labels, mask),
                           "finalize": sweep.counts})
    n_valid = float(mask.sum()) * NUM_LABELS
    state = 4.0 * 2 * (T + 1) * NUM_LABELS
    nbytes = {"update": 8.0 * B * K9_WIDTH + 4 * B + 4 * T + 8 * n_valid,
              "finalize": state + 4 * T + 3 * 4.0 * T * NUM_LABELS}
    xla_bytes = T * 8.0 * B * K9_WIDTH  # lax.map: the batch read once a threshold
    log("k9_time", **{f"{k}_ms": v[0] for k, v in t.items()},
        **{f"{k}_plain_ms": v[1] for k, v in t.items()},
        **{f"{k}_bound_ms": bound(nbytes=nbytes[k])["bound_ms"] for k in t},
        xla_form_bytes=xla_bytes, xla_form_bound_ms=bound(nbytes=xla_bytes)["bound_ms"],
        state_mb=state / 1e6, device=device, card=card)
    errs = {k: float(max(v["count_delta"] for v in checks.values())) for k in t}
    return {k: {"max_abs_err": errs[k], "ms": t[k][0], "plain_ms": t[k][1],
                **bound(nbytes=nbytes[k]), "library_ms": None} for k in t}


def label_cache():
    """The full label vocabulary and a random label-embedding cache (two
    descriptions per label, fixed seed)."""
    import numpy as np

    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache

    go_ids = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    types = ["name", "label"]
    rows = NUM_LABELS * K_DESCRIPTIONS
    cache = LabelEmbeddingCache(
        embeddings=random_label_matrix(), ids=np.repeat(np.array(go_ids), K_DESCRIPTIONS),
        description_types=np.array(types * NUM_LABELS),
        descriptions=np.array(["description"] * rows),
        token_counts=np.full(rows, 3, np.int32))
    return go_ids, types, cache


def fasta_dataset(tmp: str, name: str, n: int, seed: int, cfg):
    """An ``n``-sequence FASTA (lengths 100-1000, 1-5 GO labels each) over
    the full 32,102-label vocabulary, as a ``ProteinDataset`` of role
    ``cfg``."""
    import numpy as np

    from protnote_tpu_torch.data.dataset import ProteinDataset
    from protnote_tpu_torch.data.fasta import save_to_fasta
    from protnote_tpu_torch.data.vocab import COMMON_AMINOACIDS

    go_ids, _, cache = label_cache()
    rng = np.random.default_rng(seed)
    records = [("".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(k))), f"seq{i}",
                [go_ids[j] for j in rng.choice(NUM_LABELS, int(rng.integers(1, 6)),
                                               replace=False)])
               for i, k in enumerate(rng.integers(100, 1001, size=n))]
    path = save_to_fasta(records, os.path.join(tmp, name))
    vocab = {"amino_acid_vocab": sorted(COMMON_AMINOACIDS), "label_vocab": go_ids}
    return ProteinDataset(path, cfg, label_embedding_cache=cache, vocabularies=vocab)


def eval_dataset(tmp: str):
    """The evaluation FASTA (256 sequences, test role)."""
    from protnote_tpu_torch.data.dataset import DatasetConfig

    cfg = DatasetConfig(dataset_type="test", inference_go_descriptions=("name", "label"),
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    return fasta_dataset(tmp, "eval.fasta", EVAL_SEQUENCES, 5, cfg)


def phase_eval(card: str, k3_times: dict):
    """The evaluation path at full width; returns the launches of each
    kernel in ``Trainer.evaluate``."""
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator, EvalMetrics
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = eval_dataset(tmp)
        batcher = eval_batcher(ds)
        data_s = time.perf_counter() - t0
    pi_cfg, pn_cfg, ts = random_models()
    trainer = Trainer(ts, pi_cfg, pn_cfg,
                      TrainerConfig(decision_threshold=THRESHOLD, estimate_map=True),
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ps.LAUNCHES = 0
    for name in k3.LAUNCHES:
        k3.LAUNCHES[name] = 0
    reset_k7_launches()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(batcher)["metrics"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check_k7_forward(k7.LAUNCHES, "evaluation")
    launches = {"pair_mlp_layer": ps.LAUNCHES,
                **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()},
                **{k: k7.LAUNCHES[k] for k in K7_FORWARD}}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"the evaluation path skipped a kernel: {launches}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics: {metrics}")
    n_batches = len(batcher)
    batch_ms = sec * 1e3 / n_batches
    log("eval", sequences=len(ds), batches=n_batches, seconds=sec, data_seconds=data_s,
        seqs_per_s=len(ds) / sec, batch_ms=batch_ms, launches=launches,
        k3_update_share=(k3_times["update"]["ms"] / batch_ms), peak_mem_gb=peak,
        metrics=metrics, card=card)

    # second pass: the same batches' logits into the kernel and the plain
    # accumulator
    kern = DeviceEvalAccumulator(ds.num_labels, THRESHOLD, NUM_BINS, device="cuda")
    plain = DeviceEvalAccumulator(ds.num_labels, THRESHOLD, NUM_BINS, device="cuda")
    label_matrix = trainer._label_matrix_for(ds)
    latents, edges = None, 0
    for batch in batcher:
        arrays = trainer._place(batch_to_device_dict(batch, trainer.device), label_matrix)
        if latents is None:
            latents = trainer._label_latents(arrays)
        arrays = trainer._swap_in_latents(arrays, latents)
        logits = trainer._eval_step(trainer.ts, arrays)["logits"]
        mh, em = arrays["label_multihots"], arrays["example_mask"]
        lm = torch.ones(logits.shape[1], device=logits.device)
        cols = kern.cols_for(batch.label_indices, logits.shape[1])
        kern.update_fn(kern.state, logits, mh, em, lm, cols)
        k3.update_reference(plain.state, logits, mh, em, lm, cols, THRESHOLD, NUM_BINS)
        edges += edge_elements(logits, (em[:, None] > 0).expand_as(logits))
    torch.cuda.synchronize()
    deltas = compare_states(kern.state, plain.state, edges)
    got = EvalMetrics(ds.num_labels, THRESHOLD, map_estimate=True)
    want = EvalMetrics(ds.num_labels, THRESHOLD, map_estimate=True)
    kern.finalize_into(got)
    plain.merge_into(want)
    got, want = got.compute(), want.compute()
    errs = {k: abs(got[k] - want[k]) for k in want}
    worst = max(errs.values())
    log("eval_parity", edge_elements=edges, state_deltas=deltas, max_metric_err=worst,
        atol=AP_ATOL, map_micro=got["map_micro"], map_macro=got["map_macro"])
    # metrics within AP_ATOL unless an edge element moved a count
    if worst > AP_ATOL and int_delta(deltas) == 0:
        raise AssertionError(f"kernel and plain metrics disagree: {errs}")
    return metrics


def eval_batcher(ds):
    """The evaluation batcher of the eval phases: 32 rows, buckets (256,
    512, 1024), device label gather, two batches prefetched."""
    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher

    return PrefetchBatcher(BucketBatcher(
        ds, B, buckets=(256, 512, 1024), return_label_multihots=True,
        descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True), prefetch=2)


def phase_eval_sweep(card: str):
    """``Trainer.evaluate(threshold_sweep=...)`` on the phase-7 FASTA, bf16:
    the CLI's 99 thresholds counted by K9 beside K3's metrics, in turns with
    the same evaluation without the sweep (plain, sweep, sweep, plain).
    Returns K9's launches in the first sweep pass (set to 0 just before)."""
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import threshold_sweep as k9
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(tmp)
    pi_cfg, pn_cfg, ts = random_models()
    trainer = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig(decision_threshold=THRESHOLD,
                                                        estimate_map=True), device="cuda")
    runs, launches, chosen = [], None, None
    for sweep in (False, True, True, False):
        batcher = eval_batcher(ds)
        torch.cuda.synchronize()
        for counts in (k3.LAUNCHES, k9.LAUNCHES):
            for name in counts:
                counts[name] = 0
        t0 = time.perf_counter()
        res = trainer.evaluate(batcher, threshold_sweep=sweep_thresholds() if sweep else None)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        runs.append({"sweep": sweep, "seconds": sec, "seqs_per_s": len(ds) / sec})
        if sweep and launches is None:
            launches = {**{f"threshold_sweep_{k}": v for k, v in k9.LAUNCHES.items()},
                        **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}}
            chosen = res["threshold"]
            metrics = res["metrics"]
    if any(v <= 0 for v in launches.values()) or not np.isfinite(chosen[1]):
        raise AssertionError(f"the sweep evaluation skipped a kernel: {launches}, {chosen}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics: {metrics}")
    plain_s = [r["seqs_per_s"] for r in runs if not r["sweep"]]
    sweep_s = [r["seqs_per_s"] for r in runs if r["sweep"]]
    log("eval_sweep", sequences=len(ds), batches=len(batcher), runs=runs,
        seqs_per_s=sum(sweep_s) / 2, seqs_per_s_without=sum(plain_s) / 2,
        threshold=chosen[0], score=chosen[1], launches=launches,
        map_micro=metrics["map_micro"], card=card)
    return launches


def bin_quantized_map(probs, targets) -> tuple:
    """Exact micro and macro AP of the probabilities quantised to the
    NUM_BINS bins of the binned estimate (ties grouped): what the binned
    estimate computes, from the host's float32 probabilities."""
    import numpy as np

    from protnote_tpu_torch.evaln.metrics import average_precision, average_precision_columns

    q = np.clip((probs * NUM_BINS).astype(np.int32), 0, NUM_BINS - 1).astype(np.float32)
    micro = average_precision(q.reshape(-1), targets.reshape(-1))
    aps = np.concatenate([average_precision_columns(q[:, s:s + 1024], targets[:, s:s + 1024])
                          for s in range(0, q.shape[1], 1024)])
    return micro, float(np.nanmean(aps))


def phase_exact_eval(card: str):
    """``Trainer.evaluate`` with ``estimate_map=False`` (the exact host
    AUPRC) on the phase-7 FASTA, bf16: seqs/s.  Then one pass of the same
    loop by hand, split into device (eval step, synchronised), readback and
    host metric update time a batch, whose logits also feed K3 on the card
    and a host histogram: the exact mAP beside the binned estimate, which
    must equal the exact computation on the probabilities quantised to the
    bins, and the threshold metrics of both paths."""
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.evaln.metrics import BinnedAUPRC, DeviceEvalAccumulator, EvalMetrics
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(tmp)
    pi_cfg, pn_cfg, ts = random_models()
    trainer = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig(decision_threshold=THRESHOLD,
                                                        estimate_map=False), device="cuda")
    batcher = eval_batcher(ds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact = trainer.evaluate(batcher)["metrics"]
    sec = time.perf_counter() - t0

    L = ds.num_labels
    host = EvalMetrics(L, THRESHOLD, map_estimate=False)
    host_hist = BinnedAUPRC(L, NUM_BINS)
    device = DeviceEvalAccumulator(L, THRESHOLD, NUM_BINS, device="cuda")
    label_matrix = trainer._label_matrix_for(ds)
    latents, parts, probs, targets, edges, near_th = None, [], [], [], 0, 0
    for batch in batcher:
        arrays = trainer._place(batch_to_device_dict(batch, trainer.device), label_matrix)
        if latents is None:
            latents = trainer._label_latents(arrays)
        arrays = trainer._swap_in_latents(arrays, latents)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer._eval_step(trainer.ts, arrays)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = out["logits"].float().cpu().numpy()[batch.example_mask]
        t2 = time.perf_counter()
        p = 1.0 / (1.0 + np.exp(-logits.astype(np.float32)))
        labels = batch.label_multihots[batch.example_mask]
        host.update(p, labels)
        t3 = time.perf_counter()
        parts.append((t1 - t0, t2 - t1, t3 - t2))
        device.update(out["logits"], arrays["label_multihots"], arrays["example_mask"])
        host_hist.update(p, labels)
        p64 = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
        edges += int((np.abs(p64 * NUM_BINS - np.round(p64 * NUM_BINS)) / NUM_BINS < EDGE).sum())
        near_th += int((np.abs(p64 - THRESHOLD) < EDGE).sum())
        probs.append(p)
        targets.append(labels)
    t0 = time.perf_counter()
    got = host.compute()
    compute_s = time.perf_counter() - t0
    hist = device.state["hist"].cpu().numpy().reshape(2, L, NUM_BINS)
    hist_delta = int(np.abs(hist[0] - host_hist.pos).sum() + np.abs(hist[1] - host_hist.neg).sum())
    counts_delta = sum(int(np.abs(device.state[k].cpu().numpy() - getattr(host.confusion, k)).sum())
                       for k in ("tp", "fp", "fn"))
    binned = EvalMetrics(L, THRESHOLD, map_estimate=True)
    device.finalize_into(binned)
    binned = binned.compute()
    q_micro, q_macro = bin_quantized_map(np.concatenate(probs),
                                         np.concatenate(targets).astype(bool))
    # the exact mAP differs from the binned estimate only through the bins:
    # quantised to them, the exact computation gives the binned values
    bins_err = max(abs(q_micro - binned["map_micro"]), abs(q_macro - binned["map_macro"]))
    thr_keys = [k for k in binned if k not in ("map_micro", "map_macro")]
    counted = [k for k in thr_keys if not k.startswith(("precision_s", "recall_s", "f1_s"))]
    thr_err = {k: abs(got[k] - binned[k]) for k in thr_keys}
    parts = np.array(parts) * 1e3
    log("exact_eval", sequences=len(ds), batches=len(batcher), seconds=sec,
        seqs_per_s=len(ds) / sec, batch_ms=sec * 1e3 / len(batcher),
        device_ms=float(parts[:, 0].mean()), readback_ms=float(parts[:, 1].mean()),
        host_update_ms=float(parts[:, 2].mean()), host_compute_s=compute_s,
        map_micro=exact["map_micro"], map_macro=exact["map_macro"],
        by_hand_map_micro=got["map_micro"], by_hand_map_macro=got["map_macro"],
        binned_map_micro=binned["map_micro"], binned_map_macro=binned["map_macro"],
        quantised_map_micro=q_micro, quantised_map_macro=q_macro, bins_err=bins_err,
        bin_edge_elements=edges, threshold_edge_elements=near_th, hist_delta=hist_delta,
        counts_delta=counts_delta, max_threshold_metric_err=max(thr_err.values()), card=card)
    if not all(np.isfinite(v) for v in exact.values()):
        raise AssertionError(f"non-finite exact metrics: {exact}")
    if hist_delta > 2 * edges or counts_delta > 2 * near_th:
        raise AssertionError(f"K3 and the host disagree beyond the edge elements: "
                             f"hist {hist_delta} ({edges}), counts {counts_delta} ({near_th})")
    if hist_delta == 0 and bins_err > AP_ATOL:
        raise AssertionError(f"exact mAP on the bins {q_micro}, {q_macro} vs the binned "
                             f"estimate {binned['map_micro']}, {binned['map_macro']}")
    if counts_delta == 0:
        # counts-only metrics equal exactly; samplewise sums are float64 on the
        # host and float32 on the device
        bad = [k for k in counted if got[k] != binned[k]] + [
            k for k in thr_keys if k not in counted and thr_err[k] > SUM_RTOL]
        if bad:
            raise AssertionError(f"threshold metrics differ from the device path: "
                                 f"{ {k: (got[k], binned[k]) for k in bad} }")


def random_output_mlp(dev):
    """Full-width output-MLP (params, state) on ``dev``: He-scaled kernels,
    random BN parameters and running statistics (fixed seeds)."""
    import torch

    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.layers import tree_to

    cfg = ProtNoteConfig(latent_dim=D_LATENT, compute_dtype=torch.bfloat16)
    p, s = init_protnote(torch.Generator().manual_seed(7), cfg)
    p, s = p["output_mlp"], s["output_mlp"]
    he_scale_linears(p)
    gen = torch.Generator().manual_seed(8)
    for bp, bs in zip(p["bns"], s["bns"]):
        h = bs["mean"].shape[0]
        bp["scale"] = 0.5 + torch.rand(h, generator=gen)
        bp["bias"] = 0.2 * torch.randn(h, generator=gen)
        bs["mean"] = 0.3 * torch.randn(h, generator=gen)
        bs["var"] = 0.5 + 1.5 * torch.rand(h, generator=gen)
    return tree_to(p, dev), tree_to(s, dev)


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def phase_train_kernels(card: str):
    """The whole decomposed scorer (forward and backward) through K4 + K5 at
    full width with 8 sequences against its plain version on the same
    device tensors; then each kernel alone at the training path's shapes."""
    import torch

    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    dev = torch.device("cuda")
    p, s = random_output_mlp(dev)
    gen = torch.Generator().manual_seed(9)
    P_e = torch.randn(K45_B, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(NUM_LABELS, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    em = torch.ones(K45_B, device=dev)
    em[-1] = 0.0
    lm = (torch.rand(NUM_LABELS, generator=gen) < 0.98).float().to(dev)
    w = torch.randn(K45_B, NUM_LABELS, generator=gen).to(dev) * em[:, None] * lm[None, :]
    runs = {}
    for ref in (False, True):
        scorer = st.pair_logits_dense_decomposed_reference if ref else \
            st.pair_logits_dense_decomposed
        pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        Pg, Lg = P_e.clone().requires_grad_(True), L_e.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, new = scorer(pp, s, Pg, Lg, example_mask=em, label_mask=lm)
        (torch.sigmoid(logits) * w).sum().backward()
        torch.cuda.synchronize()
        runs[ref] = (logits.detach(), new, [Pg.grad, Lg.grad] + [t.grad for t in
                                                                 tree_leaves(pp)],
                     time.perf_counter() - t0)
        del pp, Pg, Lg, logits
        torch.cuda.empty_cache()
    (lg, new, grads, sec), (lg0, new0, grads0, sec0) = runs[False], runs[True]
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError("training logits through K4 + K5 are not all finite")
    logit_err = float((lg - lg0).abs().max())
    stats_err = max(rel_err(a[k], b[k]) for a, b in zip(new["bns"], new0["bns"])
                    for k in ("mean", "var"))
    grad_errs = [rel_err(a, b) for a, b in zip(grads, grads0)]
    log("train_kernels_check", batch=K45_B, labels=NUM_LABELS, max_abs_logit_err=logit_err,
        logit_atol=TRAIN_LOGIT_ATOL, logit_std=float(lg0.std()), max_rel_stats_err=stats_err,
        stats_rel_tol=STATS_REL_TOL, max_rel_grad_err=max(grad_errs), grad_rel_tol=GRAD_REL_TOL,
        grads=len(grad_errs), fwd_bwd_s=sec, plain_fwd_bwd_s=sec0, card=card)
    if not (logit_err <= TRAIN_LOGIT_ATOL and stats_err <= STATS_REL_TOL
            and max(grad_errs) <= GRAD_REL_TOL):
        raise AssertionError(f"K4 + K5 disagree with the plain scorer: logits {logit_err}, "
                             f"stats {stats_err}, gradients {grad_errs}")
    del runs, grads, grads0
    torch.cuda.empty_cache()
    times = phase_train_kernels_alone(p, s, card)
    torch.cuda.empty_cache()
    times.update(phase_k4_bwd(card))
    return times


def delta(got, want) -> tuple:
    """(max |got - want|, max |want|), in float32 over K5_PLAIN_COLS columns
    at a time (a float32 copy of a whole (N, H) tensor is 12.6 GB)."""
    if want.dim() == 2 and want.shape[1] > K5_PLAIN_COLS:
        parts = [delta(got[:, j:j + K5_PLAIN_COLS], want[:, j:j + K5_PLAIN_COLS])
                 for j in range(0, want.shape[1], K5_PLAIN_COLS)]
        return max(d[0] for d in parts), max(d[1] for d in parts)
    got, want = got.float(), want.float()
    return float((got - want).abs().max()), float(want.abs().max())


def merge_deltas(deltas) -> tuple:
    """(max |delta|, that over the largest |want|) of tensors compared in
    parts."""
    err = max(d[0] for d in deltas)
    return err, err / max(d[1] for d in deltas)


def phase_train_kernels_alone(p, s, card: str):
    """Each training kernel alone at the shapes the training path gives it
    (32 sequences: a2 (32, 3072), c2 (32,102, 3072), z (1,027,264, 3072),
    3.2e9 elements, past 2^31) against its plain version on the same device
    tensors.  K4's plain version runs whole.  K5's does not fit beside the
    kernels' tensors, and every column of its work is independent of the
    others, so it runs on K5_PLAIN_COLS-column slices, each compared with
    the same columns of the kernels' outputs; its time is one pass over all
    slices."""
    import torch

    from protnote_tpu_torch.ops import streaming_train as st

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        a2 = torch.randn(TRAIN_B, H, generator=gen).to(dev, bf16)
        c2 = torch.randn(NUM_LABELS, H, generator=gen).to(dev, bf16)
        W = (torch.randn(H, H, generator=gen) * (2.0 / H) ** 0.5).to(dev, bf16)
        z = st._pair_hidden_fwd_cuda(a2, c2, W)
        k4 = [delta(z, st._pair_hidden_fwd_plain(a2, c2, W))]
        k4_extra = k4_parts(a2, c2, W)
        em = torch.ones(TRAIN_B, device=dev)
        em[-1] = 0.0
        lm = (torch.rand(NUM_LABELS, generator=gen) < 0.98).float().to(dev)
        rows = (em[:, None] * lm[None, :]).reshape(-1, 1)
        n = rows.sum()
        bn = (p["bns"][1]["scale"], p["bns"][1]["bias"], s["bns"][1]["mean"])
        f = st._bn_relu_fwd_cuda(z, rows, n, *bn)
        dy = torch.randn(z.shape, device=dev, dtype=bf16,
                         generator=torch.Generator(device=dev).manual_seed(11))
        stats = (f[1], f[3], f[4], f[5])  # mean, istd, inv, shift of the kernel
        g = st._bn_relu_grads_cuda(z, dy, rows, n, bn[0], *stats)
        torch.cuda.synchronize()
        cols = [slice(j, j + K5_PLAIN_COLS) for j in range(0, H, K5_PLAIN_COLS)]

        def fwd_plain(c):
            return st._bn_relu_fwd_plain(z[:, c], rows, n, *(t[c] for t in bn))

        def bwd_plain(c):
            return st._bn_relu_grads(z[:, c], dy[:, c], rows, n, bn[0][c],
                                     *(t[c] for t in stats))

        fwd = {"y": [], "mean": [], "var": []}
        bwd = {"dz": [], "dscale": [], "dbias": []}
        for c in cols:
            y0, mean0, var0 = fwd_plain(c)[:3]
            fwd["y"].append(delta(f[0][:, c], y0))
            fwd["mean"].append(delta(f[1][c], mean0))
            fwd["var"].append(delta(f[2][c], var0))
            del y0
            for parts, got, want in zip(bwd.values(), (g[0][:, c], g[1][c], g[2][c]),
                                        bwd_plain(c)):
                parts.append(delta(got, want))
        outs = {"pair_train_hidden": {"z": merge_deltas(k4)},
                "bn_relu_forward": {k: merge_deltas(v) for k, v in fwd.items()},
                "bn_relu_backward": {k: merge_deltas(v) for k, v in bwd.items()}}
        times = {
            "pair_train_hidden": (cuda_time_ms(lambda: st._pair_hidden_fwd_cuda(a2, c2, W), 3),
                                  cuda_time_ms(lambda: st._pair_hidden_fwd_plain(a2, c2, W), 3)),
            "bn_relu_forward": (cuda_time_ms(lambda: st._bn_relu_fwd_cuda(z, rows, n, *bn), 5),
                                cuda_time_ms(lambda: [fwd_plain(c) for c in cols], 2)),
            "bn_relu_backward": (cuda_time_ms(lambda: st._bn_relu_grads_cuda(
                z, dy, rows, n, bn[0], *stats), 5),
                cuda_time_ms(lambda: [bwd_plain(c) for c in cols], 2)),
        }
    rel = {k: max(r for _, r in v.values()) for k, v in outs.items()}
    N = float(z.shape[0])
    bounds = {  # bf16 (N, H) tensors in and out, float32 rows and per-column values
        "pair_train_hidden": bound(nbytes=2.0 * (a2.numel() + c2.numel() + W.numel())
                                   + 2 * N * H, ops=2.0 * N * H * H),
        "bn_relu_forward": bound(nbytes=4.0 * N * H + 4 * N + 32 * H),
        "bn_relu_backward": bound(nbytes=6.0 * N * H + 4 * N + 28 * H),
    }
    # the kernels line's error: the largest |delta| of the (N, H) output
    abs_errs = {"pair_train_hidden": outs["pair_train_hidden"]["z"][0],
                "bn_relu_forward": outs["bn_relu_forward"]["y"][0],
                "bn_relu_backward": outs["bn_relu_backward"]["dz"][0]}
    k4_ops = 2.0 * N * H * H
    k4_extra.update(tflops=k4_ops / times["pair_train_hidden"][0] / 1e9,
                    gemm_tflops=k4_ops / k4_extra["gemm_ms"] / 1e9,
                    bound_share=bounds["pair_train_hidden"]["bound_ms"]
                    / times["pair_train_hidden"][0])
    log("k4_parts", **k4_extra, card=card)
    log("train_kernels_alone", batch=TRAIN_B, rows=int(z.shape[0]), width=H,
        elements=z.numel(), k5_plain_cols=K5_PLAIN_COLS,
        max_abs_errs={k: {o: d[0] for o, d in v.items()} for k, v in outs.items()},
        rel_errs=rel, rel_tol=K45_REL_TOL, **{f"{k}_ms": v[0] for k, v in times.items()},
        **{f"{k}_plain_ms": v[1] for k, v in times.items()}, card=card)
    if max(rel.values()) > K45_REL_TOL:
        raise AssertionError(f"a training kernel disagrees with its plain version: {outs}")
    return {k: {"max_abs_err": abs_errs[k], "ms": times[k][0], "plain_ms": times[k][1],
                **bounds[k], "library_ms": None} for k in times}


def phase_k4_bwd(card: str) -> dict:
    """K4-bwd's two kernels alone at the training path's 32-sequence shapes
    (a2 (32, 3072), c2 (32,102, 3072), W (3072, 3072), dz (1,027,264 x
    3072) bf16, zero at masked pair rows as K5's backward leaves it) against
    ``_pair_hidden_backward_plain``, which runs whole: da2, dc2 and dW within
    ``K45_REL_TOL`` of the plain tensor's largest |value|.  Each kernel timed
    alone through its entry point (the dX time includes zeroing its f32 da2
    scratch), the plain version's two halves (dX: x1 formed again, the gate,
    the product, the sums; dW: x1 formed again and the product), and as a
    yardstick cuBLAS on the two bare products over a materialised x1 (not
    the same function: x1, the gate and dx1 in device memory, formed outside
    the timing); ptxas figures and shared memory of each compiled kernel."""
    import ctypes

    import torch

    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        a2 = torch.randn(TRAIN_B, H, generator=gen).to(dev, bf16)
        c2 = torch.randn(NUM_LABELS, H, generator=gen).to(dev, bf16)
        W = (torch.randn(H, H, generator=gen) * (2.0 / H) ** 0.5).to(dev, bf16)
        em = torch.ones(TRAIN_B, device=dev)
        em[-1] = 0.0
        lm = (torch.rand(NUM_LABELS, generator=gen) < 0.98).float().to(dev)
        dz = torch.randn((TRAIN_B * NUM_LABELS, H), device=dev, dtype=bf16,
                         generator=torch.Generator(device=dev).manual_seed(13))
        dz.mul_((em[:, None] * lm[None, :]).reshape(-1, 1).to(bf16) * 1e-3)
        got = st._pair_hidden_backward_cuda(a2, c2, W, dz)
        torch.cuda.synchronize()
        want = st._pair_hidden_backward_plain(a2, c2, W, dz)
        outs = {"da2": delta(got[0], want[0]), "dc2": delta(got[1], want[1]),
                "dw": delta(got[2], want[2])}
        del got, want
        torch.cuda.empty_cache()
        B_, L_, K_, N_ = TRAIN_B, NUM_LABELS, H, H
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        dxp, dwp = st.pair_dx_plan(B_, L_, K_, N_, sms), st.pair_dw_plan(B_, L_, K_, N_, sms)
        da2 = torch.zeros(B_, K_, device=dev)
        dc2 = torch.empty(L_, K_, device=dev, dtype=bf16)
        part = torch.empty(dwp.splits, K_, N_, device=dev)
        dw = torch.empty(K_, N_, device=dev, dtype=bf16)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def dx_call():
            da2.zero_()
            st._raise_on(st._dx_fn()(dz.data_ptr(), W.data_ptr(), a2.data_ptr(), c2.data_ptr(),
                                     da2.data_ptr(), dc2.data_ptr(), B_, L_, K_, N_, dxp.grid,
                                     stream), "pair_train_dx")

        def dw_call():
            st._raise_on(st._dw_fn()(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(), part.data_ptr(),
                                     dw.data_ptr(), B_, L_, K_, N_, dwp.block_n, dwp.splits,
                                     dwp.grid, stream), "pair_train_dw")

        def plain_dx():
            x1 = st._pair_x1(a2, c2)
            gate = x1 > 0
            del x1
            dx1 = dz @ W.T
            dx1.mul_(gate)
            del gate
            dx1 = dx1.view(B_, L_, -1)
            return dx1.sum(1), dx1.sum(0)

        def plain_dw():
            return st._pair_x1(a2, c2).T @ dz

        times = {"pair_train_dx": (cuda_time_ms(dx_call, 3), cuda_time_ms(plain_dx, 2)),
                 "pair_train_dw": (cuda_time_ms(dw_call, 3), cuda_time_ms(plain_dw, 2))}
        pair_ms = cuda_time_ms(lambda: st._pair_hidden_backward_cuda(a2, c2, W, dz), 2)
        plain_pair_ms = cuda_time_ms(lambda: st._pair_hidden_backward_plain(a2, c2, W, dz), 2)
        x1 = st._pair_x1(a2, c2)
        gemm = {"pair_train_dx": cuda_time_ms(lambda: torch.matmul(dz, W.t()), 3),
                "pair_train_dw": cuda_time_ms(lambda: torch.matmul(x1.t(), dz), 3)}
        del x1
        torch.cuda.empty_cache()
    lib = load_kernel_library("pair_train_bwd")
    smem = lib.lib.pair_train_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    variants = [{"kernel": name, "block_n": int(bn or 128), "ptxas": ptxas, "spills": spills,
                 "smem_bytes": smem(0 if name == "dx" else 1, int(bn or 128))}
                for (name, bn), ptxas, spills in ptxas_by_kernel(
                    lib.build_log, r"pair_train_(dx|dw)_kernel(?:ILi(\d+)E)?")]
    N = float(B_ * L_)
    ops = 2.0 * N * K_ * N_
    side = 2.0 * (a2.numel() + c2.numel() + W.numel())
    bounds = {"pair_train_dx": bound(nbytes=2.0 * N * N_ + side + 2.0 * (da2.numel() + dc2.numel()),
                                     ops=ops),
              "pair_train_dw": bound(nbytes=2.0 * N * N_ + side, ops=ops)}
    rel = {k: v[0] / v[1] for k, v in outs.items()}
    pair_bound = bounds["pair_train_dx"]["bound_ms"] + bounds["pair_train_dw"]["bound_ms"]
    log("k4_bwd", batch=TRAIN_B, rows=int(N), width=H, rel_errs=rel, rel_tol=K45_REL_TOL,
        max_abs_errs={k: v[0] for k, v in outs.items()},
        **{f"{k}_ms": v[0] for k, v in times.items()},
        **{f"{k}_plain_ms": v[1] for k, v in times.items()},
        **{f"{k}_tflops": ops / v[0] / 1e9 for k, v in times.items()},
        **{f"{k}_bound_share": bounds[k]["bound_ms"] / v[0] for k, v in times.items()},
        pair_ms=pair_ms, plain_pair_ms=plain_pair_ms, pair_bound_ms=pair_bound,
        pair_bound_share=pair_bound / pair_ms, pair_tflops=2 * ops / pair_ms / 1e9,
        cublas_yardstick_ms=gemm, dw_splits=dwp.splits, dx_units=dxp.units,
        variants=variants, card=card)
    if max(rel.values()) > K45_REL_TOL:
        raise AssertionError(f"K4-bwd disagrees with the plain backward: {outs}")
    err = {"pair_train_dx": max(outs["da2"][0], outs["dc2"][0]),
           "pair_train_dw": outs["dw"][0]}
    return {k: {"max_abs_err": err[k], "ms": times[k][0], "plain_ms": times[k][1],
                **bounds[k], "library_ms": None} for k in times}


def k4_parts(a2, c2, W) -> dict:
    """K4's compiled variants (the column tile): ptxas registers, barriers
    and spills, and the dynamic shared memory a launch asks for; its launch
    plan; and the yardstick ``gemm_ms``: ``torch.matmul`` on the
    materialised bf16 x1 = relu(a2[b] + c2[l]) of the same rows times W (not
    the same function: x1 in device memory, formed outside the timing)."""
    import ctypes

    import torch

    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("pair_train")
    smem = lib.lib.pair_train_hidden_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    variants = [{"block_n": int(bn), "ptxas": ptxas, "spills": spills, "smem_bytes": smem(int(bn))}
                for (bn,), ptxas, spills in ptxas_by_kernel(lib.build_log,
                                                            r"pair_train_hidden_kernelILi(\d+)E")]
    plan = st.pair_train_plan(a2.shape[0], c2.shape[0], a2.shape[1], W.shape[1],
                              torch.cuda.get_device_properties(a2.device).multi_processor_count)
    x1 = st._pair_x1(a2, c2)
    gemm = cuda_time_ms(lambda: torch.matmul(x1, W), 3)
    del x1
    torch.cuda.empty_cache()
    return {"variants": variants, "block_n": plan.block_n, "tiles": plan.tiles,
            "grid": plan.grid, "gemm_ms": gemm}


def train_datasets(tmp: str):
    """Training (augmented: one sampled description per label, residue
    substitution 0.1) and validation datasets over the full vocabulary."""
    from protnote_tpu_torch.data.dataset import DatasetConfig

    types = ("name", "label")
    train_cfg = DatasetConfig(dataset_type="train", augment_residue_probability=0.1,
                              label_augmentation_descriptions=types,
                              inference_go_descriptions=types,
                              inference_descriptions_per_label=K_DESCRIPTIONS)
    val_cfg = DatasetConfig(dataset_type="validation", inference_go_descriptions=types,
                            inference_descriptions_per_label=K_DESCRIPTIONS)
    return (fasta_dataset(tmp, "train.fasta", TRAIN_SEQUENCES, 11, train_cfg),
            fasta_dataset(tmp, "val.fasta", VAL_SEQUENCES, 12, val_cfg))


def device_profile(fn, steps: int):
    """Run ``fn`` ``steps`` times under ``torch.profiler``: (wall s, device
    busy s, top kernels by device time), busy time the union of the kernels'
    intervals; (wall, None, []) when the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return wall, None, []
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if cur_e is None or a > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    return wall, busy / 1e6, [(name[:80], us / 1e3 / steps) for name, us in top]


def device_and_host_ms(fn, reps: int) -> tuple:
    """(device ms, host ms) a call of ``fn`` over ``reps`` back-to-back
    calls: the device time is the busy time of a ``torch.profiler`` pass
    (the union of its kernels' intervals, None without device events), the
    host time the wall time of enqueueing the calls, with no synchronise
    between them.  Where the host time exceeds the device time, CUDA events
    around back-to-back calls time the host."""
    import torch

    _, busy, _ = device_profile(fn, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return (None if busy is None else busy * 1e3 / reps), host * 1e3 / reps


def phase_training(card: str):
    """One epoch of ``Trainer.train`` at full width; returns the launches of
    every kernel in it."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_ds, val_ds = train_datasets(tmp)
        buckets = (256, 512, 1024)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        inner = BucketBatcher(train_ds, TRAIN_B, buckets=buckets, shuffle=True, drop_last=True,
                              seed=42, sequence_weights=weights, device_label_gather=True)
        train_b = PrefetchBatcher(inner, prefetch=2)
        val_b = PrefetchBatcher(BucketBatcher(
            val_ds, TRAIN_B, buckets=buckets, descriptions_per_label=K_DESCRIPTIONS,
            device_label_gather=True), prefetch=2)
        data_s = time.perf_counter() - t0

        pi_cfg, pn_cfg, ts = random_models()
        pn_cfg = dataclasses.replace(pn_cfg, label_embedding_noising_alpha=NOISING_ALPHA)
        opt = Optimizer(TRAIN_PARAMS)
        ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"], ts["enc_params"],
                               ts["enc_state"], opt)
        loss_fn = get_loss_fn(TRAIN_PARAMS)
        tcfg = TrainerConfig(num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True,
                             checkpoint_dir=tmp, run_name="smoke")
        trainer = Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev, loss_fn=loss_fn, optimizer=opt)
        steps = []
        step_fn = trainer._train_step

        def timed_step(ts_, batch, gen):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ts_, m = step_fn(ts_, batch, gen)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"]),
                          int(batch["aa_ids"].shape[0]), int(batch["aa_ids"].shape[1])))
            return ts_, m

        trainer._train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ps.LAUNCHES = 0
        for counts in (k3.LAUNCHES, st.LAUNCHES):
            for name in counts:
                counts[name] = 0
        reset_k7_launches()
        t0 = time.perf_counter()
        summary = trainer.train(train_b, val_b)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        check_k7_forward(k7.LAUNCHES, "training")
        launches = {"pair_mlp_layer": ps.LAUNCHES,
                    **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()},
                    **decomposed_launches(), **{k: k7.LAUNCHES[k] for k in K7_FORWARD}}
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer._train_step = step_fn
        losses = [x[1] for x in steps]
        if not steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"training losses not all finite: {losses}")
        if any(v <= 0 for v in launches.values()):
            raise AssertionError(f"the training path skipped a kernel: {launches}")
        hist = summary["history"][0]
        warm = [x[0] for x in steps[1:]] or [steps[0][0]]
        med = statistics.median(warm)
        log("train", steps=len(steps), sequences_per_step=TRAIN_B, labels=NUM_LABELS,
            step_losses=losses, grad_norms=[x[2] for x in steps], widths=[x[4] for x in steps],
            first_step_ms=steps[0][0] * 1e3, median_warm_step_ms=med * 1e3,
            seqs_per_s=TRAIN_B / med, pairs_per_s=TRAIN_B * NUM_LABELS / med,
            epoch_s=train_s, data_s=data_s, peak_mem_gb=peak, launches=launches,
            val_map_micro=hist.get("val_map_micro"), val_loss=hist.get("val_loss"),
            train_f1_micro=hist.get("f1_micro"), card=card)

        # one profiled pass over a few training batches
        batches = []
        inner.set_epoch(1)
        for batch in inner:
            batches.append(batch)
            if len(batches) == PROFILE_STEPS:
                break
        matrix = trainer._label_matrix_for(train_ds)
        placed = [trainer._place(batch_to_device_dict(b, dev), matrix) for b in batches]
        gen = torch.Generator(device=dev).manual_seed(1)
        it = iter(placed)

        def one_step():
            trainer.ts, _ = step_fn(trainer.ts, next(it), gen)

        wall, busy, top = device_profile(one_step, len(placed))
        log("train_profile", steps=len(placed), wall_ms_per_step=wall * 1e3 / len(placed),
            device_busy_ms_per_step=None if busy is None else busy * 1e3 / len(placed),
            idle_share=None if busy is None else 1.0 - busy / wall,
            top_kernels_ms_per_step=top, card=card)

        # a checkpoint written, restored into a fresh trainer, scored alike
        trainer.save("roundtrip")
        restored = Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev, loss_fn=loss_fn,
                           optimizer=Optimizer(TRAIN_PARAMS))
        restored.load(os.path.join(tmp, "smoke_roundtrip.ckpt"))
        a = [x for x in tree_leaves(trainer.ts) if isinstance(x, torch.Tensor)]
        b = [x for x in tree_leaves(restored.ts) if isinstance(x, torch.Tensor)]
        ints = [(trainer.ts["step"], restored.ts["step"]),
                (trainer.ts["opt_state"]["count"], restored.ts["opt_state"]["count"])]
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)) or \
                any(x != y for x, y in ints):
            raise AssertionError("the restored checkpoint differs from the saved state")
        vb = next(iter(BucketBatcher(val_ds, TRAIN_B, buckets=buckets,
                                     descriptions_per_label=K_DESCRIPTIONS,
                                     device_label_gather=True)))
        vmatrix = trainer._label_matrix_for(val_ds)
        arrays = trainer._place(batch_to_device_dict(vb, dev), vmatrix)
        before = trainer._eval_step(trainer.ts, arrays)["logits"]
        after = restored._eval_step(restored.ts, arrays)["logits"]
        err = float((before - after).abs().max())
        log("train_checkpoint", leaves=len(a), step=int(restored.ts["step"]),
            max_abs_logit_err=err, atol=ROUNDTRIP_ATOL,
            bytes=os.path.getsize(os.path.join(tmp, "smoke_roundtrip.ckpt")))
        if not (bool(torch.isfinite(after).all()) and err <= ROUNDTRIP_ATOL):
            raise AssertionError(f"restored logits differ by {err}")
    return launches, {"median_warm_step_ms": med * 1e3, "peak_mem_gb": peak}


def phase_train_settings(card: str, default: dict) -> None:
    """The training settings beside the default run of phase 9, each one
    epoch of ``Trainer.train`` at full width and 32 sequences a step on the
    same generated FASTA:

    * ``GRADIENT_CHECKPOINTING``: the post-layer-1 block recomputed in the
      backward; its median step ms and peak memory beside the default's;
    * a shuffled label subset (``TRAIN_LABEL_SAMPLE_SIZE`` 8192,
      ``SHUFFLE_LABELS``) with a bfloat16 Adam first moment
      (``OPTIMIZER_MOMENT_DTYPE``), validated on a fixed 8192-label subset
      (``VALIDATION_LABEL_SAMPLE_SIZE``); then one ``Trainer.evaluate`` on a
      shuffled 8192-label subset, which K3 scatters through its ``cols``
      path;
    * in-batch sampling (``IN_BATCH_SAMPLING``: each step's labels are its
      sequences' positives, padded up a doubling series from 8) with the
      label embeddings shipped in every batch
      (``DEVICE_RESIDENT_LABEL_EMBEDDINGS False``).

    So K4 and K4-bwd run at 32,102 (phase 9 and the remat run), 8,192 and
    the in-batch count.  Each run must be finite and launch K4, K4-bwd's two
    kernels and K5 (K3 for the evaluations); its per-step label counts are
    printed."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    buckets = (256, 512, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = train_datasets(tmp)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        pi_cfg, pn_cfg0, ts = random_models()
        loss_fn = get_loss_fn(TRAIN_PARAMS)

        def batcher(**kw):
            return BucketBatcher(train_ds, TRAIN_B, buckets=buckets, shuffle=True,
                                 drop_last=True, seed=42, sequence_weights=weights,
                                 **dict(dict(device_label_gather=True), **kw))

        def val_batcher(**kw):
            return BucketBatcher(val_ds, TRAIN_B, buckets=buckets, seed=5,
                                 descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True,
                                 **kw)

        def run(name, train_b, val_b=None, remat=False, params=TRAIN_PARAMS):
            pn_cfg = dataclasses.replace(pn_cfg0, label_embedding_noising_alpha=NOISING_ALPHA,
                                         gradient_checkpointing=remat)
            opt = Optimizer(params)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt)
            trainer = Trainer(ts0, pi_cfg, pn_cfg, TrainerConfig(
                num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True), device=dev,
                loss_fn=loss_fn, optimizer=opt)
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, batch, gen):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, batch, gen)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]),
                              int(batch["label_multihots"].shape[1])))
                return ts_, m

            trainer._train_step = timed_step
            for counts in (k3.LAUNCHES, st.LAUNCHES):
                for k in counts:
                    counts[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            summary = trainer.train(train_b, val_b)
            torch.cuda.synchronize()
            launches = {**decomposed_launches(),
                        **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}}
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            fields = dict(steps=len(steps), label_counts=sorted({x[2] for x in steps}),
                          step_losses=losses, median_warm_step_ms=med * 1e3,
                          seqs_per_s=TRAIN_B / med,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                          launches=launches)
            if val_b is not None:
                fields["val_map_micro"] = summary["history"][0].get("val_map_micro")
            needed = ["pair_train_hidden", "pair_train_dx", "pair_train_dw", "bn_relu_forward",
                      "bn_relu_backward"] + (["eval_acc_update"] if val_b is not None else [])
            if not steps or not all(math.isfinite(x) for x in losses) or \
                    any(launches[k] <= 0 for k in needed):
                raise AssertionError(f"{name}: losses {losses}, launches {launches}")
            return trainer, fields

        _, remat = run("remat", batcher(), remat=True)
        log("train_remat", **remat, default_median_warm_step_ms=default["median_warm_step_ms"],
            default_peak_mem_gb=default["peak_mem_gb"], card=card)
        trainer, sub = run("subset", batcher(label_sample_size=8192, shuffle_labels=True),
                           val_batcher(label_sample_size=8192),
                           params=dict(TRAIN_PARAMS, OPTIMIZER_MOMENT_DTYPE="bfloat16"))
        mu = trainer.ts["opt_state"]["mu"]["protnote"]["output_mlp"]["layers"][1]["kernel"]
        if sub["label_counts"] != [8192] or mu.dtype != torch.bfloat16:
            raise AssertionError(f"subset run: label counts {sub['label_counts']}, mu {mu.dtype}")
        log("train_label_subset", label_sample_size=8192, shuffle_labels=True,
            optimizer_moment_dtype=str(mu.dtype), **sub, card=card)
        for k in k3.LAUNCHES:
            k3.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = trainer.evaluate(val_batcher(label_sample_size=8192, shuffle_labels=True),
                               data_split_name="validation")["metrics"]
        torch.cuda.synchronize()
        cols = dict(k3.LAUNCHES)
        if not (cols["update"] > 0 and cols["finalize"] > 0 and
                math.isfinite(res["map_micro"])):
            raise AssertionError(f"shuffled-subset evaluation: {cols}, {res}")
        log("eval_label_subset", label_sample_size=8192, shuffle_labels=True, k3_launches=cols,
            seconds=time.perf_counter() - t0, map_micro=res["map_micro"], card=card)
        _, inb = run("in_batch", batcher(in_batch_sampling=True, device_label_gather=False))
        if max(inb["label_counts"]) >= NUM_LABELS:
            raise AssertionError(f"in-batch run at the full vocabulary: {inb['label_counts']}")
        log("train_in_batch", device_resident_label_embeddings=False, **inb, card=card)


def token_batch(gen, batch: int, tokens: int, lo: int, hi: int, vocab: int, pad: int,
                filler: bool = True):
    """Random token ids and their mask on the card: lengths lo..hi and, with
    ``filler``, the last row an all-masked filler row (as a padded chunk
    carries)."""
    import torch

    lengths = torch.randint(lo, hi + 1, (batch,), generator=gen)
    if filler:
        lengths[-1] = 0
    mask = (torch.arange(tokens)[None, :] < lengths[:, None]).to(torch.int32)
    ids = torch.randint(3, vocab, (batch, tokens), generator=gen)
    ids = torch.where(mask > 0, ids, torch.full_like(ids, pad))
    return ids.cuda(), mask.cuda()


def phase_k8(card: str):
    """K8a and K8b alone at the tower's shapes against their plain versions
    on the same device tensors; SDPA and ``F.layer_norm`` as yardsticks."""
    import torch
    import torch.nn.functional as F

    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import text_attention as k8a

    nh, hd, Hd = 16, 64, 1024
    gen = torch.Generator().manual_seed(30)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    with torch.inference_mode():
        for name, Bq, T, lo, hi, causal in K8_SHAPES:
            _, mask = token_batch(gen, Bq, T, lo, hi, 100, 1)
            q, k, v = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev, bf16) for _ in range(3))
            got = k8a.masked_attention_cuda(q, k, v, mask, causal)
            want = k8a.masked_attention_reference(q, k, v, mask, causal)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got).all())
            a_err = float((got.float() - want.float()).abs().max())
            a_rel = a_err / float(want.float().abs().max())
            keep = (mask > 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            add_mask = torch.where(keep, 0.0, k8a.MASKED).to(bf16)
            attn = {"ms": cuda_time_ms(lambda: k8a.masked_attention_cuda(q, k, v, mask, causal),
                                       20),
                    "plain_ms": cuda_time_ms(lambda: k8a.masked_attention_reference(
                        q, k, v, mask, causal), 5),
                    "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=add_mask), 20),
                    "max_abs_err": a_err, "rel_err": a_rel, "finite": finite,
                    **bound(nbytes=4.0 * q.numel() * 2 + 4.0 * mask.numel(),
                            ops=4.0 * Bq * nh * T * T * hd)}
            del got, want, q, k, v, add_mask
            # K8b on the same rows: with the residual (post-LN bert), without
            # it for the pre-LN gpt form
            rows = Bq * T
            x = torch.randn(rows, Hd, generator=gen).to(dev, bf16)
            r = None if causal else torch.randn(rows, Hd, generator=gen).to(dev, bf16)
            scale = (0.5 + torch.rand(Hd, generator=gen)).to(dev)
            bias = (0.1 * torch.randn(Hd, generator=gen)).to(dev)
            got = k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5)
            want = k8b.add_layer_norm_reference(x, r, scale, bias, 1e-5)
            torch.cuda.synchronize()
            finite = finite and bool(torch.isfinite(got).all())
            n_err = float((got.float() - want.float()).abs().max())
            n_rel = n_err / float(want.float().abs().max())
            sb, bb = scale.to(bf16), bias.to(bf16)

            def kernel():
                return k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5)

            def library():
                return F.layer_norm(x if r is None else x + r, (Hd,), sb, bb, 1e-5)

            norm = {"ms": cuda_time_ms(kernel, 20),
                    "plain_ms": cuda_time_ms(lambda: k8b.add_layer_norm_reference(
                        x, r, scale, bias, 1e-5), 5),
                    "library_ms": cuda_time_ms(library, 20),
                    "max_abs_err": n_err, "rel_err": n_rel,
                    **bound(nbytes=2.0 * rows * Hd * (2 if r is None else 3) + 8.0 * Hd)}
            for key, fn in (("", kernel), ("library_", library)):
                norm[f"{key}device_ms"], norm[f"{key}host_ms"] = device_and_host_ms(fn, 20)
            del got, want, x, r
            out[name] = {"text_attention": attn, "add_layer_norm": norm}
            log("k8_check", shape=name, batch=Bq, tokens=T, lengths=[lo, hi], causal=causal,
                heads=nh, head_dim=hd, width=Hd, finite=finite, rel_tol=K8_REL_TOL,
                text_attention=attn, add_layer_norm=norm, card=card)
            if not finite or max(a_rel, n_rel) > K8_REL_TOL:
                raise AssertionError(f"K8 ({name}) disagrees with its plain version: attention "
                                     f"{a_rel}, LayerNorm {n_rel} (rel tol {K8_REL_TOL}), "
                                     f"finite {finite}")
    log("k8b_ptxas", **k8b_ptxas(), card=card)
    torch.cuda.empty_cache()
    return out


def k8b_ptxas() -> dict:
    """K8b's ptxas registers and spills at the tower's width (H 1024, four
    16-byte chunks a lane), with and without the residual."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    return {"residual" if residual == "1" else "no_residual": {"ptxas": ptxas, "spills": spills}
            for (chunks, residual), ptxas, spills in ptxas_by_kernel(
                load_kernel_library("layer_norm").build_log,
                r"add_layer_norm_kernelILi(\d+)ELb([01])E") if chunks == "4"}


def random_tower(cfg, seed: int):
    """A tower of ``cfg`` with random weights from a seeded CUDA generator,
    on the card, in the encoder's inference layout (bf16 weights, float32
    LayerNorms)."""
    import torch

    from protnote_tpu_torch.models.text_transformer import cast_for_inference, init_text_encoder

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return cast_for_inference(init_text_encoder(gen, cfg, "cuda"), cfg.dtype)


def pooled_err(got, want) -> tuple:
    """(max |got - want| over the largest |want|, all of got finite)."""
    import torch

    return (float((got - want).abs().max() / want.abs().max()),
            bool(torch.isfinite(got).all()))


def phase_tower(card: str):
    """E5-large and BioGPT against the plain tower on one chunk each; then
    64 chunks of shape (a) through ``NativeLabelEncoder.embed_ids``.  Returns
    the kernels' launches in that run and the pooled rows of the kernels'
    tower and of the plain tower."""
    import torch

    from protnote_tpu_torch.models.label_encoder import NativeLabelEncoder
    from protnote_tpu_torch.models.text_transformer import (
        TextEncoderConfig,
        pool_hidden_states,
        text_encoder_forward,
        text_encoder_forward_reference,
    )
    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import text_attention as k8a

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(32)
    _, Ba, Ta, lo, hi, _ = K8_SHAPES[0]
    whole = {}
    for arch, cfg, seed in (("e5_large", TextEncoderConfig.e5_large(dtype=bf16), 33),
                            ("biogpt", TextEncoderConfig.biogpt(dtype=bf16), 34)):
        t0 = time.perf_counter()
        params = random_tower(cfg, seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ids, mask = token_batch(gen, Ba, Ta, lo, hi, cfg.vocab_size, cfg.pad_token_id)
        with torch.inference_mode():
            got = pool_hidden_states(text_encoder_forward(params, ids, mask, cfg), mask, "mean")
            hidden = text_encoder_forward_reference(params, ids, mask, cfg)
            want = pool_hidden_states(hidden, mask, "mean")
        torch.cuda.synchronize()
        err, finite = pooled_err(got, want)
        whole[arch] = {"rel_err": err, "finite": finite,
                       "plain_finite": bool(torch.isfinite(hidden).all()), "init_s": init_s,
                       "params": sum(t.numel() for t in tensors_of(params))}
        log("tower_check", arch=arch, batch=Ba, tokens=Ta, layers=cfg.num_layers,
            width=cfg.hidden_size, vocab=cfg.vocab_size, rel_tol=TOWER_REL_TOL,
            pooled_std=float(want.std()), **whole[arch], card=card)
        if not finite or err > TOWER_REL_TOL:
            raise AssertionError(f"the {arch} tower disagrees with the plain tower: {err} "
                                 f"(rel tol {TOWER_REL_TOL}), finite {finite}")
        if arch == "biogpt":
            del params
        else:
            e5_cfg, e5_params = cfg, params
        del hidden, got, want
        torch.cuda.empty_cache()

    # descriptions/s: 64 chunks of (a) through the encoder's forward and pool
    encoder = NativeLabelEncoder(e5_cfg, e5_params, device="cuda")
    chunks = [token_batch(gen, Ba, Ta, lo, hi, e5_cfg.vocab_size, e5_cfg.pad_token_id,
                          filler=i == TOWER_CHUNKS - 1)  # one filler row, in the last chunk
              for i in range(TOWER_CHUNKS)]
    encoder.embed_ids(*chunks[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k8a.LAUNCHES = 0
    k8b.LAUNCHES = 0
    t0 = time.perf_counter()
    rows = torch.cat([encoder.embed_ids(ids, mask) for ids, mask in chunks])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"text_attention": k8a.LAUNCHES, "add_layer_norm": k8b.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(v <= 0 for v in launches.values()) or not bool(torch.isfinite(rows).all()):
        raise AssertionError(f"the tower run skipped a kernel or gave non-finite rows: "
                             f"{launches}")
    n = rows.shape[0]
    real_tokens = int(sum(int(m.sum()) for _, m in chunks))
    log("tower", arch="e5_large", chunks=TOWER_CHUNKS, batch=Ba, tokens=Ta, rows=n,
        filler_rows=1, real_tokens=real_tokens, seconds=sec, descriptions_per_s=n / sec,
        ms_per_chunk=sec * 1e3 / TOWER_CHUNKS, peak_mem_gb=peak, launches=launches,
        launches_per_chunk={k: v / TOWER_CHUNKS for k, v in launches.items()}, card=card)
    # where a chunk's time goes: one profiled pass over a few chunks
    wall, busy, top = device_profile(lambda: encoder.embed_ids(*chunks[0]), 4)
    log("tower_profile", chunks=4, wall_ms_per_chunk=wall * 1e3 / 4,
        device_busy_ms_per_chunk=None if busy is None else busy * 1e3 / 4,
        idle_share=None if busy is None else 1.0 - busy / wall,
        top_kernels_ms_per_chunk=top, card=card)
    with torch.inference_mode():
        t0 = time.perf_counter()
        plain = torch.cat([pool_hidden_states(text_encoder_forward_reference(
            encoder.params, ids, mask, e5_cfg), mask, "mean") for ids, mask in chunks])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    err, finite = pooled_err(rows, plain)
    log("tower_plain", chunks=TOWER_CHUNKS, seconds=plain_s,
        descriptions_per_s=n / plain_s, rel_err=err, rel_tol=TOWER_REL_TOL, card=card)
    if err > TOWER_REL_TOL:
        raise AssertionError(f"the 64-chunk tower run disagrees with the plain tower: {err}")
    del encoder, e5_params, chunks
    torch.cuda.empty_cache()
    return launches, rows, plain


def phase_zero_shot(rows, plain_rows, card: str):
    """The tower's rows as 4,096 new labels x 2 descriptions behind a
    full-width engine; one full batch through K1 against the plain chain
    (plain tower rows, plain pair scorer)."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.fusion import compute_label_latents
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.serving import ServingEngine

    pi_cfg, pn_cfg, ts = random_models()
    vocab = [f"GO:{9000000 + i:07d}" for i in range(ZERO_SHOT_LABELS)]
    rows = rows[:ZERO_SHOT_LABELS * K_DESCRIPTIONS]
    t0 = time.perf_counter()
    engine = ServingEngine(ts, pi_cfg, pn_cfg, rows.cpu().numpy(), vocab, buckets=(512, 1024),
                           max_batch=B, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(35)
    seqs = random_sequences(rng, rng.integers(100, 512, size=B))
    engine.score(seqs)  # warm-up
    torch.cuda.synchronize()
    ps.LAUNCHES = 0
    t0 = time.perf_counter()
    got = engine.score(seqs)
    sec = time.perf_counter() - t0
    launches = ps.LAUNCHES
    with torch.inference_mode():
        latents = compute_label_latents(engine.ts["trainable"]["protnote"],
                                        engine.ts["model_state"],
                                        plain_rows[:ZERO_SHOT_LABELS * K_DESCRIPTIONS], pn_cfg)
    want = plain_probs(engine, seqs, latents=latents)
    err = float(np.abs(got - want).max())
    log("zero_shot", labels=ZERO_SHOT_LABELS, label_rows=int(rows.shape[0]), batch=B,
        engine_build_s=build_s, batch_ms=sec * 1e3, seqs_per_s=B / sec, k1_launches=launches,
        max_abs_prob_err=err, prob_atol=PROB_ATOL, prob_std=float(want.std()),
        finite=bool(np.isfinite(got).all()), card=card)
    if launches <= 0 or not np.isfinite(got).all() or err > PROB_ATOL:
        raise AssertionError(f"zero-shot scoring: K1 launches {launches}, prob err {err} "
                             f"(atol {PROB_ATOL})")


def phase_k8_bwd(card: str):
    """K8a-bwd and K8b-bwd alone at phase 13's shapes against their plain
    backward on the same device tensors; the backward of SDPA and of
    ``F.layer_norm`` after a bf16 add as yardsticks."""
    import statistics

    import torch
    import torch.nn.functional as F

    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import text_attention as k8a

    nh, hd, Hd = 16, 64, 1024
    gen = torch.Generator().manual_seed(40)
    dev, bf16 = torch.device("cuda"), torch.bfloat16

    def rel(got, want) -> float:
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    out = {}
    for name, Bq, T, lo, hi, causal in K8_SHAPES:
        _, mask = token_batch(gen, Bq, T, lo, hi, 100, 1)
        q, k, v, g = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev, bf16) for _ in range(4))
        before = k8a.BWD_LAUNCHES
        got = k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g)
        again = k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g)
        launches = k8a.BWD_LAUNCHES - before
        want = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
        one_pass = k8a.backward_launches(T) == 1
        two = k8a.two_kernel_backward_cuda(q, k, v, mask, causal, g) if one_pass else got
        torch.cuda.synchronize()
        errs = {n: rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        two_errs = {n: rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), two, want)}
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        a_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        del got, again, want, two
        keep = (mask > 0)[:, None, None, :]
        if causal:
            keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        add_mask = torch.where(keep, 0.0, k8a.MASKED).to(bf16)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        ctx = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=add_mask)

        def kernel():
            return k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g)

        def library():
            return torch.autograd.grad(ctx, (ql, kl, vl), g, retain_graph=True)

        def two_kernels():
            return k8a.two_kernel_backward_cuda(q, k, v, mask, causal, g)

        # the kernel and SDPA's backward (noisy from run to run) in turns
        turns = {"kernel": kernel, "library": library}
        if one_pass:
            turns["two_kernels"] = two_kernels
        readings = {n: [] for n in turns}
        for _ in range(K8_BWD_ROUNDS):
            for n, fn in turns.items():
                readings[n].append(cuda_time_ms(fn, 10))
        med = {n: statistics.median(r) for n, r in readings.items()}
        frac = 0.5 if causal else 1.0  # the products a causal row needs
        attn = {"ms": med["kernel"],
                "plain_ms": cuda_time_ms(lambda: k8a.masked_attention_backward_reference(
                    q, k, v, mask, causal, g), 3),
                "library_ms": med["library"], "readings": readings,
                "two_kernel_ms": med.get("two_kernels"),
                "two_kernel_rel_err": two_errs if one_pass else None,
                "launches_a_call": launches / 2, "max_abs_err": a_err, "rel_err": errs,
                "finite": finite, "deterministic": deterministic,
                **bound(nbytes=7.0 * q.numel() * 2 + 4.0 * mask.numel(),
                        ops=10.0 * Bq * nh * T * T * hd * frac)}
        attn["device_ms"], attn["host_ms"] = device_and_host_ms(kernel, 10)
        del ctx, ql, kl, vl, add_mask, q, k, v, g
        torch.cuda.empty_cache()
        rows = Bq * T
        x = torch.randn(rows, Hd, generator=gen).to(dev, bf16)
        r = None if causal else torch.randn(rows, Hd, generator=gen).to(dev, bf16)
        gy = torch.randn(rows, Hd, generator=gen).to(dev, bf16)
        scale = (0.5 + torch.rand(Hd, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(Hd, generator=gen)).to(dev)
        stats = torch.empty(rows, 2, device=dev)
        k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5, stats)
        got = k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)
        _, plain_stats = k8b._reference_with_stats(x, r, scale, bias, 1e-5)
        want = k8b.add_layer_norm_backward_reference(x, r, scale, plain_stats, gy)
        torch.cuda.synchronize()
        n_errs = {n: rel(a, b) for n, a, b in zip(("dx", "dscale", "dbias"), got, want)}
        n_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        finite = finite and all(bool(torch.isfinite(a).all()) for a in got)
        again = k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, want, again
        xl = x.detach().clone().requires_grad_(True)
        rl = None if r is None else r.detach().clone().requires_grad_(True)
        sb = scale.to(bf16).requires_grad_(True)
        bb = bias.to(bf16).requires_grad_(True)
        y = F.layer_norm(xl if rl is None else xl + rl, (Hd,), sb, bb, 1e-5)
        wrt = [t for t in (xl, rl, sb, bb) if t is not None]

        def n_kernel():
            return k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)

        def n_library():
            return torch.autograd.grad(y, wrt, gy, retain_graph=True)

        norm = {"ms": cuda_time_ms(n_kernel, 20),
                "plain_ms": cuda_time_ms(lambda: k8b.add_layer_norm_backward_reference(
                    x, r, scale, stats, gy), 5),
                "library_ms": cuda_time_ms(n_library, 20), "max_abs_err": n_err,
                "rel_err": n_errs, "deterministic": deterministic,
                **bound(nbytes=2.0 * rows * Hd * (3 if r is None else 4) + 8.0 * rows
                        + 12.0 * Hd)}
        for key, fn in (("", n_kernel), ("library_", n_library)):
            norm[f"{key}device_ms"], norm[f"{key}host_ms"] = device_and_host_ms(fn, 20)
        del x, r, gy, y, xl, rl, stats, plain_stats
        torch.cuda.empty_cache()
        out[name] = {"text_attention_bwd": attn, "add_layer_norm_bwd": norm}
        log("k8_bwd_check", shape=name, batch=Bq, tokens=T, lengths=[lo, hi], causal=causal,
            heads=nh, head_dim=hd, width=Hd, finite=finite, rel_tol=K45_REL_TOL,
            text_attention_bwd=attn, add_layer_norm_bwd=norm, card=card)
        worst = max(list(errs.values()) + list(two_errs.values()) + list(n_errs.values()))
        deterministic = deterministic and attn["deterministic"]
        if not finite or not deterministic or worst > K45_REL_TOL or \
                launches != 2 * k8a.backward_launches(T):
            raise AssertionError(f"K8 backward ({name}) disagrees with its plain version: "
                                 f"{errs} {two_errs} {n_errs} (rel tol {K45_REL_TOL}), finite "
                                 f"{finite}, deterministic {deterministic}, launches {launches}")
    return out


class FirstBatches:
    """The first ``n`` batches of ``batcher`` each epoch (other attributes
    are the batcher's): a training run of a fixed number of steps."""

    def __init__(self, batcher, n: int):
        self.batcher, self.n = batcher, n

    def __iter__(self):
        for i, batch in enumerate(self.batcher):
            if i == self.n:
                break
            yield batch

    def __len__(self) -> int:
        return min(self.n, len(self.batcher))

    def __getattr__(self, name):
        return getattr(self.batcher, name)


def tower_token_table(gen, rows: int, vocab: int, pad: int):
    """Random token ids for every description row of the label cache:
    lengths 16-128, padded to 128 (int32 numpy, as the CLI tokenizes
    ``cache.descriptions``)."""
    import torch

    lengths = torch.randint(TOWER_TRAIN_LENGTHS[0], TOWER_TRAIN_LENGTHS[1] + 1, (rows,),
                            generator=gen)
    mask = (torch.arange(TOWER_TRAIN_LENGTHS[1])[None, :] < lengths[:, None]).to(torch.int32)
    ids = torch.randint(3, vocab, (rows, TOWER_TRAIN_LENGTHS[1]), generator=gen)
    ids = torch.where(mask > 0, ids, torch.full_like(ids, pad)).to(torch.int32)
    return ids.numpy(), mask.numpy()


def phase_tower_training(card: str):
    """Training the label tower at full width through ``Trainer.train``:
    E5-large with LoRA and with the last two layers unfrozen, BioGPT with
    LoRA (K8a-bwd causal); per run the steps' times, rates, peak memory, a
    profiled idle share, the kernels' launches and a validation pass through
    the tower; one step's gradients through the kernels against the plain
    chain.  Returns the backward kernels' launches over the three runs."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.models.text_transformer import (
        TextEncoderConfig,
        init_lora,
        init_text_encoder,
        text_encoder_forward_reference,
        trainable_mask,
    )
    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.ops import text_attention as k8a
    from protnote_tpu_torch.train import step as step_mod
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves, tree_map
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    buckets = (256, 512, 1024)
    totals = {"text_attention_bwd": 0, "add_layer_norm_bwd": 0}
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = train_datasets(tmp)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        pi_cfg, pn_cfg, ts = random_models()
        loss_fn = get_loss_fn(TRAIN_PARAMS)
        gen = torch.Generator().manual_seed(41)
        rows = NUM_LABELS * K_DESCRIPTIONS

        def train_batcher():
            return BucketBatcher(train_ds, TRAIN_B, buckets=buckets, shuffle=True,
                                 drop_last=True, seed=42, sequence_weights=weights,
                                 in_batch_sampling=True, device_label_gather=True)

        def val_batcher():
            return BucketBatcher(val_ds, TRAIN_B, buckets=buckets, seed=5,
                                 label_sample_size=TOWER_VAL_LABELS,
                                 descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True)

        def run(name, cfg, seed, lora: bool, steps_n: int):
            t0 = time.perf_counter()
            text = init_text_encoder(torch.Generator(device="cuda").manual_seed(seed), cfg,
                                     "cuda")  # float32 master weights
            adapters, mask = None, None
            if lora:
                adapters = init_lora(torch.Generator(device="cuda").manual_seed(seed + 1), cfg,
                                     rank=TOWER_LORA_RANK, last_n_layers=TOWER_TRAIN_LAYERS,
                                     device="cuda")
                for entry in adapters.values():  # B non-zero: A gets a gradient from step 1
                    for t in entry.values():
                        t["B"] = 1e-3 * torch.randn(t["B"].shape, generator=gen).to(dev)
            else:
                mask = {"protnote": tree_map(lambda _: True, ts["trainable"]["protnote"]),
                        "text": trainable_mask(text, cfg, TOWER_TRAIN_LAYERS)}
            opt = Optimizer(TRAIN_PARAMS, trainable_mask=mask)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt, text_params=text,
                                   train_label_encoder=not lora, lora_params=adapters)
            tokens = tower_token_table(gen, rows, cfg.vocab_size, cfg.pad_token_id)
            trainer = Trainer(ts0, pi_cfg, pn_cfg, TrainerConfig(
                num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True), device=dev,
                loss_fn=loss_fn, optimizer=opt, text_cfg=cfg, label_tokens=tokens,
                pooling_method="mean", lora_alpha=TOWER_LORA_ALPHA, lora_rank=TOWER_LORA_RANK)
            setup_s = time.perf_counter() - t0
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, batch, g):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, batch, g)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"]),
                              int(batch["label_input_ids"].shape[0])))
                return ts_, m

            trainer._train_step = timed_step
            k8a.LAUNCHES = k8a.BWD_LAUNCHES = k8b.LAUNCHES = k8b.BWD_LAUNCHES = 0
            for k in st.LAUNCHES:
                st.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = trainer.train(FirstBatches(train_batcher(), steps_n), val_batcher())
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = {"text_attention": k8a.LAUNCHES, "text_attention_bwd": k8a.BWD_LAUNCHES,
                        "add_layer_norm": k8b.LAUNCHES, "add_layer_norm_bwd": k8b.BWD_LAUNCHES,
                        **decomposed_launches()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            trainer._train_step = step_fn
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            descs = statistics.median([x[3] for x in steps])
            hist = summary["history"][0]
            if len(steps) != steps_n or not all(math.isfinite(x) for x in losses) or \
                    any(v <= 0 for v in launches.values()) or \
                    not math.isfinite(hist.get("val_map_micro", float("nan"))):
                raise AssertionError(f"tower training {name}: losses {losses}, launches "
                                     f"{launches}, history {hist}")
            totals["text_attention_bwd"] += launches["text_attention_bwd"]
            totals["add_layer_norm_bwd"] += launches["add_layer_norm_bwd"]

            # three profiled steps, and one step's gradients against the plain chain
            inner = train_batcher()
            inner.set_epoch(1)
            batches = []
            for batch in inner:
                batches.append(batch)
                if len(batches) == PROFILE_STEPS:
                    break
            matrix = trainer._label_matrix_for(train_ds)
            placed = [trainer._place(batch_to_device_dict(b, dev), matrix, b) for b in batches]
            g_prof = torch.Generator(device=dev).manual_seed(1)
            it = iter(placed)

            def one_step():
                trainer.ts, _ = step_fn(trainer.ts, next(it), g_prof)

            wall, busy, top = device_profile(one_step, len(placed))
            grads = tower_grad_check(trainer, placed[0], cfg, lora, step_mod,
                                     text_encoder_forward_reference)
            fields = dict(arch=cfg.arch, layers=cfg.num_layers, width=cfg.hidden_size,
                          lora=lora, lora_rank=TOWER_LORA_RANK if lora else None,
                          trained_layers=TOWER_TRAIN_LAYERS, steps=len(steps),
                          sequences_per_step=TRAIN_B, descriptions_per_step=[x[3] for x in steps],
                          tokens=TOWER_TRAIN_LENGTHS, step_losses=losses,
                          grad_norms=[x[2] for x in steps], first_step_ms=steps[0][0] * 1e3,
                          median_warm_step_ms=med * 1e3, seqs_per_s=TRAIN_B / med,
                          descriptions_per_s=descs / med, peak_mem_gb=peak, setup_s=setup_s,
                          run_s=run_s, launches=launches,
                          val_labels=TOWER_VAL_LABELS, val_map_micro=hist.get("val_map_micro"),
                          val_loss=hist.get("val_loss"),
                          profile_wall_ms_per_step=wall * 1e3 / len(placed),
                          profile_device_busy_ms_per_step=None if busy is None
                          else busy * 1e3 / len(placed),
                          idle_share=None if busy is None else 1.0 - busy / wall,
                          top_kernels_ms_per_step=top, grad_check=grads)
            log("tower_train", run=name, **fields, card=card)
            del trainer, ts0, text, adapters, placed, batches
            torch.cuda.empty_cache()

        run("e5_large_lora", TextEncoderConfig.e5_large(dtype=bf16), 42, True, 9)
        run("e5_large_last2", TextEncoderConfig.e5_large(dtype=bf16), 43, False, 9)
        run("biogpt_lora", TextEncoderConfig.biogpt(dtype=bf16), 44, True, 3)
    return totals


def tower_grad_check(trainer, batch, cfg, lora: bool, step_mod, plain_forward) -> dict:
    """One step's gradients on the run's weights and one batch of its label
    text, through the kernels and through the plain chain:

    * the tower alone, the scorer left out: one fixed cotangent on the
      pooled label embeddings through ``text_encoder_forward`` (K8a, K8b and
      their backward kernels) and through the plain forward with plain
      autograd, gradients reaching every leaf that trains (as in the step,
      so with the whole tower trainable the backward runs through all its
      layers).  Each trained leaf (LoRA A and B, or the unfrozen layers)
      through the kernels within GRAD_REL_TOL of the plain chain's in L2
      (|kernels - plain| / |plain|), and within GRAD_REL_TOL of the largest
      |value| of the same chain's with the plain backward (K8a-bwd's and
      K8b-bwd's plain versions on the kernels' forward);
    * the whole train step (a keeper optimizer that updates nothing):
      ``grad_norm`` within GRAD_REL_TOL of the plain chain's.

    Logged, not held: all trained leaves' L2 distance to float32's, for
    the tower alone and for the whole step (the scorer's part is the
    difference between the two).

    Why L2 across the forward: in the E5 runs the q and k leaves'
    gradients lie 4-5% (L2) from float32's in both bf16 chains, and as far
    with the attention core alone in float32, while the other leaves lie
    within 1.3%; single elements of them move by up to 6-8% between any
    two bf16 chains (read on an H100 with this check).  Logged beside: the
    largest elementwise difference, and the L2 distance of each chain to
    the plain chain in float32 (the kernels, the plain chain, the plain
    chain with its attention core in float32), the q and k leaves apart
    from the rest.

    The key bias has a zero gradient in exact arithmetic (a softmax does not
    see a constant added to a row of scores): its values are float32 noise,
    held below 1e-3 of the largest gradient on both sides and left out of
    the comparisons."""
    import dataclasses

    import torch

    from protnote_tpu_torch.models.text_transformer import pool_hidden_states
    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import text_attention as k8a
    from protnote_tpu_torch.train.optim import tree_leaves
    from protnote_tpu_torch.train.step import make_train_step

    class KeepGrads:
        def update(self, grads, trainable, state):
            self.grads = grads
            return state

    def named(tree, path=""):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in named(tree[k], f"{path}/{k}")]
        if isinstance(tree, list):
            return [x for i, v in enumerate(tree) for x in named(v, f"{path}/{i}")]
        return [(path, tree)]

    def plain_ln_backward(x, r, scale, stats, g):
        return k8b.add_layer_norm_backward_reference(x, r, scale,
                                                     stats.reshape(*x.shape[:-1], 2), g)

    plain_core = k8a.masked_attention_reference

    def f32_core(q, k, v, key_mask, causal):
        return plain_core(q.float(), k.float(), v.float(), key_mask, causal).to(q.dtype)

    def patched(patch, fn):
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patch]
        for mod, name, f in patch:
            setattr(mod, name, f)
        try:
            return fn()
        finally:
            for mod, name, f in saved:
                setattr(mod, name, f)

    trainable, kw = trainer.ts["trainable"], trainer._tower_kwargs
    text_params = trainable.get("text", trainer.ts.get("text_params"))
    adapters = trainable.get("lora")
    wrt = tree_leaves(trainable["lora" if lora else "text"])
    sub = adapters if lora else text_params["layers"][cfg.num_layers - TOWER_TRAIN_LAYERS:]
    names = {id(t): n for n, t in named(sub)}
    ids, am = batch["label_input_ids"], batch["label_attention_mask"]
    cot = torch.randn(ids.shape[0], cfg.hidden_size, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3))

    def tower_grads(forward, text_cfg):
        for t in wrt:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                hidden = forward(text_params, ids, am, text_cfg, lora=adapters,
                                 lora_alpha=kw["lora_alpha"], lora_rank=kw["lora_rank"])
                pooled = pool_hidden_states(hidden, am, kw["pooling_method"])
                grads = torch.autograd.grad((pooled.float() * cot).sum(), wrt)
        finally:
            for t in wrt:
                t.requires_grad_(False)
        return {names[id(t)]: g.float() for t, g in zip(wrt, grads) if id(t) in names}

    bf16_cfg = kw["text_cfg"]
    tower = {
        "kernels": tower_grads(step_mod.text_encoder_forward, bf16_cfg),
        "plain": tower_grads(plain_forward, bf16_cfg),
        "plain_backward": patched(
            [(k8a, "masked_attention_backward_cuda", k8a.masked_attention_backward_reference),
             (k8b, "add_layer_norm_backward_cuda", plain_ln_backward)],
            lambda: tower_grads(step_mod.text_encoder_forward, bf16_cfg)),
        "plain_f32": tower_grads(plain_forward,
                                 dataclasses.replace(bf16_cfg, dtype=torch.float32)),
        "plain_f32_core": patched([(k8a, "masked_attention_reference", f32_core)],
                                  lambda: tower_grads(plain_forward, bf16_cfg)),
    }
    kernels, plain = tower["kernels"], tower["plain"]
    scale = max(float(g.abs().max()) for g in plain.values())
    noise = {n: max(float(kernels[n].abs().max()), float(plain[n].abs().max())) / scale
             for n in kernels if n.endswith("/k/bias")}
    kept = [n for n in kernels if n not in noise]

    def max_rel(side: str, ref: str) -> dict:
        return {n: float((tower[side][n] - tower[ref][n]).abs().max()
                         / tower[ref][n].abs().max()) for n in kept}

    def l2_rel(side: str, ref: str) -> dict:
        return {n: float((tower[side][n] - tower[ref][n]).norm() / tower[ref][n].norm())
                for n in kept}

    def worst(errs: dict) -> list:
        n = max(errs, key=errs.get)
        return [errs[n], n]

    def qk_split(errs: dict) -> dict:
        qk = [v for n, v in errs.items() if n.split("/")[-2] in ("q", "k")]
        return {"q_k": max(qk, default=None),
                "other": max(v for n, v in errs.items() if n.split("/")[-2] not in ("q", "k"))}

    l2_errs, bwd_errs = l2_rel("kernels", "plain"), max_rel("kernels", "plain_backward")

    norms, step_grads = {}, {}
    to_plain = [(step_mod, "text_encoder_forward", plain_forward)]
    for side, patch, text_cfg in (("kernels", [], bf16_cfg), ("plain", to_plain, bf16_cfg),
                                  ("plain_f32", to_plain,
                                   dataclasses.replace(bf16_cfg, dtype=torch.float32))):
        keep = KeepGrads()
        step = make_train_step(trainer.pi_cfg, trainer.pn_cfg, trainer.loss_fn, keep,
                               decision_threshold=THRESHOLD, **dict(kw, text_cfg=text_cfg))
        _, m = patched(patch, lambda: step(trainer.ts, batch,
                                           torch.Generator(device="cuda").manual_seed(7)))
        norms[side] = float(m["grad_norm"])
        step_grads[side] = {names[id(t)]: g.float() for t, g in
                            zip(tree_leaves(trainer.ts["trainable"]), keep.grads)
                            if id(t) in names}
        del keep
    norm_err = abs(norms["kernels"] - norms["plain"]) / norms["plain"]

    def l2_all(grads: dict, ref: dict) -> float:
        num = sum(float(((grads[n] - ref[n]) ** 2).sum()) for n in kept)
        return (num / sum(float((ref[n] ** 2).sum()) for n in kept)) ** 0.5

    result = {"leaves": len(kept), "l2_rel_err_vs_plain": worst(l2_errs),
              "max_rel_err_vs_plain": worst(max_rel("kernels", "plain")),
              "max_rel_err_vs_plain_backward": worst(bwd_errs),
              "l2_rel_err_to_f32": {side: qk_split(l2_rel(side, "plain_f32"))
                                    for side in ("kernels", "plain", "plain_f32_core")},
              "all_leaves_l2_rel_err_to_f32": {
                  "tower": {side: l2_all(tower[side], tower["plain_f32"])
                            for side in ("kernels", "plain")},
                  "step": {side: l2_all(step_grads[side], step_grads["plain_f32"])
                           for side in ("kernels", "plain")}},
              "zero_gradient_leaves": len(noise),
              "zero_gradient_max_share": max(noise.values()) if noise else None,
              "grad_norm": norms, "grad_norm_rel_err": norm_err, "rel_tol": GRAD_REL_TOL}
    if (max(list(l2_errs.values()) + list(bwd_errs.values()) + [norm_err]) > GRAD_REL_TOL
            or max(noise.values(), default=0.0) > 1e-3 or not math.isfinite(norm_err)):
        raise AssertionError(f"tower gradients through the kernels disagree with the plain "
                             f"chain: {result}")
    return result


def k7_lengths(rng, T: int):
    """32 sequence lengths at bucket ``T``: the serving batch's 100-``T``,
    with one sequence of 30 (every dilation-81 tap but the centre reads only
    padding there)."""
    import numpy as np

    lens = rng.integers(100, T + 1, size=B).astype(np.int32)
    lens[-1] = 30
    return lens


def phase_k7_bwd(card: str) -> dict:
    """K7's backward kernels alone at full width (1,100 channels, 5 blocks,
    32 sequences at bucket 512, lengths 30-512) on random bf16 activations
    and cotangents: ``masked_conv_dx`` on the 10 block convs,
    ``masked_conv_dw`` (dW and dbias) on all 11, and the train-mode masked
    BN + ReLU (K7-BN) forward and backward on the 10 BatchNorms (1,100 and
    550 channels, one row dropped by the example mask), each against the
    plain chain's autograd on the same tensors.  Times are of the whole
    chain's calls from CUDA events, beside the plain versions' (the backward
    alone, on a retained graph) and, for the convs, cuDNN's conv backward on
    the same shapes (``torch.nn.grad.conv1d_input`` / ``conv1d_weight``, the
    library time, which the port never calls); bounds are the convs'
    products for these lengths over the bf16 peak and the BN's bytes (each
    input read once, each output written once) over the memory rate."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.models.proteinfer import (
        BN_EPS,
        BN_MOMENTUM,
        ProteInferConfig,
        init_proteinfer,
        one_hot_sequences,
    )
    from protnote_tpu_torch.ops import masked_conv as k7

    dev, bf16, T = torch.device("cuda"), torch.bfloat16, 512
    cfg = ProteInferConfig(compute_dtype=bf16)
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    params, state = tree_to(params, dev), tree_to(state, dev)
    rng = np.random.default_rng(17)
    lens = k7_lengths(rng, T)
    lengths = torch.from_numpy(lens).to(dev)
    gen = torch.Generator(device=dev).manual_seed(18)

    def act(c, shift=0.0):
        return (torch.randn(B, T, c, generator=gen, device=dev) + shift).to(bf16)

    ids = torch.from_numpy(rng.integers(0, 21, (B, T))).to(dev)
    convs = []
    for name, p, d in k7_convs(params, cfg):
        w, b = p["kernel"].to(bf16).contiguous(), p["bias"].to(bf16)
        x = (one_hot_sequences(ids, cfg.input_channels, bf16) if name == "conv1"
             else torch.relu(act(w.shape[1])))
        convs.append((name, x, w, b, d, act(w.shape[2])))
    out, errs = {}, {"dx": [], "dw": [], "db": []}
    plain_dx, plain_dw, lib_dx, lib_dw = [], [], [], []
    dw_same_bits = True
    for name, x, w, b, d, dy in convs:
        xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = k7.masked_conv_reference(xg, wg, bg, lengths, d)
        taps, pad = w.shape[0], d * (w.shape[0] - 1) // 2
        w_t, x_t, dy_t = (t.permute(*perm).contiguous() for t, perm in
                          ((w, (2, 1, 0)), (x, (0, 2, 1)), (dy, (0, 2, 1))))
        gw, gb = torch.autograd.grad(y, [wg, bg], dy, retain_graph=True)
        dw, db = k7.masked_conv_dw_cuda(x, dy, lengths, taps, d)
        dw2, db2 = k7.masked_conv_dw_cuda(k7.pad_pitch(x), k7.pad_pitch(dy), lengths, taps, d)
        dw_same_bits = dw_same_bits and torch.equal(dw, dw2) and torch.equal(db, db2)
        errs["dw"].append(rel_max(dw, gw))
        errs["db"].append(rel_max(db, gb))
        plain_dw.append(lambda y=y, wg=wg, bg=bg, dy=dy: torch.autograd.grad(
            y, [wg, bg], dy, retain_graph=True))
        lib_dw.append(lambda x_t=x_t, w_t=w_t, dy_t=dy_t, pad=pad, d=d: torch.nn.grad.conv1d_weight(
            x_t, w_t.shape, dy_t, padding=pad, dilation=d))
        if name != "conv1":
            (gx,) = torch.autograd.grad(y, [xg], dy, retain_graph=True)
            errs["dx"].append(rel_max(k7.masked_conv_dx_cuda(dy, w, lengths, d), gx))
            plain_dx.append(lambda y=y, xg=xg, dy=dy: torch.autograd.grad(
                y, [xg], dy, retain_graph=True))
            lib_dx.append(lambda x_t=x_t, w_t=w_t, dy_t=dy_t, pad=pad, d=d:
                          torch.nn.grad.conv1d_input(x_t.shape, w_t, dy_t, padding=pad,
                                                     dilation=d))
    dx_calls = [(dy, w, d) for name, _, w, _, d, dy in convs if name != "conv1"]
    dx_ms = cuda_time_ms(lambda: [k7.masked_conv_dx_cuda(dy, w, lengths, d)
                                  for dy, w, d in dx_calls], 5)
    # the kernel alone: dy already at the padded pitch, W already re-laid
    # (the wrapper copies dy and re-lays W at every call, as training does)
    dx_kernel_calls = [(k7.pad_pitch(dy), w, d, k7.conv_weight_layout(w, dx=True))
                       for dy, w, d in dx_calls]
    dx_kernel_ms = cuda_time_ms(lambda: [k7.masked_conv_dx_cuda(dy, w, lengths, d, layout=lay)
                                         for dy, w, d, lay in dx_kernel_calls], 5)
    del dx_kernel_calls
    # dW on x and dy at the padded pitch, as the training path passes them
    # (the forward saves its padded input; dy is padded once for dX and dW),
    # and from the contiguous tensors, which the wrapper copies first
    dw_calls = [(k7.pad_pitch(x), k7.pad_pitch(dy), w.shape[0], d) for _, x, w, _, d, dy in convs]
    dw_ms = cuda_time_ms(lambda: [k7.masked_conv_dw_cuda(x, dy, lengths, taps, d)
                                  for x, dy, taps, d in dw_calls], 5)
    dw_copies_ms = cuda_time_ms(lambda: [k7.masked_conv_dw_cuda(x, dy, lengths, w.shape[0], d)
                                         for _, x, w, _, d, dy in convs], 5)
    dw_plans = [k7._dw_plan_on(lengths, T, taps, d, x.shape[2], dy.shape[2], dev)
                for x, dy, taps, d in dw_calls]
    dw_partial_bytes = sum(4.0 * pl.splits * taps * x.shape[2] * dy.shape[2]
                           for pl, (x, dy, taps, _) in zip(dw_plans, dw_calls) if pl.splits > 1)
    del dw_calls
    flop_dx = k7_flops(lens, T, params, cfg, skip_conv1=True)
    flop_dw = k7_flops(lens, T, params, cfg)
    for key, ms, plain, lib, flop, names in (
            ("masked_conv_dx", dx_ms, plain_dx, lib_dx, flop_dx, ("dx",)),
            ("masked_conv_dw", dw_ms, plain_dw, lib_dw, flop_dw, ("dw", "db"))):
        worst = max(r for n in names for _, r in errs[n])
        out[key] = {"max_abs_err": max(e for n in names for e, _ in errs[n]),
                    "max_rel_err": worst, "ms": ms,
                    "plain_ms": cuda_time_ms(lambda: [f() for f in plain], 3),
                    **bound(ops=flop), "library_ms": cuda_time_ms(lambda: [f() for f in lib], 3),
                    "tflops": flop / ms / 1e9, "calls": len(plain)}
        out[key]["share_of_bound"] = out[key]["bound_ms"] / ms
        if worst > K45_REL_TOL:
            raise AssertionError(f"{key} disagrees with the plain backward: {errs}")
    out["masked_conv_dw"].update(with_copies_ms=dw_copies_ms, same_bits=dw_same_bits,
                                 splits=[pl.splits for pl in dw_plans],
                                 partial_bytes=dw_partial_bytes)
    if not dw_same_bits:
        raise AssertionError("masked_conv_dw: two calls on the same tensors differ")
    del plain_dx, plain_dw, lib_dx, lib_dw, convs
    torch.cuda.empty_cache()

    # K7-BN: the 10 BatchNorms of a training step
    em = torch.ones(B, device=dev)
    em[3] = 0.0
    bns = [(bp[n], bs[n]) for bp, bs in zip(params["blocks"], state["blocks"])
           for n in ("bn1", "bn2")]
    items, errs = [], {"y": [], "stats": [], "dx": [], "sums": []}
    for p, s in bns:
        C = p["scale"].shape[0]
        x, g = act(C, 0.3), act(C)
        y, mean, var, stats, counts = k7.masked_bn_relu_forward_cuda(
            x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, BN_EPS, BN_MOMENTUM)
        xg = x.clone().requires_grad_(True)
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y0, new0 = k7.masked_bn_relu_reference(xg, pg, s, lengths, em, BN_EPS, BN_MOMENTUM)
        dx0, ds0, db0 = torch.autograd.grad(y0, [xg, pg["scale"], pg["bias"]], g,
                                            retain_graph=True)
        dx, ds, db = k7.masked_bn_relu_backward_cuda(x, y, g, p["scale"], stats, counts,
                                                     lengths, em)
        errs["y"].append(rel_max(y, y0))
        errs["stats"] += [rel_max(mean, new0["mean"]), rel_max(var, new0["var"])]
        errs["dx"].append(rel_max(dx, dx0))
        errs["sums"] += [rel_max(ds, ds0), rel_max(db, db0)]
        items.append((p, s, x, g, y, stats, counts, xg, pg, y0))
    fwd_ms = cuda_time_ms(lambda: [k7.masked_bn_relu_forward_cuda(
        x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, BN_EPS, BN_MOMENTUM)
        for p, s, x, *_ in items], 5)
    fwd_plain_ms = cuda_time_ms(lambda: [k7.masked_bn_relu_reference(
        x, p, s, lengths, em, BN_EPS, BN_MOMENTUM) for p, s, x, *_ in items], 3)
    bwd_ms = cuda_time_ms(lambda: [k7.masked_bn_relu_backward_cuda(
        x, y, g, p["scale"], stats, counts, lengths, em)
        for p, s, x, g, y, stats, counts, *_ in items], 5)
    bwd_plain_ms = cuda_time_ms(lambda: [torch.autograd.grad(
        y0, [xg, pg["scale"], pg["bias"]], g, retain_graph=True)
        for p, s, x, g, y, stats, counts, xg, pg, y0 in items], 3)
    elems = sum(B * T * p["scale"].shape[0] for p, _ in bns)
    worst = {k: max(r for _, r in v) for k, v in errs.items()}
    out["masked_bn_relu_fwd"] = {
        "max_abs_err": max(e for e, _ in errs["y"]), "ms": fwd_ms,
        "plain_ms": fwd_plain_ms, **bound(nbytes=2.0 * 2 * elems), "library_ms": None,
        "max_rel_err": worst["y"], "stats_rel_err": worst["stats"], "calls": len(items)}
    out["masked_bn_relu_bwd"] = {
        "max_abs_err": max(e for e, _ in errs["dx"]), "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        **bound(nbytes=4.0 * 2 * elems), "library_ms": None, "max_rel_err": worst["dx"],
        "sums_rel_err": worst["sums"], "calls": len(items)}
    if worst["y"] > K45_REL_TOL or worst["dx"] > K45_REL_TOL or \
            worst["stats"] > K7_F32_REL_TOL or worst["sums"] > K7_SUMS_REL_TOL:
        raise AssertionError(f"K7-BN disagrees with its plain version: {worst}")
    out["masked_conv_dx"]["kernel_only_ms"] = dx_kernel_ms
    log("k7_bwd", batch=B, bucket=T, lengths=[int(n) for n in lens], kernels=out,
        ptxas=k7_ptxas("masked_conv_bwd"),
        rel_tol={"outputs": K45_REL_TOL, "stats": K7_F32_REL_TOL, "sums": K7_SUMS_REL_TOL},
        card=card)
    del items
    torch.cuda.empty_cache()
    return out


def encoder_grad_check(trainer, batch, cfg) -> dict:
    """One batch through the trainable encoder (``trainable["encoder"]``,
    float32 masters, bf16 compute) with train-mode BatchNorm, through K7's
    kernels and through the plain chain, under one fixed cotangent on the
    pooled embeddings: each trained leaf's gradient through the kernels
    within GRAD_REL_TOL of the plain chain's in L2, and the new running
    statistics within STATS_REL_TOL of the plain chain's largest |value|."""
    import torch

    from protnote_tpu_torch.models.proteinfer import (
        embed_from_ids,
        one_hot_sequences,
        proteinfer_embed_reference,
    )
    from protnote_tpu_torch.train.optim import tree_leaves

    enc, state = trainer.ts["trainable"]["encoder"], trainer.ts["enc_state"]
    named = [(f"{name}.{k}", p[k]) for name, p, _ in k7_convs(enc, cfg) for k in ("kernel", "bias")]
    named += [(f"block{i}.{n}.{k}", bp[n][k]) for i, bp in enumerate(enc["blocks"])
              for n in ("bn1", "bn2") for k in ("scale", "bias")]
    leaves = [t for _, t in named]
    aa, lengths, em = batch["aa_ids"], batch["lengths"], batch["example_mask"]
    onehot = one_hot_sequences(aa, cfg.input_channels, torch.bfloat16)
    cot = torch.randn(aa.shape[0], cfg.output_channels,
                      generator=torch.Generator(device=aa.device).manual_seed(7), device=aa.device)
    runs = {}
    for plain in (False, True):
        for t in leaves:
            t.requires_grad_(True)
        try:
            if plain:
                P, new = proteinfer_embed_reference(enc, state, onehot, lengths, cfg, True, em)
            else:
                P, new = embed_from_ids(enc, state, aa, lengths, cfg, train=True, example_mask=em)
            runs[plain] = (torch.autograd.grad((P * cot).sum(), leaves), new)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    (gk, new_k), (gp, new_p) = runs[False], runs[True]
    rel = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for (name, _), a, b in zip(named, gk, gp)}
    stats = max(rel_max(a, b)[1] for a, b in zip(tree_leaves(new_k), tree_leaves(new_p)))
    worst = max(rel.values())
    if worst > GRAD_REL_TOL or stats > STATS_REL_TOL:
        raise AssertionError(f"the encoder's gradients or statistics through K7 differ from "
                             f"the plain chain's: {rel}, stats {stats}")
    return {"leaves": len(named), "max_leaf_rel_l2": worst,
            "worst_leaf": max(rel, key=rel.get), "stats_rel_err": stats,
            "leaf_rel_l2": {k: round(v, 6) for k, v in rel.items()}}


def phase_encoder_training(card: str) -> dict:
    """Training the encoder at full width through ``Trainer.train``: with
    ``train_sequence_encoder`` (TRAIN_SEQUENCE_ENCODER) 9 steps of 32
    sequences at bucket 512 (step times, seqs/s, peak memory, every kernel's
    launches, a validation pass), 3 profiled steps (idle share, top
    kernels), the encoder's gradients and running statistics against the
    plain chain (:func:`encoder_grad_check`), a PNTPU1 checkpoint with
    ``trainable["encoder"]`` written, restored and compared leaf by leaf,
    and 2 steps at bucket 1024 for the peak memory there; then with
    ``encoder_bn_train_mode`` (ENCODER_BN_TRAIN_MODE) alone, the encoder
    frozen: 3 steps, its running statistics moved and its weights not.
    Returns the first run's launches of K7's kernels."""
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = train_datasets(tmp)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        pi_cfg, pn_cfg, ts = random_models()
        loss_fn = get_loss_fn(TRAIN_PARAMS)

        def batcher(ds, bucket, train):
            if train:
                return BucketBatcher(ds, TRAIN_B, buckets=(bucket,), shuffle=True,
                                     drop_last=True, seed=42, sequence_weights=weights,
                                     device_label_gather=True)
            return BucketBatcher(ds, TRAIN_B, buckets=(bucket,),
                                 descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True)

        def make(train_encoder: bool, bn_train: bool):
            opt = Optimizer(TRAIN_PARAMS)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt,
                                   train_sequence_encoder=train_encoder)
            tcfg = TrainerConfig(num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True,
                                 checkpoint_dir=tmp, run_name="encoder")
            return ts0, tcfg, Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev, loss_fn=loss_fn,
                                      optimizer=opt, train_sequence_encoder=train_encoder,
                                      encoder_bn_train_mode=bn_train)

        def run(name, trainer, bucket, steps_n, validate):
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, batch, g):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, batch, g)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"]),
                              int(batch["aa_ids"].shape[1])))
                return ts_, m

            trainer._train_step = timed_step
            reset_k7_launches()
            for k in st.LAUNCHES:
                st.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = trainer.train(FirstBatches(batcher(train_ds, bucket, True), steps_n),
                                    batcher(val_ds, bucket, False) if validate else None)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            trainer._train_step = step_fn
            launches = {**k7.LAUNCHES, **decomposed_launches()}
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            hist = summary["history"][0]
            fields = dict(steps=len(steps), sequences_per_step=TRAIN_B, bucket=bucket,
                          widths=sorted({x[3] for x in steps}), step_losses=losses,
                          grad_norms=[x[2] for x in steps], first_step_ms=steps[0][0] * 1e3,
                          median_warm_step_ms=med * 1e3, seqs_per_s=TRAIN_B / med,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, run_s=run_s,
                          launches=launches, val_map_micro=hist.get("val_map_micro"),
                          val_loss=hist.get("val_loss"))
            if len(steps) != steps_n or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"encoder training {name}: {fields}")
            return fields

        # TRAIN_SEQUENCE_ENCODER at bucket 512
        ts0, tcfg, trainer = make(True, False)
        fields = run("train_sequence_encoder", trainer, 512, ENCODER_TRAIN_STEPS, True)
        if any(v <= 0 for v in fields["launches"].values()):
            raise AssertionError(f"encoder training skipped a kernel: {fields['launches']}")
        result = {k: fields["launches"][k] for k in k7.LAUNCHES}
        inner = batcher(train_ds, 512, True)
        inner.set_epoch(1)
        batches = []
        for b in inner:
            batches.append(b)
            if len(batches) == PROFILE_STEPS:
                break
        matrix = trainer._label_matrix_for(train_ds)
        placed = [trainer._place(batch_to_device_dict(b, dev), matrix) for b in batches]
        g_prof = torch.Generator(device=dev).manual_seed(1)
        it = iter(placed)
        step_fn = trainer._train_step

        def one_step():
            trainer.ts, _ = step_fn(trainer.ts, next(it), g_prof)

        wall, busy, top = device_profile(one_step, len(placed))
        fields.update(profile_wall_ms_per_step=wall * 1e3 / len(placed),
                      profile_device_busy_ms_per_step=None if busy is None
                      else busy * 1e3 / len(placed),
                      idle_share=None if busy is None else 1.0 - busy / wall,
                      top_kernels_ms_per_step=top,
                      grad_check=encoder_grad_check(trainer, placed[0], pi_cfg))
        log("encoder_train", run="train_sequence_encoder", **fields, card=card)

        # a checkpoint with trainable["encoder"], restored into a fresh trainer
        trainer.save("roundtrip")
        _, _, restored = make(True, False)
        restored.load(os.path.join(tmp, "encoder_roundtrip.ckpt"))
        a = [x for x in tree_leaves(trainer.ts) if isinstance(x, torch.Tensor)]
        b = [x for x in tree_leaves(restored.ts) if isinstance(x, torch.Tensor)]
        moved = float((trainer.ts["trainable"]["encoder"]["conv1"]["kernel"]
                       - ts["enc_params"]["conv1"]["kernel"].to(dev)).abs().max())
        if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)) or \
                restored.ts["enc_params"] is not None or moved == 0.0:
            raise AssertionError("the encoder checkpoint did not round-trip "
                                 f"(leaves {len(a)} vs {len(b)}, conv1 moved {moved})")
        log("encoder_checkpoint", leaves=len(a), encoder_leaves=len(tree_leaves(
            restored.ts["trainable"]["encoder"])), conv1_moved=moved,
            bytes=os.path.getsize(os.path.join(tmp, "encoder_roundtrip.ckpt")))
        del trainer, restored, placed, batches, a, b
        torch.cuda.empty_cache()

        # the peak memory at bucket 1024
        _, _, trainer = make(True, False)
        log("encoder_train", run="train_sequence_encoder_1024",
            **run("train_sequence_encoder_1024", trainer, 1024, ENCODER_1024_STEPS, False),
            card=card)
        del trainer
        torch.cuda.empty_cache()

        # ENCODER_BN_TRAIN_MODE: the encoder frozen, its BatchNorm on batch statistics
        _, _, trainer = make(False, True)
        fields = run("encoder_bn_train_mode", trainer, 512, ENCODER_BN_STEPS, True)
        launches = fields["launches"]
        state0 = tree_leaves(ts["enc_state"])
        moved = max(float((x - y.to(dev)).abs().max())
                    for x, y in zip(tree_leaves(trainer.ts["enc_state"]), state0))
        frozen = all(torch.equal(x, y.to(dev)) for x, y in zip(
            tree_leaves(trainer.ts["enc_params"]), tree_leaves(ts["enc_params"])))
        if launches["masked_bn_relu_fwd"] <= 0 or moved == 0.0 or not frozen or any(
                launches[k] for k in ("masked_conv_dx", "masked_conv_dw", "masked_bn_relu_bwd")):
            raise AssertionError(f"ENCODER_BN_TRAIN_MODE: launches {launches}, running "
                                 f"statistics moved {moved}, weights frozen {frozen}")
        log("encoder_train", run="encoder_bn_train_mode", **fields, stats_moved=moved,
            card=card)
        del trainer
        torch.cuda.empty_cache()
    return result


def phase_k6(card: str) -> dict:
    """Phase 20a: each K6 kernel alone at the streamed path's shape (32
    sequences x a 2,048-label tile = 65,536 pair rows, H 3072), on random
    bf16 pre-activations around the running mean with a masked sequence and
    masked labels, against its plain version on the same device tensors:
    bf16 outputs (y, dz, dw) within 2^-6 of the plain output's largest
    |value|, the float32 sums (moments, dinv, dshift, logits, db) within
    1e-3; CUDA-event times beside the bound and the plain version's.  No
    single PyTorch call computes any of the six functions (``batch_norm``
    takes its own or the running statistics and no pair mask, and none
    fuses the ReLU, the rounding or the output dot), so ``library_ms`` is
    None."""
    import torch

    from protnote_tpu_torch.ops import streaming_train as st

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    N = TRAIN_B * STREAM_TILE
    g = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        r = 0.3 * torch.randn(H, device=dev, generator=g)
        z = (torch.randn(N, H, device=dev, generator=g) + r).to(bf16)
        em = torch.ones(TRAIN_B, device=dev)
        em[-1] = 0.0
        lm = (torch.rand(STREAM_TILE, device=dev, generator=g) < 0.98).float()
        rows = (em[:, None] * lm[None, :]).reshape(N, 1)
        inv = 0.5 + torch.rand(H, device=dev, generator=g)
        shift = 0.3 * torch.randn(H, device=dev, generator=g)
        w = (torch.randn(H, device=dev, generator=g) * (6.0 / H) ** 0.5).to(bf16)
        b = torch.tensor(0.1, device=dev)
        dy = torch.randn(N, H, device=dev, generator=g).to(bf16)
        g1 = torch.randn(H, device=dev, generator=g) / N
        g2 = torch.randn(H, device=dev, generator=g) / N
        dout = torch.randn(N, device=dev, generator=g) * 1e-2
        calls = {
            "stream_moments": (lambda: st._stream_moments_cuda(z, rows, r),
                               lambda: st._stream_moments_plain(z, rows, r), ("s1", "s2")),
            "stream_moments_backward": (
                lambda: (st._stream_moments_grad_cuda(z, rows, r, g1, g2),),
                lambda: (st._stream_moments_grad_plain(z, rows, r, g1, g2),), ("dz",)),
            "affine_relu": (lambda: (st._affine_relu_cuda(z, inv, shift),),
                            lambda: (st._affine_relu_plain(z, inv, shift),), ("y",)),
            "affine_relu_backward": (lambda: st._affine_relu_grads_cuda(z, dy, inv, shift),
                                     lambda: st._affine_relu_grads_plain(z, dy, inv, shift),
                                     ("dz", "dinv", "dshift")),
            "stream_head": (lambda: (st._stream_head_cuda(z, inv, shift, w, b),),
                            lambda: (st._stream_head_plain(z, inv, shift, w, b),), ("logits",)),
            "stream_head_backward": (lambda: st._stream_head_grads_cuda(z, inv, shift, w, dout),
                                     lambda: st._stream_head_grads_plain(z, inv, shift, w, dout),
                                     ("dz", "dinv", "dshift", "dw", "db")),
        }
        errs, rel, times = {}, {}, {}
        for name, (kern, plain, outs) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs[name] = {o: delta(a, b_) for o, a, b_ in zip(outs, got, want)}
            rel[name] = {o: d[0] / max(d[1], 1e-30) for o, d in errs[name].items()}
            tols = {o: K45_REL_TOL if a.dtype == bf16 else K6_SUMS_REL_TOL
                    for o, a in zip(outs, got)}
            if any(rel[name][o] > tols[o] for o in outs):
                raise AssertionError(f"{name} disagrees with its plain version: {errs[name]}")
            del got, want
            times[name] = (cuda_time_ms(kern, 20), cuda_time_ms(plain, 3))
    nh = float(N) * H
    f32 = {  # bytes: each input read once, each output written once; f32 operations
        "stream_moments": bound(2 * nh + 4 * N + 12 * H, 5 * nh, F32_FLOPS),
        "stream_moments_backward": bound(4 * nh + 4 * N + 12 * H, 4 * nh, F32_FLOPS),
        "affine_relu": bound(4 * nh + 8 * H, 3 * nh, F32_FLOPS),
        "affine_relu_backward": bound(6 * nh + 16 * H, 6 * nh, F32_FLOPS),
        "stream_head": bound(2 * nh + 4 * N + 10 * H, 5 * nh, F32_FLOPS),
        "stream_head_backward": bound(4 * nh + 4 * N + 18 * H + 4, 11 * nh, F32_FLOPS),
    }
    log("k6_kernels_alone", rows=N, width=H, tile=STREAM_TILE,
        max_abs_errs={k: {o: d[0] for o, d in v.items()} for k, v in errs.items()},
        rel_errs=rel, bf16_rel_tol=K45_REL_TOL, sums_rel_tol=K6_SUMS_REL_TOL,
        ms={k: v[0] for k, v in times.items()}, plain_ms={k: v[1] for k, v in times.items()},
        bound_ms={k: v["bound_ms"] for k, v in f32.items()},
        library="none: no single PyTorch call computes these functions", card=card)
    first = {k: next(iter(v.values()))[0] for k, v in errs.items()}  # the main output's
    return {k: {"max_abs_err": first[k], "ms": times[k][0], "plain_ms": times[k][1], **f32[k],
                "library_ms": None} for k in calls}


def phase_streamed_scorer(card: str) -> None:
    """Phase 20b: the streamed scorer at full width (32 sequences x 32,102
    labels, tile 2,048, ``random_output_mlp``), with the z1 cache by the
    rule (on at this size) and off, against the decomposed scorer through
    K4 + K5 on the same device tensors under one fixed cotangent: logits
    within 5e-2, new running statistics within 1e-2 and every gradient
    (P_e, L_e, each output-MLP leaf) within 5e-2 of its largest |value|;
    and ``pair_logits_streaming_train_reference`` (the plain versions of K4
    and K6) against the kernels at the same tolerances.  Each run's
    forward + backward seconds and peak memory are printed."""
    import torch

    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.optim import tree_leaves, tree_map

    dev = torch.device("cuda")
    p, s = random_output_mlp(dev)
    gen = torch.Generator().manual_seed(14)
    P_e = torch.randn(TRAIN_B, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(NUM_LABELS, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    em = torch.ones(TRAIN_B, device=dev)
    em[-1] = 0.0
    lm = (torch.rand(NUM_LABELS, generator=gen) < 0.98).float().to(dev)
    w = torch.randn(TRAIN_B, NUM_LABELS, generator=gen).to(dev) * em[:, None] * lm[None, :]
    scorers = {
        "decomposed": (st.pair_logits_dense_decomposed, {}),
        "streamed_cache_auto": (st.pair_logits_streaming_train, {"label_tile": STREAM_TILE}),
        "streamed_cache_off": (st.pair_logits_streaming_train,
                               {"label_tile": STREAM_TILE, "cache_first": False}),
        "streamed_plain": (st.pair_logits_streaming_train_reference,
                           {"label_tile": STREAM_TILE}),
    }
    runs, fields = {}, {}
    for name, (scorer, kw) in scorers.items():
        seconds = []
        for _ in range(2):  # the first call's time, then a warm one's
            pp = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
            Pg, Lg = P_e.clone().requires_grad_(True), L_e.clone().requires_grad_(True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            logits, new = scorer(pp, s, Pg, Lg, example_mask=em, label_mask=lm, **kw)
            (torch.sigmoid(logits) * w).sum().backward()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            runs[name] = (logits.detach(), new, [Pg.grad, Lg.grad] + [t.grad for t in
                                                                     tree_leaves(pp)])
            del pp, Pg, Lg, logits
        fields[name] = {"fwd_bwd_s": seconds,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        torch.cuda.empty_cache()
    checks = {}
    for name, ref in (("streamed_cache_auto", "decomposed"), ("streamed_cache_off", "decomposed"),
                      ("streamed_plain", "streamed_cache_auto")):
        (lg, new, grads), (lg0, new0, grads0) = runs[name], runs[ref]
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name}: logits not all finite")
        checks[f"{name}_vs_{ref}"] = {
            "max_abs_logit_err": float((lg - lg0).abs().max()),
            "max_rel_stats_err": max(rel_err(a[k], b[k]) for a, b in zip(new["bns"], new0["bns"])
                                     for k in ("mean", "var")),
            "max_rel_grad_err": max(rel_err(a, b) for a, b in zip(grads, grads0)),
            "grads": len(grads)}
    log("streamed_scorer_check", batch=TRAIN_B, labels=NUM_LABELS, tile=STREAM_TILE,
        checks=checks, logit_atol=TRAIN_LOGIT_ATOL, stats_rel_tol=STATS_REL_TOL,
        grad_rel_tol=GRAD_REL_TOL, logit_std=float(runs["decomposed"][0].std()), runs=fields,
        card=card)
    for name, c in checks.items():
        if not (c["max_abs_logit_err"] <= TRAIN_LOGIT_ATOL
                and c["max_rel_stats_err"] <= STATS_REL_TOL
                and c["max_rel_grad_err"] <= GRAD_REL_TOL and c["grads"] == 13):
            raise AssertionError(f"the streamed scorer disagrees ({name}): {c}")


def memory_split(fn, run: str, card: str) -> dict:
    """Run ``fn`` (one training step) once under
    ``torch.cuda.memory._record_memory_history`` and print what sets its
    peak: the memory resident before it (parameters, moments, the label
    matrix), the step's own allocations at their peak, and the largest of
    those live at that moment, grouped by the port's source line that
    allocated them (its innermost frame under ``protnote_tpu_torch/``, and
    that frame's caller there)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # allocation stacks only: a free's stack taken while torch.utils.checkpoint
    # stops its recomputation (an exception in flight) breaks the step
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=500000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]

    def replay(stop=None):
        live, cur, peak, at = {}, 0, 0, 0
        for i, ev in enumerate(trace[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] == "free_requested":
                live.pop(ev["addr"], None)
                cur -= ev["size"]  # also frees of tensors made before the step
            if cur > peak:
                peak, at = cur, i + 1
        return live, peak, at

    _, peak, at = replay()
    live, _, _ = replay(at)

    def site(ev):
        mine = [f for f in ev.get("frames", []) if "protnote_tpu_torch" in f["filename"]
                or f["filename"].endswith("chip_smoke.py")]
        return " <- ".join(f"{os.path.relpath(f['filename'], ROOT)}:{f['line']} {f['name']}"
                           for f in mine[:2]) or "(no Python frame: made by the autograd engine)"

    groups = {}
    for ev in live.values():
        key = site(ev)
        size, n = groups.get(key, (0, 0))
        groups[key] = (size + ev["size"], n + 1)
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:MEMORY_TOP]
    fields = {"resident_before_gb": base / 2**30, "step_peak_gb": (base + peak) / 2**30,
              "max_allocated_gb": torch.cuda.max_memory_allocated() / 2**30,
              "live_at_peak_gb": sum(e["size"] for e in live.values()) / 2**30,
              "events": len(trace),
              "top": [{"site": k, "gb": v[0] / 2**30, "allocations": v[1]} for k, v in top]}
    log("memory_split", run=run, **fields, card=card)
    return fields


def phase_streamed_training(card: str) -> dict:
    """Phase 20c: training through ``Trainer.train`` with
    ``TRAIN_STREAMING_LABEL_TILE 2048`` at full width: 9 steps of 32
    sequences with a validation pass (step ms, seqs/s, peak memory, every
    kernel's launches: K4, K4-bwd and K6 held to ``streamed_launches`` a
    step, K5's 0), the decomposed step's 9 steps beside it, 3 profiled
    streamed steps (idle share, top kernels), one decomposed and one
    streamed step under the memory history (:func:`memory_split`), and 2
    steps of 128 sequences with ``TRAIN_STREAMING_CACHE False`` and 2 with
    the rule's choice (the peak of each).  Returns the 32-sequence streamed
    run's launches."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    buckets = (256, 512, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = train_datasets(tmp)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        pi_cfg, pn_cfg, ts = random_models()
        pn_cfg = dataclasses.replace(pn_cfg, label_embedding_noising_alpha=NOISING_ALPHA)
        stream_cfg = dataclasses.replace(pn_cfg, train_label_tile=STREAM_TILE)
        loss_fn = get_loss_fn(TRAIN_PARAMS)
        val_b = BucketBatcher(val_ds, TRAIN_B, buckets=buckets,
                              descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True)

        def batcher(batch, bucket_set):
            return BucketBatcher(train_ds, batch, buckets=bucket_set, shuffle=True,
                                 drop_last=True, seed=42, sequence_weights=weights,
                                 device_label_gather=True)

        def run(name, cfg, batch, bucket_set, steps_n, validate):
            opt = Optimizer(TRAIN_PARAMS)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt)
            tcfg = TrainerConfig(num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True,
                                 checkpoint_dir=None, run_name="streamed")
            trainer = Trainer(ts0, pi_cfg, cfg, tcfg, device=dev, loss_fn=loss_fn, optimizer=opt)
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, b, g):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, b, g)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"])))
                return ts_, m

            trainer._train_step = timed_step
            ps.LAUNCHES = 0
            for counts in (k3.LAUNCHES, st.LAUNCHES):
                for k in counts:
                    counts[k] = 0
            reset_k7_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = trainer.train(FirstBatches(batcher(batch, bucket_set), steps_n),
                                    val_b if validate else None)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            trainer._train_step = step_fn
            check_k7_forward(k7.LAUNCHES, name)
            launches = {"pair_mlp_layer": ps.LAUNCHES,
                        **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}, **st.LAUNCHES,
                        **{k: k7.LAUNCHES[k] for k in K7_FORWARD}}
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            hist = summary["history"][0]
            fields = dict(steps=len(steps), sequences_per_step=batch, labels=NUM_LABELS,
                          tile=cfg.train_label_tile, cache=cfg.train_streaming_cache,
                          step_losses=losses, grad_norms=[x[2] for x in steps],
                          first_step_ms=steps[0][0] * 1e3, median_warm_step_ms=med * 1e3,
                          seqs_per_s=batch / med,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, run_s=run_s,
                          launches=launches, val_map_micro=hist.get("val_map_micro"),
                          val_loss=hist.get("val_loss"))
            if len(steps) != steps_n or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"streamed training {name}: {fields}")
            return trainer, fields

        def placed_batches(trainer, batch, bucket_set, n):
            inner = batcher(batch, bucket_set)
            inner.set_epoch(1)
            matrix = trainer._label_matrix_for(train_ds)
            out = []
            for b in inner:
                out.append(trainer._place(batch_to_device_dict(b, dev), matrix))
                if len(out) == n:
                    break
            return out

        dec, dec_fields = run("decomposed", pn_cfg, TRAIN_B, buckets, STREAM_STEPS, False)
        log("streamed_train", run="decomposed", **dec_fields, card=card)
        trainer, fields = run("streamed", stream_cfg, TRAIN_B, buckets, STREAM_STEPS, True)
        cache = st.streaming_cache_first(TRAIN_B, -(-NUM_LABELS // STREAM_TILE) * STREAM_TILE,
                                         STREAM_TILE, H, 2, 3, dev)
        per_step = st.streamed_launches(3, -(-NUM_LABELS // STREAM_TILE), cache)
        want = {k: v * STREAM_STEPS for k, v in per_step.items()}
        got = {k: fields["launches"][k] for k in want}
        if got != want or fields["launches"]["pair_mlp_layer"] <= 0:
            raise AssertionError(f"streamed training launched {got}, the schedule says {want}")

        placed = placed_batches(trainer, TRAIN_B, buckets, PROFILE_STEPS)
        gen = torch.Generator(device=dev).manual_seed(1)
        it = iter(placed)

        def one_step():
            trainer.ts, _ = trainer._train_step(trainer.ts, next(it), gen)

        wall, busy, top = device_profile(one_step, len(placed))
        fields.update(cache_by_rule=cache, launches_per_step=per_step,
                      decomposed_median_warm_step_ms=dec_fields["median_warm_step_ms"],
                      decomposed_peak_mem_gb=dec_fields["peak_mem_gb"],
                      profile_wall_ms_per_step=wall * 1e3 / len(placed),
                      profile_device_busy_ms_per_step=None if busy is None
                      else busy * 1e3 / len(placed),
                      idle_share=None if busy is None else 1.0 - busy / wall,
                      top_kernels_ms_per_step=top)
        log("streamed_train", run="streamed", **fields, card=card)

        # what sets each step's peak: one step of each under the memory history
        for name, tr in (("decomposed", dec), ("streamed", trainer)):
            b0 = placed[0]

            def step_once(tr=tr, b0=b0):
                tr.ts, _ = tr._train_step(tr.ts, b0, gen)

            memory_split(step_once, name, card)
        launches = fields["launches"]
        del dec, trainer, placed, it
        torch.cuda.empty_cache()

        # 128 sequences a step: the cache off, then by the rule
        for name, cache_first in (("streamed_128_cache_off", False),
                                  ("streamed_128_cache_auto", None)):
            cfg = dataclasses.replace(stream_cfg, train_streaming_cache=cache_first)
            tr, f = run(name, cfg, STREAM_BIG_B, (1024,), STREAM_BIG_STEPS, False)
            f["cache_by_rule"] = st.streaming_cache_first(
                STREAM_BIG_B, -(-NUM_LABELS // STREAM_TILE) * STREAM_TILE, STREAM_TILE, H, 2, 3,
                dev) if cache_first is None else False
            log("streamed_train", run=name, **f, card=card)
            del tr
            torch.cuda.empty_cache()
    return launches


def main() -> None:
    sys.path.insert(0, ROOT)
    phase_device()
    import torch

    card = card_line()
    phase_build()
    k1 = phase_kernel(card)
    torch.cuda.empty_cache()
    k2 = phase_k2(card)
    torch.cuda.empty_cache()
    engine, build_s, rng = build_engine()
    log("engine", build_seconds=build_s, labels=NUM_LABELS, label_rows=NUM_LABELS * K_DESCRIPTIONS,
        latents=list(engine.latents.shape), latents_dtype=str(engine.latents.dtype))
    k7_fwd = phase_serving(engine, rng, card)[512]
    drift_seqs, drift_probs = phase_parity(engine, rng)
    int8_launches = phase_int8_serving(engine, rng, drift_seqs, drift_probs, card)
    del engine
    torch.cuda.empty_cache()
    k3_times = phase_k3(card)
    bf16_metrics = phase_eval(card, k3_times)
    torch.cuda.empty_cache()
    k9_times = phase_k9(card)
    torch.cuda.empty_cache()
    sweep_launches = phase_eval_sweep(card)
    torch.cuda.empty_cache()
    phase_exact_eval(card)
    torch.cuda.empty_cache()
    for name, v in phase_int8_eval(card, bf16_metrics).items():
        int8_launches[name] += v
    torch.cuda.empty_cache()
    train_times = phase_train_kernels(card)
    torch.cuda.empty_cache()
    launches, default_run = phase_training(card)
    torch.cuda.empty_cache()
    phase_train_settings(card, default_run)
    torch.cuda.empty_cache()
    k8_times = phase_k8(card)
    tower_launches, rows, plain_rows = phase_tower(card)
    phase_zero_shot(rows, plain_rows, card)
    del rows, plain_rows
    torch.cuda.empty_cache()
    k8_bwd_times = phase_k8_bwd(card)
    bwd_launches = phase_tower_training(card)
    torch.cuda.empty_cache()
    k7_bwd = phase_k7_bwd(card)
    torch.cuda.empty_cache()
    encoder_launches = phase_encoder_training(card)
    torch.cuda.empty_cache()
    k6_times = phase_k6(card)
    torch.cuda.empty_cache()
    phase_streamed_scorer(card)
    torch.cuda.empty_cache()
    stream_launches = phase_streamed_training(card)
    if "jax" in sys.modules or any(m == "protnote_tpu" or m.startswith("protnote_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port's serving, evaluation, training or tower path imported "
                             "jax or the JAX package")
    k3_src = "protnote_tpu_torch/csrc/eval_accumulator.cu"
    replaces = {"update": "protnote_tpu/evaln/metrics.py:601",
                "finalize": "protnote_tpu/evaln/metrics.py:732"}
    train_kernels = {
        "pair_train_hidden": ("protnote_tpu_torch/csrc/pair_train.cu",
                              "protnote_tpu/ops/streaming_train.py:157"),
        "pair_train_dx": ("protnote_tpu_torch/csrc/pair_train_bwd.cu",
                          "protnote_tpu/ops/streaming_train.py:157"),
        "pair_train_dw": ("protnote_tpu_torch/csrc/pair_train_bwd.cu",
                          "protnote_tpu/ops/streaming_train.py:157"),
        "bn_relu_forward": ("protnote_tpu_torch/csrc/bn_relu.cu",
                            "protnote_tpu/ops/streaming_train.py:98"),
        "bn_relu_backward": ("protnote_tpu_torch/csrc/bn_relu.cu",
                             "protnote_tpu/ops/streaming_train.py:115"),
    }
    print(json.dumps({"kernels": [{
        "name": "pair_mlp_layer", "route": "cuda",
        "source": "protnote_tpu_torch/csrc/pair_scorer.cu",
        "replaces": "protnote_tpu/ops/pair_scorer.py:197",
        "launches": launches["pair_mlp_layer"], **k1,
    }] + [{
        "name": f"eval_acc_{k}", "route": "cuda", "source": k3_src,
        "replaces": replaces[k], "launches": launches[f"eval_acc_{k}"], **k3_times[k],
    } for k in ("update", "finalize")] + [{
        "name": f"threshold_sweep_{k}", "route": "cuda",
        "source": "protnote_tpu_torch/csrc/threshold_sweep.cu",
        "replaces": "protnote_tpu/train/trainer.py:1117",
        "launches": sweep_launches[f"threshold_sweep_{k}"], **k9_times[k],
    } for k in ("update", "finalize")] + [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], **train_times[k],
    } for k, (src, rep) in train_kernels.items()] + [{
        "name": k, "route": "cuda", "source": "protnote_tpu_torch/csrc/pair_scorer_int8.cu",
        "replaces": "protnote_tpu/ops/pair_scorer.py:375", "launches": int8_launches[k], **k2[k],
    } for k in ("pair_int8_layer", "pair_int8_codes", "pair_int8_row_scale")] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": tower_launches[k],
        **{f: k8_times["a"][k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
    } for k, src, rep in (("text_attention", "text_attention",
                           "protnote_tpu/models/text_transformer.py:167"),
                          ("add_layer_norm", "layer_norm",
                           "protnote_tpu/models/text_transformer.py:159"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": bwd_launches[k],
        **{f: k8_bwd_times["a"][k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
    } for k, src, rep in (("text_attention_bwd", "text_attention_bwd",
                           "protnote_tpu/models/text_transformer.py:182"),
                          ("add_layer_norm_bwd", "layer_norm",
                           "protnote_tpu/models/text_transformer.py:159"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": runs[k], **{f: times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep, times, runs in (
        ("masked_conv_fwd", "masked_conv", "protnote_tpu/models/proteinfer.py:127", k7_fwd,
         launches),
        ("masked_mean_pool", "masked_conv", "protnote_tpu/models/proteinfer.py:147", k7_fwd,
         launches),
        ("masked_conv_dx", "masked_conv_bwd", "protnote_tpu/models/proteinfer.py:127", k7_bwd,
         encoder_launches),
        ("masked_conv_dw", "masked_conv_bwd", "protnote_tpu/models/proteinfer.py:127", k7_bwd,
         encoder_launches),
        ("masked_bn_relu_fwd", "masked_bn", "protnote_tpu/models/layers.py:102", k7_bwd,
         encoder_launches),
        ("masked_bn_relu_bwd", "masked_bn", "protnote_tpu/models/layers.py:102", k7_bwd,
         encoder_launches))] + [{
        "name": k, "route": "cuda", "source": "protnote_tpu_torch/csrc/streamed_bn.cu",
        "replaces": "protnote_tpu/ops/streaming_train.py:270", "launches": stream_launches[k],
        **{f: k6_times[k][f] for f in KERNEL_FIELDS},
    } for k in K6_KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
