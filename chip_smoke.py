#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, inference-CLI, evaluation,
training, int8, label-text-tower, encoder-training, streamed-training and
dense-scorer paths on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device: card name, power limit, CUDA and nvcc versions;
2. build: compiles every ``protnote_tpu_torch/csrc/*.cu`` with nvcc, one
   nvcc per source, all at once (and K9's first update,
   ``csrc/variants/threshold_sweep_v1.cu``, that phase 7 compares with),
   and prints each one's ptxas lines;
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
   (K7's library time) and the pool alone (events, device and host time,
   the same bits twice, a contiguous input too); TFLOP/s, share of the
   bound and the conv kernels' ptxas registers and spills;
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
   counted (element, threshold) pairs within 1e-6, the update's histogram
   equal to its first design's after every batch; update and finalize
   times beside their bounds and the plain version's, the first design's
   update beside, and the share of the batch's (slot, column) keys that
   repeat;
   7b. ``Trainer.evaluate(threshold_sweep=...)`` on the phase-7 FASTA in
   turns with the same evaluation without the sweep: seqs/s of both, the
   chosen threshold, K9's and K3's launches; then K9's update and its first
   design on the first batch of logits that evaluation gave the sweep
   (histograms equal, device times, repeated keys);
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
    codes) and the row-scale pass (dynamic scales and codes, its first form
    from a and c and its later form from the bf16 carry) against their
    plain versions on the first and the ragged last chunk, each pass over a
    batch's chunks by CUDA events, as device time (``torch.profiler``) and
    as the host's time a launch, each form beside its own bytes bound;
    each launch of one chunk timed alone with its ptxas figures, one
    profiled call of each mode (the device time of each pass and of the
    GEMM's launches a batch), times from CUDA events beside the 39.2 ms
    int8 bound, and ``torch._int_mm`` on the same GEMM shapes as the
    yardstick;
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
    tensors, which it copies), TFLOP/s, share of the bound, ptxas; the
    pool's transpose (``masked_mean_pool_backward``) bit for bit against the
    plain transpose, its padding channels 0, the same bits twice, by
    events, device and host time beside its bytes bound;
19. training the encoder through ``Trainer.train`` at full width, 32
    sequences a step at bucket 512: ``TRAIN_SEQUENCE_ENCODER`` for 9 steps
    (step ms, seqs/s, peak memory, K7's launches, a validation pass), 3
    profiled steps (idle share, top kernels), the encoder's gradients under
    one fixed cotangent leaf by leaf within 5e-2 (L2) of the plain chain's
    and its new running statistics within 1e-2, a PNTPU1 checkpoint with
    ``trainable["encoder"]`` round-tripped, 2 steps at bucket 1024 (the
    peak there); then ``ENCODER_BN_TRAIN_MODE`` for 3 steps (the running
    statistics move, the weights do not); the pool's backward kernel runs
    once a step, its device ms a step beside its bound;
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
    and 2 steps of 128 sequences with the cache off and 2 by the rule;
21. (run after phase 11) K7 in float32 (``k7_f32``): the 11 convs of a
    float32 full-width encoder (``masked_conv_forward_f32``, the eval BN
    prologue, the residual) and the float32 pool, each against its plain
    version on its recorded inputs (cuDNN with TF32 off: 1e-5 of each
    tensor's largest |value|; the pool 1e-5; the same bits twice), the
    chain's pooled embedding within 1e-4; each conv shape's time beside
    its bound (the products these lengths need over 67 TFLOP/s), the plain
    conv's and cuDNN's float32 conv1d (TF32 off, never called by the port);
22. ``cli/predict.py`` (``predict``): the default config with a 32,102 x 2
    label-embedding cache file and a 256-sequence FASTA, through
    ``build_predictor`` and the scoring generator, bf16 (K7 + K1) and
    ``PAIR_BACKEND tiled_int8`` (K7 + K2, calibrated on the first batch,
    timed apart): the CLI's seqs/s (``predict.main``'s window, scoring and
    writing the parquet shards, which are read back) where pandas and a
    parquet engine import (an import probe, on an earlier line); the
    scoring alone, seqs/s and pair-scores/s; the launches; the first
    batch's logits within 5e-2 of the plain chain's;
23. ``cli/test_proteinfer.py`` (``test_proteinfer``): ``main`` on a
    256-sequence labelled FASTA with a random float32 encoder and 32,102-label
    head, through K7's float32 kernels only, and its seqs/s; a 32-sequence
    batch's forward and its head's ms;
24. the dense scorer's kernels alone at full width (``dense_*``: 32
    sequences x 32,102 labels, d 1024, H 3072) against their plain versions
    (``ops/dense_scorer.py``): K5's centred BN + ReLU + dropout and its bias
    form, forward and backward (``csrc/bn_relu.cu``; 2^-6 of each tensor's
    largest |value|, the plain version in column slices, its backward on
    the kernel's statistics), their keep mask bit for bit against the
    plain hash over all 3.2e9 elements; ``pair_first_add`` (the same bits),
    ``pair_train_prod`` and ``pair_train_dw_prod`` (2^-6; cuBLAS on the
    materialised prod rows beside; ``pair_train_prod`` also timed on a
    serving chunk, ReLU'd into K1's padded rows), ``pair_side_sums`` plain
    and weighted (1e-3, the same bits twice; its partial rows' bytes and
    floor beside the bound); K1's prod and zero-hidden forms at the
    serving width (``pair_mlp_head``; |dlogit| 5e-2);
25. dense training (``dense_train_*``): ``Trainer.train`` with
    ``PAIR_BACKEND dense`` and ``OUTPUT_MLP_DROPOUT`` 0.1 at 32 sequences
    against 32,102 labels, then with ``concatenation_prod``, without
    output-MLP BatchNorm and with ``GRADIENT_CHECKPOINTING``: step ms,
    seqs/s, peak memory, launches against ``dense_launches``, a profile of
    two steps (idle share, kernel ms by name);
26. dense evaluation (``dense_eval``): ``Trainer.evaluate`` with
    ``PAIR_BACKEND dense`` on phase 7's FASTA, seqs/s, launches, a batch's
    logits against the plain dense scorer's;
27. dense serving (``dense_serving_*``): ``ServingEngine`` with
    ``concatenation_prod`` and with ``OUTPUT_MLP_NUM_LAYERS 1`` against the
    plain forward, batch ms and launches;
28. (run after phase 23) ``MIXED_PRECISION False``'s kernels at full width
    (``f32_*``: 32 sequences x 64,204 label rows, d 1024, H 3072, float32
    weights): K1 in float32 (``csrc/pair_scorer_f32.cu``: a bf16x3 split on
    the tensor cores), its prod form, its one-layer head
    (``pair_mlp_head_f32``, also alone) and K2's float32 form (static and
    dynamic), each within 1e-5 of its plain float32 version's largest
    |logit| (cuBLAS with TF32 off), the split's error a layer on one chunk,
    times beside the bound at the split's rate and the FMA pipe's, the plain
    version's, and cuBLAS float32 on the bare products;
29. float32 end to end (``f32_paths``): serving (two full batches over
    HTTP, a ``/v1/reload`` of the same weights, parity with the plain
    float32 chain; one batch with ``concatenation_prod`` and one with a
    one-layer output MLP), evaluation of 64 sequences through K3 and the K9
    sweep (and int8 with dynamic scales), ``predict`` on 64 sequences (bf16
    and int8 backends in float32, the first batch against the plain chain);
    every float32 form launched, no bf16 K1, K2 layer or K7 conv;
30. (run after phase 29) float32 training's kernels alone at the training
    width (``f32_train_*``: 32 sequences x 32,102 labels, H 3072, float32
    tensors): K4 in float32 (``pair_scorer_f32.cu:pair_train_hidden_f32``),
    K4-bwd's dX (with ``da2``, ``dc2``) and dW (``pair_train_bwd_f32.cu``)
    and K5's float32 forward and backward, each against its plain float32
    version (cuBLAS, TF32 off; K5's in column slices, its backward on the
    kernel's statistics) within 1e-5 of the plain tensor's largest |value|
    (dW within its depth's figure, 1.5e-5), the same bits twice; times
    beside the bound (165 TFLOP/s for the products, 3.35 TB/s for K5) and
    the FMA pipe's, the plain version's, cuBLAS float32 on the bare
    products; no bf16 K4, K4-bwd or K5 launched;
31. float32 training (``f32_train``): ``Trainer.train`` with
    ``MIXED_PRECISION False`` at full width for at least 5 steps of 32
    sequences and a validation pass (K7 f32, K1 f32): step ms, seqs/s, peak
    memory, the float32 kernels' launches against the schedule and none of
    the bf16 K4, K4-bwd or K5; two profiled steps (idle share, kernel ms by
    name); one step's gradients and new running statistics against the
    plain float32 chain on a 16-sequence batch, leaf by leaf within 1e-4 of
    the leaf's L2 norm; a PNTPU1 checkpoint written and read back; then 3
    steps with ``GRADIENT_CHECKPOINTING``;
32. (run after phase 31) the streamed and dense scorers' float32 kernels
    alone (``k6_f32_kernels_alone``, ``dense_*_f32``,
    ``dense_f32_first_layer``): K6's ``_f32`` forms on one 32-sequence x
    2,048-label tile, and at 16 sequences x 32,102 labels K5's dense float32
    forms with dropout (the mask and kept values the same bits),
    ``pair_first_add_f32``, ``pair_train_prod_f32``, ``pair_side_sums_f32``
    and ``pair_train_dw_prod_f32``, each against its plain float32 version
    within 1e-5 of its largest |value| (sums over pair rows within their
    depth's figure, dW_prod against float64 on four tiles), times beside
    the bound, the plain version's and the library call's;
33. float32 streamed training (``f32_train_streamed_*``): ``Trainer.train``
    with ``MIXED_PRECISION False`` and ``TRAIN_STREAMING_LABEL_TILE 2048``
    at 32 sequences, the z1 cache by the rule and off: step ms, seqs/s,
    peak memory, idle share, kernel ms by name, launches against
    ``streamed_launches(..., float32)``; one step's loss, gradients and
    running statistics against the decomposed float32 scorer's (1e-4 in L2,
    the heads within twice a measured noise floor);
34. float32 dense training (``f32_train_dense_*``): ``PAIR_BACKEND dense``
    at 16 sequences with dropout 0.1 and BatchNorm, then with dropout,
    ``concatenation_prod``, no BatchNorm and ``GRADIENT_CHECKPOINTING``:
    the same figures against ``dense_launches(..., float32)``; one step at
    8 sequences against the plain float32 dense scorer (the same masks);
35. float32 dense evaluation (``f32_dense_eval``): ``Trainer.evaluate``
    with ``PAIR_BACKEND dense`` on 64 sequences, seqs/s, launches, a
    batch's logits against the plain float32 dense scorer's;
36. (run after phase 35) K7's float32 training kernels alone at full width
    (``k7_f32_train``: 32 sequences at bucket 512, lengths 30-512, one row
    dropped by the example mask): ``masked_conv_dx_f32`` on the 10 block
    convs and K7-BN's float32 forward and backward on the 10 BatchNorms,
    each within 1e-5 of its plain float32 version's largest |value| (the
    BN's backward on the kernel's statistics), ``masked_conv_dw_f32`` (dW,
    dbias) on all 11 against float64 within 1e-5, the float32 pool
    transpose bit for bit, each the same bits twice; times beside the bound
    (67 TFLOP/s for the convs, 3.35 TB/s for the rest), the plain versions'
    and cuDNN's float32 ``conv1d_input`` / ``conv1d_weight`` (TF32 off);
37. float32 encoder training (``f32_encoder_train``): ``Trainer.train``
    with ``MIXED_PRECISION False`` and ``train_sequence_encoder`` for 5
    steps of 32 sequences at bucket 512 (step ms, seqs/s, peak memory,
    launches against 11 forward, 10 dX, 11 dW, 10 + 10 BN and 1 + 1 pool
    kernels a step and no bf16 K7 kernel), two profiled steps (idle share,
    kernel ms by name), the encoder's gradients and running statistics on
    16 sequences against the plain float32 chain (1e-4 in L2 by leaf,
    statistics 1e-5); ``cli/main.py`` training with ``--override
    MIXED_PRECISION False TRAIN_SEQUENCE_ENCODER True``; 3 steps of
    ``ENCODER_BN_TRAIN_MODE`` alone (statistics moved, weights not);
38. (run after phase 17) the tower's float32 kernels alone (``k8_f32``:
    ``csrc/text_attention_f32.cu``'s forward and backward, one kernel at
    128 tokens and two above, the ``_f32`` entries of
    ``csrc/layer_norm.cu``) at phase 13's three shapes against their plain
    float32 versions (cuBLAS with TF32 off): ctx, dq, dk, dv, y, the saved
    statistics, dx, dscale and dbias within 1e-5 of the plain tensor's
    largest |value|, the backward the same bits twice, the float32 counts
    moved as ``backward_launches`` says and the bf16 ones not; times by
    CUDA events beside the bound (attention: the bytes at 3.35 TB/s or its
    products at the 3xTF32 split's 165 TFLOP/s, and beside it at the FMA
    pipe's 67; the LayerNorm's bytes), the plain versions' and float32 SDPA
    with a boolean mask and ``F.layer_norm`` after a float32 add (and their
    backward);
39. the float32 tower (``tower_f32``): E5-large and BioGPT on phase 14's
    random weights, not rounded, against the plain float32 tower on one
    chunk each (pooled rows within 1e-4), then phase 14's 64 chunks through
    ``NativeLabelEncoder.embed_ids`` in float32 (the native label-embedding
    generator's path): descriptions/s, ms a chunk, peak memory, launches, a
    2-chunk profile, and the drift of phase 14's bf16 rows from these
    (the largest and the mean relative L2 distance of a row);
40. float32 tower training (``tower_train_f32``): phase 17's three runs
    with ``MIXED_PRECISION False``'s configuration (the tower, encoder and
    scorer in float32) for 4, 4 and 3 steps: step ms, seqs/s, peak memory,
    idle share of 2 profiled steps, kernel ms by name, the launches (the
    scorer's against ``f32_train_schedule``, no bf16 form), a validation
    pass through the tower, and one step's tower gradients against the
    plain float32 chain within 1e-4 (L2): the tower alone, and the whole
    step with the plain chain's scorer fed the kernels' values (no ReLU
    gate can flip); the whole step with each chain's own values beside its
    noise floor (reported).
Phase 4 also serves two ``POST /v1/reload`` (``cli/serve.py``'s reload:
``Trainer.load``, then ``engine.reload``): first a checkpoint with ``W_l``
doubled (those leaves doubled, the others and nothing else the same, the
latents changed, the probabilities moved by more than 5e-4), then one of
the engine's own weights (every weight and label latent the same bits, the
probabilities within 5e-4).

The serving, evaluation and training paths each assert K7's forward
launches (and none of its training kernels).  Then one JSON line with
every kernel: its launches on its path (K1 and K3
in the training run, whose validation evaluates; K9 in the first sweep
evaluation of 7b; K4, K4-bwd and K5 in training; K2
in the int8 serving and evaluation runs; K8a and K8b in the 64-chunk tower
run; K8a-bwd and K8b-bwd summed over the three tower-training runs, each
K8b-bwd call two kernel launches and each K8a-bwd call at 128 tokens one,
all counted; K7's forward and pool
in the training run, its float32 forward and pool in phase 23's
``test_proteinfer`` run, K1's and K2's float32 forms in phase 29's runs,
K4's, K4-bwd's and K5's float32 forms in phase 31's two runs, K6's float32
forms in phase 33's two runs, the dense scorer's float32 forms summed over
phases 34-35, K7's float32 training kernels in phase 37's
``TRAIN_SEQUENCE_ENCODER`` run, K8a and K8b in float32 in phase 39's
64-chunk run and their backward summed over phase 40's three runs,
its backward and BN kernels in phase 19's
``TRAIN_SEQUENCE_ENCODER`` run, one a wrapper call; K6's in phase 20's
32-sequence streamed run; the dense scorer's kernels summed over phases
25-27's runs; each count set to 0 just
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
                  "streamed_bn", "masked_pool", "masked_conv_f32", "pair_dense", "pair_scorer_f32",
                  "pair_train_bwd_f32", "text_attention_f32")
# first designs that a phase holds a redesigned kernel against
# (csrc/variants/): K9's update, whose histogram must be the same
FIRST_DESIGNS = ("threshold_sweep_v1",)

# H100 SXM dense peaks for the bounds (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32X3_FLOPS = 495e12 / 3  # float32 products as three TF32 products (3xTF32)

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
# a hot reload of the same weights: every weight and label latent the same
# bits, and the served probabilities within two float16 steps of a logit
# through the sigmoid (the engine reads logits back in float16, and K1's
# atomics can move a logit across a float16 rounding point: a step moves a
# probability by at most max |x| sigmoid'(x) 2^-10 ~ 2.2e-4)
RELOAD_PROB_ATOL = 5e-4

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
# the tower in float32 (phases 38-40, MIXED_PRECISION False): each kernel
# within 1e-5 of its plain float32 version's largest |value| (FMA chains and
# float32 sums in other orders); the whole tower's pooled rows within 1e-4
# (such differences pass through 24 layers); training runs of 4, 4 and 3
# steps (E5 LoRA, E5 last 2 layers, BioGPT LoRA), 2 of them profiled, each
# trained leaf's gradient within F32_GRAD_L2_TOL (1e-4, L2) of the plain
# float32 chain's, for the tower alone and for the whole step with the
# scorer fed the same values on both sides (no ReLU gate can flip); the step
# with each chain's own values is reported beside its noise floor (the
# plain chain with the tower's output moved by F32_Z_NOISE)
K8_F32_REL_TOL = 1e-5
TOWER_F32_REL_TOL = 1e-4
TOWER_F32_STEPS = (4, 4, 3)
TOWER_F32_PROFILE_STEPS = 2
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
K7_F32 = ("masked_conv_fwd_f32", "masked_mean_pool_f32")  # eval mode, test_proteinfer's path
# training the encoder in float32 (phases 36-37): the backward kernels and
# the train-mode BatchNorm
K7_F32_TRAIN = ("masked_conv_dx_f32", "masked_conv_dw_f32", "masked_bn_relu_fwd_f32",
                "masked_bn_relu_bwd_f32", "masked_mean_pool_bwd_f32")
KERNEL_FIELDS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
K7_POOLED_REL_TOL = 5e-2
K7_F32_REL_TOL = 1e-5
# the float32 conv kernels' names in ptxas's log: the forward and dX (with
# and without the prologue), dW and dy's split
K7_F32_PTXAS = r"(conv_f32_kernelILb[01]E|conv_dw_f32_kernel|split_rows_kernel)"
# K7 in float32 (phase k7_f32): each conv within 1e-5 of its tensor's largest
# |value| (the same float32 arithmetic, the sums in another order), the pool
# 1e-5, the chain's pooled embedding, where such differences pass through 11
# convs, 1e-4
K7_F32_CHAIN_REL_TOL = 1e-4
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
DENSE_RATE = 0.1  # OUTPUT_MLP_DROPOUT of the dense runs
DENSE_PLAIN_COLS = 256  # the dense K5 forms' plain versions, in column slices
DENSE_OFFSET = 1e3  # the BN check's last column slice sits this many spreads from 0
DENSE_STEPS = 3  # steps of each dense training setting
DENSE_KERNELS = ("pair_first_add", "pair_train_prod", "pair_side_sums", "pair_train_dw_prod",
                 "bn_relu_dropout_forward", "bn_relu_dropout_backward",
                 "bias_relu_dropout_forward", "bias_relu_dropout_backward")


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


def cuda_time_ms(fn, reps: int = 1) -> float:
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


def first_design(name: str):
    """``csrc/variants/<name>.cu`` built with the port's nvcc flags into
    ``_build/`` (once a source and flag set) and loaded: a kernel's first
    design, for a phase that compares the kept kernel with it."""
    import ctypes
    import hashlib

    from protnote_tpu_torch.ops import kernels

    src = kernels.CSRC_DIR / "variants" / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(kernels.NVCC_FLAGS).encode())
    for header in sorted(kernels.CSRC_DIR.glob("*.cuh")):
        tag.update(header.read_bytes())
    out = kernels.BUILD_DIR / f"lib{name}_{tag.hexdigest()[:16]}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I",
                               str(kernels.CSRC_DIR), "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def sweep_first_design():
    """K9's first update (``csrc/variants/threshold_sweep_v1.cu``): its C
    entry point, ``fn(hist, sweep, logits, labels, mask)`` adding one batch
    into ``hist`` with the sorted thresholds of ``sweep`` (a
    ``SweepCounter``) on the current stream."""
    import ctypes

    import torch

    lib = first_design("threshold_sweep_v1")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.threshold_sweep_update.argtypes = [P] * 4 + [I] * 4 + [P, P]

    def update(hist, sweep, logits, labels, mask):
        B, Lb = logits.shape
        err = lib.threshold_sweep_update(logits.data_ptr(), labels.data_ptr(), mask.data_ptr(),
                                         sweep.sorted.data_ptr(), B, Lb, sweep.num_labels,
                                         sweep.sorted.shape[0], hist.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K9's first update: CUDA error {err}")
    return update


def phase_build():
    """One nvcc per source (and per first design a phase compares with),
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from protnote_tpu_torch.ops.kernels import load_kernel_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + len(FIRST_DESIGNS)) as pool:
        firsts = [pool.submit(first_design, name) for name in FIRST_DESIGNS]
        libs = list(pool.map(load_kernel_library, KERNEL_SOURCES))
        for f in firsts:
            f.result()
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


def named_tensors(tree, prefix: str = "") -> dict:
    """{path: tensor} of a nested dict/list tree."""
    import torch

    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in named_tensors(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in named_tensors(sub, f"{prefix}/{i}").items()}
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


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
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from protnote_tpu_torch.cli.serve import make_reload_fn
    from protnote_tpu_torch.core.checkpoint import save_checkpoint
    from protnote_tpu_torch.models.convert import to_jax_tree
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.serving import make_http_server
    from protnote_tpu_torch.train.optim import tree_map
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.cuda.reset_peak_memory_stats()
    placed = tensors_of(engine.ts) + [engine.latents]
    if not all(t.device.type == "cuda" for t in placed):
        raise AssertionError("engine tensors are not all on cuda")
    engine.warmup()
    torch.cuda.synchronize()
    requests = [random_sequences(rng, [300]),
                random_sequences(rng, [50, 200, 511, 700, 1500]),
                random_sequences(rng, [900])]
    # hot reload as cli/serve.py wires it: Trainer.load, then engine.reload;
    # first weights with W_l doubled (the latents and scores must move), then
    # the engine's own (the same bits again)
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "engine.ckpt")
    save_checkpoint(ckpt, to_jax_tree(engine.ts), epoch=0)
    pn = engine.ts["trainable"]["protnote"]
    doubled = dict(engine.ts, trainable=dict(
        engine.ts["trainable"], protnote=dict(pn, W_l=tree_map(lambda t: t * 2, pn["W_l"]))))
    ckpt_doubled = os.path.join(tmp.name, "doubled.ckpt")
    save_checkpoint(ckpt_doubled, to_jax_tree(doubled), epoch=0)
    del pn, doubled
    trainer = Trainer(engine.ts, engine.pi_cfg, engine.pn_cfg, TrainerConfig(), device="cuda")
    server, batcher = make_http_server(engine, port=0, host="127.0.0.1",
                                       reload_fn=make_reload_fn(engine, trainer))
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
        before = engine.score(requests[1])
        old_leaves, old_latents = named_tensors(engine.ts), engine.latents
        doubled_body, _ = post(url + "/v1/reload", {"model_file": ckpt_doubled})
        doubled_err = float(np.abs(engine.score(requests[1]) - before).max())
        new_leaves = named_tensors(engine.ts)
        doubled_moved = not torch.equal(engine.latents, old_latents) and all(
            torch.equal(new_leaves[k], v * 2 if k.startswith("/trainable/protnote/W_l/") else v)
            for k, v in old_leaves.items())
        t0 = time.perf_counter()
        reload_body, _ = post(url + "/v1/reload", {"model_file": ckpt})
        reload_s = time.perf_counter() - t0
        reload_err = float(np.abs(engine.score(requests[1]) - before).max())
        new_leaves = named_tensors(engine.ts)
        same_bits = torch.equal(engine.latents, old_latents) and new_leaves.keys() == \
            old_leaves.keys() and all(torch.equal(new_leaves[k], v) for k, v in old_leaves.items())
        del old_leaves, old_latents, new_leaves
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        tmp.cleanup()
    if thread.is_alive():
        raise AssertionError("HTTP server thread did not stop")
    if health.get("status") != "ok" or health.get("labels") != NUM_LABELS:
        raise AssertionError(f"bad /healthz: {health}")
    if launches <= 0:
        raise AssertionError("the serving path never launched the K1 kernel")
    check_k7_forward(k7_launches, "serving")
    if doubled_body.get("status") != "reloaded" or not doubled_moved or \
            not doubled_err > RELOAD_PROB_ATOL:
        raise AssertionError(f"/v1/reload of weights with W_l doubled did not swap them in: "
                             f"{doubled_body}, leaves and latents moved {doubled_moved}, "
                             f"max |dprob| {doubled_err}")
    if reload_body.get("status") != "reloaded" or not same_bits or \
            not reload_err <= RELOAD_PROB_ATOL:
        raise AssertionError(f"/v1/reload of the same weights changed the model: "
                             f"{reload_body}, same bits {same_bits}, max |dprob| {reload_err}")
    batches = health["batches"] - stats0["batches"]
    n_seqs = sum(len(r) for r in requests)
    log("serving", requests=len(requests), sequences=n_seqs, batches=batches,
        k1_launches=launches, k7_launches=k7_launches, request_ms=latencies,
        reload={"seconds": reload_s, "same_bits": same_bits, "max_abs_prob_err": reload_err,
                "atol": RELOAD_PROB_ATOL, "doubled_W_l_moved": doubled_moved,
                "doubled_W_l_max_abs_prob_change": doubled_err},
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


def k7_eval_calls(params, state, onehot, lengths, cfg, wrapper: str = "masked_conv_cuda"):
    """The eval chain through K7's kernels, recording the arguments of each
    call of the conv ``wrapper`` (``masked_conv_cuda``, or
    ``masked_conv_f32_cuda`` for a float32 chain; positional: those of the
    plain version; keyword: the cached weight layout): ``(calls, the last
    block's output)``."""
    from protnote_tpu_torch.models.proteinfer import proteinfer_embed
    from protnote_tpu_torch.ops import masked_conv as k7

    calls, kernel = [], getattr(k7, wrapper)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return kernel(*args, **kwargs)

    setattr(k7, wrapper, record)
    try:
        proteinfer_embed(params, state, onehot, lengths, cfg)
    finally:
        setattr(k7, wrapper, kernel)
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
            pool_device_ms, pool_host_ms = device_and_host_ms(
                lambda: k7.masked_mean_pool_cuda(feats, lengths), 20)
            flat = feats.contiguous()  # rows 2,200 bytes apart: 8-byte loads
            pool_contiguous_ms = cuda_time_ms(lambda: k7.masked_mean_pool_cuda(flat, lengths), 20)
            pool_err = max(pool_err, rel_max(k7.masked_mean_pool_cuda(flat, lengths),
                                             k7.masked_mean_pool_reference(feats, lengths)),
                           key=lambda e: e[1])
            del flat
            pool_again = k7.masked_mean_pool_cuda(feats, lengths)
            pool_same_bits = torch.equal(k7.masked_mean_pool_cuda(feats, lengths), pool_again)
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
                    "library_ms": None, "device_ms": pool_device_ms,
                    "host_ms": pool_host_ms, "same_bits": pool_same_bits,
                    "pitch": feats.stride(1), "contiguous_input_ms": pool_contiguous_ms}
            pool["device_share_of_bound"] = (None if pool_device_ms is None
                                             else pool["bound_ms"] / pool_device_ms)
            out[bucket] = {"chain_ms": ms, "chain_cached_plans_ms": cached_ms,
                           "chain_plain_ms": plain_ms,
                           "pooled_max_abs_err": pooled_err, "pooled_rel_err": pooled_rel,
                           "chain_bound_ms": bound(ops=flop)["bound_ms"],
                           "padded_bound_ms": bound(ops=flop_padded)["bound_ms"],
                           "valid_rows": valid, "masked_conv_fwd": conv,
                           "masked_mean_pool": pool}
            if pooled_rel > K7_POOLED_REL_TOL or conv["max_rel_err"] > K45_REL_TOL \
                    or pool_err[1] > K7_F32_REL_TOL or not pool_same_bits:
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


def random_f32_encoder(seed: int):
    """The default encoder (1,100 channels x 5 blocks, 32,102-label head) in
    float32 (no compute dtype, as the JAX ``test_proteinfer``), seeded random
    weights and BatchNorm statistics, on the card."""
    import torch

    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu_torch.train.optim import tree_map

    cfg = ProteInferConfig()
    gen = torch.Generator().manual_seed(seed)
    params, state = init_proteinfer(gen, cfg)
    for bp, bs in zip(params["blocks"], state["blocks"]):
        for bn in ("bn1", "bn2"):
            n = bs[bn]["mean"].shape[0]
            bp[bn]["scale"] = 0.5 + torch.rand(n, generator=gen)
            bp[bn]["bias"] = 0.5 * torch.randn(n, generator=gen)
            bs[bn]["mean"] = 0.5 * torch.randn(n, generator=gen)
            bs[bn]["var"] = 0.5 + torch.rand(n, generator=gen)
    return cfg, tree_map(lambda t: t.cuda(), params), tree_map(lambda t: t.cuda(), state)


def random_batch(rng, lens, T: int):
    """(ids (B, T) int64 with the pad id 20 past each length, lengths int32)
    on the card."""
    import numpy as np
    import torch

    aa = rng.integers(0, 20, size=(len(lens), T))
    aa[np.arange(T)[None, :] >= np.asarray(lens)[:, None]] = 20
    return (torch.from_numpy(aa).cuda(),
            torch.from_numpy(np.asarray(lens, np.int32)).cuda())


def phase_k7_f32(card: str) -> dict:
    """K7's float32 forward (``masked_conv_forward_f32``, ``csrc/
    masked_conv_f32.cu``: the bf16x3 split on wgmma, and
    ``masked_mean_pool_f32``) at full width, 32 sequences at bucket 512:
    each of the chain's 11 conv calls (the stem 9 taps x 20 -> 1,100, the
    dilated 9 taps x 1,100 -> 550 at dilations 1, 3, 9, 27, 81 with the eval
    BN prologue, the 1 x 1 550 -> 1,100 with the prologue and the residual)
    and the pool, each against its plain version on the recorded inputs (the
    conv through cuDNN with TF32 off: 1e-5 of the tensor's largest |value|,
    only the order of the float32 sums differs; the pool 1e-5), and the
    chain's pooled embedding against the plain chain's (1e-4); a wide-range
    case (the first dilated conv's input offset by 300, so that every third
    piece of the split carries bits, and its prologue's shift at 40 against
    x * inv of about 0.02), 1e-5 and the same bits twice.  Times by CUDA
    events: each conv shape, the 11 together beside the plain convs and
    cuDNN's float32 conv1d alone (TF32 off; the library time, never called
    by the port), TFLOP/s and share of the bound (the products these lengths
    need over the split's 165 TFLOP/s, and beside it over the FMA pipe's
    67); the pool beside its bytes bound; the kernels' ptxas registers and
    spills."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.models.proteinfer import (
        one_hot_sequences,
        proteinfer_embed,
        proteinfer_embed_reference,
    )
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    cfg, params, state = random_f32_encoder(20)
    T = 512
    lens = k7_lengths(np.random.default_rng(21), T)
    aa, lengths = random_batch(np.random.default_rng(22), lens, T)
    gemm_precision(torch.float32)
    C = cfg.output_channels
    with torch.inference_mode():
        onehot = one_hot_sequences(aa, cfg.input_channels, torch.float32)
        calls, feats = k7_eval_calls(params, state, onehot, lengths, cfg, "masked_conv_f32_cuda")
        shapes = []
        for (name, p, dilation), (args, kw) in zip(k7_convs(params, cfg), calls):
            got = k7.masked_conv_f32_cuda(*args, **kw)
            again = k7.masked_conv_f32_cuda(*args, **kw)
            err, rel = rel_max(got, k7.masked_conv_reference(*args))
            taps, cin, cout = p["kernel"].shape
            flop = 2.0 * cin * cout * conv_rows(lens, T, taps, dilation)
            x = args[0].contiguous().transpose(1, 2)  # (B, C_in, T) for cuDNN
            w = p["kernel"].permute(2, 1, 0).contiguous()
            pad = dilation * (taps - 1) // 2
            ms = cuda_time_ms(lambda: k7.masked_conv_f32_cuda(*args, **kw), 5)
            shapes.append({
                "conv": name, "taps": taps, "dilation": dilation, "cin": cin, "cout": cout,
                "prologue": args[5] is not None, "residual": args[6] is not None,
                "max_abs_err": err, "max_rel_err": rel, "same_bits": torch.equal(got, again),
                "ms": ms, "plain_ms": cuda_time_ms(lambda: k7.masked_conv_reference(*args), 5),
                "library_ms": cuda_time_ms(
                    lambda: F.conv1d(x, w, padding=pad, dilation=dilation), 5),
                **bound(nbytes=4.0 * (x.numel() + w.numel() + B * T * cout), ops=flop,
                        peak=SPLIT_FLOPS),
                "fma_bound_ms": bound(ops=flop, peak=F32_FLOPS)["bound_ms"],
                "tflops": flop / ms / 1e9})
        flop = sum(2.0 * s["cin"] * s["cout"] * conv_rows(lens, T, s["taps"], s["dilation"])
                   for s in shapes)
        conv = {"max_abs_err": max(s["max_abs_err"] for s in shapes),
                "max_rel_err": max(s["max_rel_err"] for s in shapes),
                "ms": cuda_time_ms(lambda: [k7.masked_conv_f32_cuda(*a, **kw)
                                            for a, kw in calls], 3),
                "plain_ms": cuda_time_ms(lambda: [k7.masked_conv_reference(*a)
                                                  for a, _ in calls], 3),
                "library_ms": sum(s["library_ms"] for s in shapes),
                **bound(ops=flop, peak=SPLIT_FLOPS),
                "fma_bound_ms": bound(ops=flop, peak=F32_FLOPS)["bound_ms"], "tflops": None}
        conv["tflops"] = flop / conv["ms"] / 1e9
        conv["share_of_bound"] = conv["bound_ms"] / conv["ms"]
        # the wide-range case on the first dilated conv's recorded call
        args, kw = calls[1]
        gen = torch.Generator(device="cuda").manual_seed(23)
        x_wide = k7.pad_pitch(args[0] + 300.0)
        inv, shift = args[5]
        bn_wide = (0.01 + 0.02 * torch.rand(inv.shape, generator=gen, device="cuda"),
                   39.0 + 2.0 * torch.rand(shift.shape, generator=gen, device="cuda"))
        wide = {}
        for case, a in (("offset", (x_wide, *args[1:5], None, args[6])),
                        ("shift", (*args[:5], bn_wide, args[6]))):
            got = k7.masked_conv_f32_cuda(*a, **kw)
            err, rel = rel_max(got, k7.masked_conv_reference(*a))
            wide[case] = {"max_abs_err": err, "max_rel_err": rel,
                          "same_bits": torch.equal(got, k7.masked_conv_f32_cuda(*a, **kw))}
        del x_wide, got
        pool_got = k7.masked_mean_pool_cuda(feats, lengths)
        pool_err = rel_max(pool_got, k7.masked_mean_pool_reference(feats, lengths))
        valid = int(np.minimum(lens, T).sum())
        pool = {"max_abs_err": pool_err[0], "max_rel_err": pool_err[1],
                "same_bits": torch.equal(pool_got, k7.masked_mean_pool_cuda(feats, lengths)),
                "ms": cuda_time_ms(lambda: k7.masked_mean_pool_cuda(feats, lengths), 20),
                "plain_ms": cuda_time_ms(
                    lambda: k7.masked_mean_pool_reference(feats, lengths), 20),
                **bound(nbytes=4.0 * valid * C + 4.0 * B + 4.0 * B * C), "library_ms": None}
        pool["device_ms"], pool["host_ms"] = device_and_host_ms(
            lambda: k7.masked_mean_pool_cuda(feats, lengths), 20)
        got, _ = proteinfer_embed(params, state, onehot, lengths, cfg)
        want, _ = proteinfer_embed_reference(params, state, onehot, lengths, cfg)
        chain_err = rel_max(got, want)
        chain_ms = cuda_time_ms(lambda: proteinfer_embed(params, state, onehot, lengths, cfg), 3)
        chain_plain_ms = cuda_time_ms(
            lambda: proteinfer_embed_reference(params, state, onehot, lengths, cfg), 3)
    out = {"masked_conv_fwd_f32": conv, "masked_mean_pool_f32": pool}
    log("k7_f32", batch=B, bucket=T, valid_rows=valid, shapes=shapes, **out,
        chain={"ms": chain_ms, "plain_ms": chain_plain_ms, "max_abs_err": chain_err[0],
               "max_rel_err": chain_err[1]}, wide_range=wide,
        rel_tol={"conv": K7_F32_REL_TOL, "pool": K7_F32_REL_TOL, "chain": K7_F32_CHAIN_REL_TOL},
        ptxas=ptxas_by_kernel(load_kernel_library("masked_conv_f32").build_log,
                              K7_F32_PTXAS), card=card)
    bad = [s["conv"] for s in shapes if s["max_rel_err"] > K7_F32_REL_TOL or not s["same_bits"]]
    bad += [f"wide {c}" for c, v in wide.items()
            if v["max_rel_err"] > K7_F32_REL_TOL or not v["same_bits"]]
    if bad or pool_err[1] > K7_F32_REL_TOL or not pool["same_bits"] \
            or chain_err[1] > K7_F32_CHAIN_REL_TOL:
        raise AssertionError(f"K7's float32 forward disagrees with its plain version: convs "
                             f"{bad}, pool {pool_err}, chain {chain_err}")
    return out


def protnote_env(root: str):
    """``PROTNOTE_DATA_DIR`` / ``PROTNOTE_OUTPUT_DIR`` pointed at a temporary
    tree for the CLIs' ``get_setup``, restored on exit."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"PROTNOTE_DATA_DIR": os.path.join(root, "data"),
                                        "PROTNOTE_OUTPUT_DIR": os.path.join(root, "outputs")})


def write_fasta(path: str, n: int, seed: int, labeled: bool):
    """An ``n``-sequence FASTA (lengths 100-1000) over the full vocabulary:
    1-5 GO labels a sequence where ``labeled``, else every other sequence
    unlabeled."""
    import numpy as np

    from protnote_tpu_torch.data.fasta import save_to_fasta

    go_ids = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    rng = np.random.default_rng(seed)
    records = [("".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(k))), f"seq{i}",
                [go_ids[j] for j in rng.choice(NUM_LABELS, int(rng.integers(1, 6)),
                                               replace=False)]
                if labeled or i % 2 else [])
               for i, k in enumerate(rng.integers(100, 1001, size=n))]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_to_fasta(records, path)


def parquet_engine() -> str:
    """The parquet engine pandas would write with (``pyarrow`` or
    ``fastparquet``), or "" when pandas or both are missing: an import
    probe, nothing is written to find out."""
    import importlib.util

    if importlib.util.find_spec("pandas") is None:
        return ""
    return next((m for m in ("pyarrow", "fastparquet") if importlib.util.find_spec(m)), "")


def phase_predict(card: str) -> dict:
    """``cli/predict.py`` at full width: the default config, 32,102 labels x
    2 descriptions in a label-embedding cache file, a 256-sequence FASTA
    (half of it unlabeled) through ``build_predictor`` (the CLI's config,
    dataset, ``build_inference_model`` and batcher) and the scoring
    generator, bf16 (K7 + K1) and ``PAIR_BACKEND tiled_int8`` (K7 + K2,
    scales calibrated on the first batch, timed apart).  Where pandas and a
    parquet engine import, ``predict.main``'s window first: scoring and
    writing the shards (32,102 columns a frame), the CLI's seqs/s, and the
    shards read back.  Then the scoring alone, timed to the last batch's
    read-back, a second pass (warm).  The first batch's
    logits against the plain chain's (``proteinfer_embed_reference`` + the
    plain pair scorer) within K1's 5e-2."""
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.cli import predict
    from protnote_tpu_torch.core.config import (
        generate_label_embedding_path,
        load_config,
        resolve_paths,
    )
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.train.step import batch_to_device_dict

    engine = parquet_engine()
    log("predict_shards", parquet_engine=engine or None,
        shards="written and read back" if engine else "not written: the scores are consumed")
    out = {}
    with tempfile.TemporaryDirectory() as tmp, protnote_env(tmp):
        config = resolve_paths(load_config())
        emb_path = generate_label_embedding_path(
            config["params"], config["paths_resolved"]["GO_BASE_LABEL_EMBEDDING_PATH"])
        _, _, cache = label_cache()
        LabelEmbeddingCache.save(emb_path, cache.embeddings, cache.ids, cache.description_types,
                                 cache.descriptions, cache.token_counts)
        del cache
        fasta = write_fasta(os.path.join(tmp, "query.fasta"), EVAL_SEQUENCES, 31, labeled=False)
        for backend in ("auto", "tiled_int8"):
            out_dir = os.path.join(tmp, f"shards_{backend}")
            args = predict.build_argparser().parse_args(
                ["--fasta", fasta, "--name", f"smoke_{backend}", "--output-dir", out_dir,
                 "--rows-per-shard", "128", "--override", "PAIR_BACKEND", backend])
            t0 = time.perf_counter()
            _, run_name, _, ds, trainer, batcher, label_matrix, vocab = \
                predict.build_predictor(args)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            ps.LAUNCHES = 0
            reset_int8_launches()
            reset_k7_launches()
            t0 = time.perf_counter()
            trainer.ensure_int8_calibrated(batcher)
            torch.cuda.synchronize()
            calibrate_s = time.perf_counter() - t0
            cli_s = None
            if engine:  # predict.main's window: scoring and writing the shards
                t0 = time.perf_counter()
                cli_written = predict.write_shards(
                    predict.score_batches(trainer, batcher, label_matrix), vocab, out_dir,
                    run_name, 128)
                cli_s = time.perf_counter() - t0
            t0 = time.perf_counter()  # the scoring alone
            written = sum(len(ids) for _, ids, _ in
                          predict.score_batches(trainer, batcher, label_matrix))
            sec = time.perf_counter() - t0  # the generator reads every batch back
            if engine and cli_written != written:
                raise AssertionError(f"write_shards wrote {cli_written} rows of {written}")
            launches = {"pair_mlp_layer": ps.LAUNCHES, **ps.INT8_LAUNCHES,
                        **{k: k7.LAUNCHES[k] for k in K7_FORWARD}}
            check_k7_forward(dict(k7.LAUNCHES), f"predict ({backend})")
            scorer = ("pair_int8_layer",) if backend == "tiled_int8" else ("pair_mlp_layer",)
            if written != EVAL_SEQUENCES or any(launches[k] <= 0 for k in scorer):
                raise AssertionError(f"predict ({backend}) scored {written} sequences, "
                                     f"launches {launches}")
            shards = None
            if engine:
                import pandas as pd

                frames = [pd.read_parquet(os.path.join(out_dir, f))
                          for f in sorted(os.listdir(out_dir))]
                shards = [list(f.shape) for f in frames]
                ids = [i for f in frames for i in f.index]
                if sorted(ids) != sorted(ds.sequence_ids) or any(
                        list(f.columns) != vocab or not np.isfinite(f.to_numpy()).all()
                        for f in frames):
                    raise AssertionError(f"predict ({backend}) shards wrong: {shards}")
                del frames
            batch = next(iter(batcher))
            arrays = trainer._place(batch_to_device_dict(batch, trainer.device), label_matrix,
                                    batch)
            latents = trainer._label_latents(arrays)
            got = trainer._eval_step(trainer.ts, trainer._swap_in_latents(arrays, latents))
            want = plain_logits(trainer.ts, trainer.pi_cfg, trainer.pn_cfg, arrays["aa_ids"],
                                arrays["lengths"], latents, plain_encoder=True)
            keep = arrays["example_mask"] > 0
            err = float((got["logits"][keep] - want[keep]).abs().max())
            out[backend] = {"sequences": written, "batches": len(batcher),
                            "cli_seconds": cli_s,
                            "cli_seqs_per_s": written / cli_s if cli_s else None,
                            "scoring_seconds": sec, "scoring_seqs_per_s": written / sec,
                            "scoring_pair_scores_per_s": written * ds.num_labels / sec,
                            "build_seconds": build_s, "calibrate_seconds": calibrate_s,
                            "launches": launches, "shards": shards,
                            "max_abs_logit_err": err, "atol": LOGIT_ATOL,
                            "scales": trainer.pn_cfg.int8_act_scales}
            log("predict", backend=backend, labels=ds.num_labels, **out[backend], card=card)
            if not err <= LOGIT_ATOL:
                raise AssertionError(f"predict ({backend}) logits disagree with the plain "
                                     f"chain: {err}")
            del trainer, batcher, label_matrix, latents, got, want, arrays
            torch.cuda.empty_cache()
    return out


def phase_test_proteinfer(card: str) -> dict:
    """``cli/test_proteinfer.py`` at full width (1,100 channels x 5 blocks,
    a 32,102-label head, float32 as the JAX CLI): ``main`` on a
    256-sequence labelled FASTA (random weights), its K7 launches counted
    (the float32 kernels, none of the bf16 ones) and its seqs/s (the whole
    call: config, weights, batches, host metrics); then the float32 forward
    of a 32-sequence batch at bucket 512 (a per-layer rate) and its head alone (the float32
    ``(32, 1,100) x (1,100, 32,102)`` product, TF32 off) by CUDA events."""
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.cli import test_proteinfer
    from protnote_tpu_torch.core.config import load_config, resolve_paths
    from protnote_tpu_torch.models.layers import linear
    from protnote_tpu_torch.models.proteinfer import (
        one_hot_sequences,
        proteinfer_embed,
        proteinfer_forward,
    )
    from protnote_tpu_torch.ops import masked_conv as k7

    with tempfile.TemporaryDirectory() as tmp, protnote_env(tmp):
        paths = resolve_paths(load_config())["paths_resolved"]
        write_fasta(paths["TEST_DATA_PATH"], EVAL_SEQUENCES, 32, labeled=True)
        reset_k7_launches()
        t0 = time.perf_counter()
        metrics = test_proteinfer.main(["--batch-size", str(B)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(k7.LAUNCHES)
    if any((v > 0) != (k in K7_F32) for k, v in launches.items()):
        raise AssertionError(f"test_proteinfer did not run K7's float32 kernels alone: {launches}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"test_proteinfer metrics not finite: {metrics}")
    cfg, params, state = random_f32_encoder(33)
    lens = k7_lengths(np.random.default_rng(34), 512)
    aa, lengths = random_batch(np.random.default_rng(35), lens, 512)
    with torch.inference_mode():
        onehot = one_hot_sequences(aa, cfg.input_channels)
        batch_ms = cuda_time_ms(lambda: proteinfer_forward(params, state, onehot, lengths, cfg), 3)
        emb, _ = proteinfer_embed(params, state, onehot, lengths, cfg)
        head_ms = cuda_time_ms(lambda: linear(params["output"], emb), 10)
    head_flop = 2.0 * B * cfg.output_channels * cfg.num_labels
    out = {"cli_seconds": cli_s, "sequences": EVAL_SEQUENCES,
           "cli_seqs_per_s": EVAL_SEQUENCES / cli_s, "launches": launches,
           "batch_ms": batch_ms, "forward_seqs_per_s": B / batch_ms * 1e3, "head_ms": head_ms,
           **{f"head_{k}": v for k, v in bound(
               nbytes=4.0 * (emb.numel() + params["output"]["kernel"].numel()
                             + B * cfg.num_labels), ops=head_flop, peak=F32_FLOPS).items()},
           "map_micro": metrics.get("map_micro"), "map_macro": metrics.get("map_macro")}
    log("test_proteinfer", batch=B, bucket=512, labels=cfg.num_labels, **out, card=card)
    return out


def plain_logits(ts, pi_cfg, cfg, aa, lengths, latents, plain_encoder: bool = False):
    """(B, labels) ensembled float32 logits of the ids ``aa`` through a
    forward with the plain pair scorer (bf16 or int8, as ``cfg``'s backend)
    on ``latents``; the encoder through K7's kernels, or with
    ``plain_encoder`` through its plain chain (``proteinfer_embed_reference``)."""
    import torch

    from protnote_tpu_torch.models.fusion import ensemble_logits, projection_head_apply
    from protnote_tpu_torch.models.proteinfer import (
        embed_from_ids,
        one_hot_sequences,
        proteinfer_embed_reference,
    )
    from protnote_tpu_torch.ops import pair_scorer as ps

    pn, state = ts["trainable"]["protnote"], ts["model_state"]
    with torch.inference_mode():
        if plain_encoder:
            P_f, _ = proteinfer_embed_reference(
                ts["enc_params"], ts["enc_state"],
                one_hot_sequences(aa, pi_cfg.input_channels, pi_cfg.runtime_dtype), lengths,
                pi_cfg)
        else:
            P_f, _ = embed_from_ids(ts["enc_params"], ts["enc_state"], aa, lengths, pi_cfg)
        P_e, _ = projection_head_apply(pn["W_p"], state["W_p"], P_f.to(cfg.compute_dtype))
        folded = ps.fold_output_mlp(pn["output_mlp"], state["output_mlp"], cfg.feature_fusion,
                                    cfg.latent_dim, dtype=cfg.compute_dtype)
        if cfg.pair_backend == "tiled_int8":
            logits = ps.pair_logits_tiled_int8_reference(
                ps.quantize_folded(folded, act_scales=cfg.int8_act_scales), P_e,
                latents, cfg.label_tile, cfg.compute_dtype)
        else:
            logits = ps.pair_logits_tiled_reference(folded, P_e, latents,
                                                    cfg.label_tile, cfg.compute_dtype)
        return ensemble_logits(logits, cfg.inference_descriptions_per_label).float()


def plain_probs(engine, seqs, latents=None):
    """(n, labels) probabilities of ``seqs`` through a forward with the plain
    pair scorer (bf16 or int8, as the engine's backend) on the engine's
    device tensors (or on ``latents`` in place of the engine's)."""
    import torch

    aa, lengths = engine._assemble(engine._encode(seqs), 512)
    logits = plain_logits(engine.ts, engine.pi_cfg, engine.pn_cfg, torch.from_numpy(aa).cuda(),
                          torch.from_numpy(lengths).cuda(),
                          engine.latents if latents is None else latents)
    return torch.sigmoid(logits[: len(seqs)]).cpu().numpy()


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
        codes = k2_codes(qs["static"], P_e, L_e, card)
        rs = k2_row_scale(qs["dynamic"], P_e, L_e, card)
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


# K2's kernels by name, and the pass each belongs to (k2_parts' device time)
K2_KERNEL_PASSES = {"pair_int8_first_codes_kernel<false": "codes",
                    "pair_int8_first_scale_kernel": "row_scale_first",
                    "pair_int8_first_codes_kernel<true": "row_scale_first",
                    "pair_int8_later_kernel": "row_scale_later",
                    "pair_int8_layer_kernel": "layer"}


def k2_parts(qs, P_e, L_e):
    """K2 in parts at full width: each launch of one full chunk alone, from
    CUDA events (static: the code pass, the GEMM with the code epilogue,
    the GEMM with the dot; dynamic: the row-scale pass from a and c and
    from bf16 rows, the GEMM with the bf16 epilogue, the GEMM with the
    dot), each also scaled to the batch's chunks (the dynamic layer 1 on
    the second chunk; the first chunk's launch also makes every chunk's
    layer-1 scales: ``dynamic_first_scales``, that launch, and once a batch
    its excess over the second chunk's); and one profiled call of each
    mode."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    launches = {}
    for mode, q in qs.items():
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
        ch = k.plan.chunks[0]
        logits = k.new_logits()
        with torch.cuda.device(P_e.device):
            if mode == "dynamic":
                launches["dynamic_first_scales"] = cuda_time_ms(lambda: k.quantize(ch, 0), 20)
            for i in range(2):
                qc = k.plan.chunks[1] if mode == "dynamic" and i == 0 else ch
                k.quantize(qc, i if mode == "dynamic" else 0)
                launches[f"{mode}_{'row_scale' if mode == 'dynamic' else 'codes'}_{i}"] = \
                    cuda_time_ms(lambda: k.quantize(qc, i if mode == "dynamic" else 0), 20)
                launches[f"{mode}_layer_{i}"] = cuda_time_ms(lambda: k.layer(ch, i, logits), 20)
        chunk_rows = B * ch.nl_pad
        del k, logits
    launches.pop("static_codes_1")  # the code pass runs for layer 1 only
    batch = {name: ms * B * L_e.shape[0] / chunk_rows for name, ms in launches.items()}
    batch["dynamic_first_scales"] = (launches["dynamic_first_scales"]
                                     - launches["dynamic_row_scale_0"])
    layer_tops = {name: 2.0 * chunk_rows * H * H / ms / 1e9
                  for name, ms in launches.items() if "layer" in name}
    # one profiled call of each mode: device busy time against the wall, and
    # by kernel (the launches above are timed back to back from the host);
    # the device time a batch of each code pass and of the GEMM's launches
    profile, passes = {}, {}
    for mode, q in qs.items():
        wall, busy, top = device_profile(lambda: ps.pair_logits_tiled_int8_cuda(q, P_e, L_e), 1)
        profile[mode] = {"wall_ms": wall * 1e3,
                         "device_busy_ms": None if busy is None else busy * 1e3,
                         "top_kernels_ms": top}
        for name, ms in top:
            part = next((v for k, v in K2_KERNEL_PASSES.items() if k in name), None)
            if part:
                key = f"{mode}_{part}"
                passes[key] = passes.get(key, 0.0) + ms
    return {"variants": k2_variants(), "chunk_rows": chunk_rows, "launch_ms": launches,
            "batch_ms": batch, "layer_tops": layer_tops, "device_ms_a_batch": passes,
            "profile": profile}


def pass_times(fn, launches: int) -> dict:
    """A pass of ``launches`` launches: CUDA events and device time
    (``torch.profiler`` busy time) a pass, the host's time a launch."""
    device, host = device_and_host_ms(fn, 2)
    return {"ms": cuda_time_ms(fn, 3), "device_ms": device, "host_ms_a_launch": host / launches}


def k2_codes(q, P_e, L_e, card: str):
    """Layer 1's static code pass alone: against ``int8_codes_reference``
    on the first and the ragged last chunk of the plan, element by element,
    and the time of its launches over a batch's chunks (events, device time,
    the host's time a launch)."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
    s0 = q.act_scales[0]
    differ, err = 0, 0
    with torch.cuda.device(P_e.device):
        for ch in (k.plan.chunks[0], k.plan.chunks[-1]):
            k.codes[0].fill_(99)
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

        times = pass_times(kernel_pass, len(k.plan.chunks))
        plain_ms = cuda_time_ms(plain_pass, 1)
    # bytes the function needs: a and c read once, one code a pair element
    L_rows = L_e.shape[0]
    nbytes = 4.0 * (B + L_rows) * H + 1.0 * B * L_rows * H
    log("k2_codes_check", chunks=2, codes_differ=differ, max_abs_err=err,
        launches=len(k.plan.chunks), **times, plain_ms=plain_ms, **bound(nbytes=nbytes), card=card)
    if differ or err:
        raise AssertionError(f"the code pass disagrees with its plain version: {differ} codes, "
                             f"largest difference {err}")
    return {"max_abs_err": float(err), "ms": times["ms"], "plain_ms": plain_ms,
            **bound(nbytes=nbytes), "library_ms": None}


def k2_row_scale(q, P_e, L_e, card: str):
    """The row-scale pass alone: its scales and codes against
    ``int8_row_scale_reference`` on the first and the ragged last chunk
    (layer 1 from a and c, layer 2 from the kernel's bf16 carry), and the
    time of its 2 x chunks launches of a batch; then each form apart (events,
    device time, the host's time a launch), each beside its own bytes
    bound."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
    err, differ = 0.0, 0
    with torch.cuda.device(P_e.device):
        for ch in (k.plan.chunks[0], k.plan.chunks[-1]):
            rows = B * ch.nl_pad
            for i in range(2):
                k.codes[0].fill_(99)
                k.quantize(ch, i)
                x = ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16) if i == 0 else k.h[:rows]
                want_s, want = ps.int8_row_scale_reference(x)
                err = max(err, float((k.scales_of(ch, i) - want_s).abs().max()))
                differ += int((k.codes[0][:rows] != want).sum())
                if i == 0:
                    k.layer(ch, 0, None)  # the bf16 carry layer 2 reads

        def kernel_pass(forms=(0, 1)):
            for ch in k.plan.chunks:
                for i in forms:
                    k.quantize(ch, i)

        def plain_pass():
            for ch in k.plan.chunks:
                ps.int8_row_scale_reference(ps._chunk_inputs(k.a, k.c, ch).to(torch.bfloat16))
                ps.int8_row_scale_reference(k.h[:B * ch.nl_pad])

        n = len(k.plan.chunks)
        times = pass_times(kernel_pass, 2 * n)
        forms = {form: pass_times(lambda: kernel_pass((i,)), n)
                 for i, form in enumerate(("first", "later"))}
        plain_ms = cuda_time_ms(plain_pass, 1)
    # bytes the function needs: a and c (layer 1) and the bf16 carry (layer
    # 2) read once, one code a pair element and one float32 scale a row out
    # per layer
    L_rows = L_e.shape[0]
    rows = B * L_rows
    out_bytes = 1.0 * rows * H + 4.0 * rows
    form_bytes = {"first": 4.0 * (B + L_rows) * H + out_bytes, "later": 2.0 * rows * H + out_bytes}
    for form, t in forms.items():
        t.update(bound(nbytes=form_bytes[form]))
    nbytes = sum(form_bytes.values())
    log("k2_row_scale_check", chunks=2, max_abs_err=err, codes_differ=differ, launches=2 * n,
        **times, plain_ms=plain_ms, **bound(nbytes=nbytes), forms=forms, card=card)
    if err != 0.0 or differ:
        raise AssertionError(f"the row-scale pass disagrees with its plain version: scales "
                             f"{err}, {differ} codes")
    return {"max_abs_err": err, "ms": times["ms"], "plain_ms": plain_ms, **bound(nbytes=nbytes),
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
        if dev_ms is None:  # a trace that caught no device event: once more
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


def sweep_keys(sweep, logits, labels, mask) -> dict:
    """How the update's adds fall on one batch: its valid elements, the
    distinct (slot, column) keys among them (the L2 reductions of the kept
    update, which counts a block's rows in shared memory first) and the
    share of elements whose key repeats within the batch (the first
    design's adds that queue on an address another element of the batch
    also adds to).  Slots as the kernel forms them, from torch's sigmoid
    (an element within an ulp of a threshold may move)."""
    import torch

    L, T = sweep.num_labels, sweep.sorted.shape[0]
    x = logits[:, :L].float()
    p = 1.0 / (1.0 + torch.exp(-x))
    k = torch.searchsorted(sweep.sorted, p.contiguous(), right=True)
    k = torch.where(torch.isnan(p), torch.zeros_like(k), k)
    slot = torch.where(labels[:, :L] > 0, 0, T + 1) + k
    valid = (mask[:, None] > 0).expand_as(slot)
    cols = torch.arange(L, device=slot.device).expand_as(slot)
    keys = (slot * L + cols)[valid]
    n, distinct = int(keys.numel()), int(torch.unique(keys).numel())
    return {"valid_elements": n, "distinct_keys": distinct,
            "repeat_share": 1.0 - distinct / max(n, 1),
            "slot0_neg_share": float(((slot == T + 1) & valid).sum()) / max(n, 1)}


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
    first_update = sweep_first_design()
    checks = {}
    for name, thresholds in (("cli_99", sweep_thresholds()),
                             ("unsorted", np.array(ODD_THRESHOLDS, np.float32))):
        sweep = k9.SweepCounter(thresholds, NUM_LABELS, dev)
        T = len(thresholds)
        plain = tuple(torch.zeros(T, NUM_LABELS, dtype=torch.int32, device=dev)
                      for _ in range(3))
        first_hist = torch.zeros_like(sweep.hist)
        edges = 0
        for i, (logits, labels, mask) in enumerate(batches):
            sweep.update(logits, labels, mask)
            first_update(first_hist, sweep, logits, labels, mask)
            if i % 2:  # the ring flushed after two batches' codes
                sweep.flush()
                if not torch.equal(sweep.hist, first_hist):
                    raise AssertionError(f"K9 ({name}): the update's histogram differs from "
                                         f"the first design's after batch {i}")
            k9.count_reference(plain, logits, labels, mask, sweep.thresholds)
            valid = (mask[:, None] > 0).expand(B, NUM_LABELS)
            edges += sweep_edges(logits[:, :NUM_LABELS], valid, thresholds)
        got = sweep.counts()
        torch.cuda.synchronize()
        delta = sum(int((g.long() - w.long()).abs().sum()) for g, w in zip(got, plain))
        checks[name] = {"edge_pairs": edges, "count_delta": delta,
                        "tp": int(got[0].sum()), "fn": int(got[2].sum()),
                        "same_histogram_as_first_design": True}
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
    ring = k9.RING_ROWS // B  # the batches a flush counts

    def cycle():  # a ring's batches and their flush: the update's cost a batch x ring
        for _ in range(ring):
            sweep.update(logits, labels, mask)
        sweep.flush()

    # the flush alone on a full ring (adding the same rows again), against
    # the plain flush on the same codes
    for _ in range(ring):
        sweep.update(logits, labels, mask)
    rows, codes = sweep.pending, sweep.codes

    def flush_again():
        k9._flush(codes.data_ptr(), rows, NUM_LABELS, sweep.pitch, T, sweep.hist.data_ptr(),
                  sweep.index)

    before = sweep.hist.clone()
    flush_again()
    if not torch.equal(sweep.hist, k9.flush_reference(before, codes[:rows], NUM_LABELS)):
        raise AssertionError("K9's flush differs from the plain flush on the same codes")
    plain = tuple(torch.zeros(T, NUM_LABELS, dtype=torch.int32, device=dev) for _ in range(3))
    t = {"update": (cuda_time_ms(cycle, 10) / ring,
                    cuda_time_ms(lambda: k9.count_reference(
                        plain, logits, labels, mask, sweep.thresholds), 3)),
         "flush": (cuda_time_ms(flush_again, 20),
                   cuda_time_ms(lambda: k9.flush_reference(before, codes[:rows], NUM_LABELS),
                                5)),
         "finalize": (cuda_time_ms(sweep.counts, 20),
                      cuda_time_ms(lambda: k9.finalize_reference(
                          sweep.hist, sweep.order, NUM_LABELS, T), 5))}
    first_hist = torch.zeros_like(sweep.hist)
    first_ms = cuda_time_ms(lambda: first_update(first_hist, sweep, logits, labels, mask), 50)
    device = device_split({"update_ring_cycle": cycle, "flush": flush_again,
                           "update_first_design": lambda: first_update(
                               first_hist, sweep, logits, labels, mask),
                           "finalize": sweep.counts}, reps=10)
    device["update"] = {k: None if v is None else (v / ring if k != "kernels" else v)
                        for k, v in device["update_ring_cycle"].items()}
    n_valid = float(mask.sum()) * NUM_LABELS
    state = 4.0 * 2 * (T + 1) * NUM_LABELS
    keys = sweep_keys(sweep, logits, labels, mask)
    nbytes = {"update": 8.0 * B * K9_WIDTH + 4 * B + 4 * T + 8 * n_valid,
              # the ring's codes read once, each distinct (slot, column) key
              # of its rows (those of the one batch, repeated) read and written
              "flush": 2.0 * rows * NUM_LABELS + 8.0 * keys["distinct_keys"],
              "finalize": state + 4 * T + 3 * 4.0 * T * NUM_LABELS}
    xla_bytes = T * 8.0 * B * K9_WIDTH  # lax.map: the batch read once a threshold
    log("k9_time", **{f"{k}_ms": v[0] for k, v in t.items()}, update_first_design_ms=first_ms,
        update_keys=keys, ring_batches=ring, update_device_share_of_bound=(
            None if device["update"]["device_ms"] is None
            else bound(nbytes=nbytes["update"])["bound_ms"] / device["update"]["device_ms"]),
        **{f"{k}_plain_ms": v[1] for k, v in t.items()},
        **{f"{k}_bound_ms": bound(nbytes=nbytes[k])["bound_ms"] for k in t},
        xla_form_bytes=xla_bytes, xla_form_bound_ms=bound(nbytes=xla_bytes)["bound_ms"],
        state_mb=state / 1e6, device=device, card=card)
    errs = {k: float(max(v["count_delta"] for v in checks.values())) for k in t}
    errs["flush"] = 0.0  # equal to the plain flush above
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
    from protnote_tpu_torch.data.dataset import ProteinDataset
    from protnote_tpu_torch.data.vocab import COMMON_AMINOACIDS

    go_ids, _, cache = label_cache()
    path = write_fasta(os.path.join(tmp, name), n, seed, labeled=True)
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
    Then K9's update alone on the first batch of logits that evaluation
    gave it (the model on random weights): the kept update and the first
    design, their histograms equal, their device times, and how the batch's
    adds fall (:func:`sweep_keys`).  Returns K9's launches in the first
    sweep pass (set to 0 just before)."""
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
    runs, launches, chosen, seen = [], None, None, []
    update = k9.SweepCounter.update

    def keep_first(counter, logits, labels, mask):  # the first batch the sweep counts
        if not seen:
            seen.append((logits.clone(), labels.clone(), mask.clone(), counter.num_labels))
        return update(counter, logits, labels, mask)

    k9.SweepCounter.update = keep_first
    try:
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
    finally:
        k9.SweepCounter.update = update
    if any(v <= 0 for v in launches.values()) or not np.isfinite(chosen[1]):
        raise AssertionError(f"the sweep evaluation skipped a kernel: {launches}, {chosen}")
    logits, labels, mask, num_labels = seen[0]
    counter = k9.SweepCounter(sweep_thresholds(), num_labels, "cuda")
    first_update, first_hist = sweep_first_design(), torch.zeros_like(counter.hist)
    counter.update(logits, labels, mask)
    counter.flush()
    first_update(first_hist, counter, logits, labels, mask)
    if not torch.equal(counter.hist, first_hist):
        raise AssertionError("K9 on the evaluation's logits: the update's histogram differs "
                             "from the first design's")
    n_valid = float((mask > 0).sum()) * num_labels
    nbytes = 8.0 * logits.numel() + 4 * logits.shape[0] + 4 * 99 + 8 * n_valid
    ring = k9.RING_ROWS // logits.shape[0]

    def cycle():  # a ring's batches and their flush
        for _ in range(ring):
            counter.update(logits, labels, mask)
        counter.flush()

    device = device_split({"update_ring_cycle": cycle,
                           "update_first_design": lambda: first_update(
                               first_hist, counter, logits, labels, mask)}, reps=10)
    device["update"] = {k: None if v is None else (v / ring if k != "kernels" else v)
                        for k, v in device["update_ring_cycle"].items()}
    log("k9_eval_logits", shape=list(logits.shape), keys=sweep_keys(counter, logits, labels, mask),
        logit_quantiles=[float(q) for q in torch.quantile(
            logits[mask > 0].float().flatten()[:1 << 24],
            torch.tensor([0.01, 0.5, 0.99], device=logits.device))],
        same_histogram_as_first_design=True,
        ring_batches=ring, update_ms=cuda_time_ms(cycle, 10) / ring,
        update_first_design_ms=cuda_time_ms(
            lambda: first_update(first_hist, counter, logits, labels, mask), 50),
        **bound(nbytes=nbytes), device=device, card=card)
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
    ``K45_REL_TOL`` of the plain tensor's largest |value|, and the same bits
    from a second call.  Each kernel timed alone on its plan (with the f32
    scratch it allocates and its second, summing kernel), also at 32 x 8,192
    (label subsets) and 32 x 2,048 (the streamed tile); the plain version's
    two halves (dX: x1 formed again, the gate, the product, the sums; dW: x1
    formed again and the product), and as a yardstick cuBLAS on the two bare
    products over a materialised x1 (not the same function: x1, the gate and
    dx1 in device memory, formed outside the timing); the bytes each
    kernel's stages bring into shared memory for a kFLOP; ptxas figures and
    shared memory of each compiled kernel."""
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
        again = st._pair_hidden_backward_cuda(a2, c2, W, dz)
        torch.cuda.synchronize()
        same_bits = {k: bool(torch.equal(x, y)) for k, x, y in zip(("da2", "dc2", "dw"), got,
                                                                    again)}
        del again
        want = st._pair_hidden_backward_plain(a2, c2, W, dz)
        outs = {"da2": delta(got[0], want[0]), "dc2": delta(got[1], want[1]),
                "dw": delta(got[2], want[2])}
        del got, want
        torch.cuda.empty_cache()
        B_, L_, K_, N_ = TRAIN_B, NUM_LABELS, H, H
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream

        def calls(c2_, dz_):
            dxp = st.pair_dx_plan(B_, c2_.shape[0], K_, N_, sms)
            dwp = st.pair_dw_plan(B_, c2_.shape[0], K_, N_, sms)
            return (dxp, dwp, lambda: st._pair_dx_cuda(a2, c2_, W, dz_, dxp, stream),
                    lambda: st._pair_dw_cuda(a2, c2_, dz_, dwp, stream))

        dxp, dwp, dx_call, dw_call = calls(c2, dz)

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
        by_shape = {}
        for labels in (8192, 2048):  # label subsets; the streamed tile
            dz_l = dz.view(B_, L_, N_)[:, :labels].reshape(B_ * labels, N_)
            _, _, dx_l, dw_l = calls(c2[:labels], dz_l)
            by_shape[f"{B_}x{labels}"] = {"pair_train_dx": cuda_time_ms(dx_l, 5),
                                          "pair_train_dw": cuda_time_ms(dw_l, 5)}
            del dz_l
            torch.cuda.empty_cache()
    lib = load_kernel_library("pair_train_bwd")
    smem = lib.lib.pair_train_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    variants = [{"kernel": name, "block_n": int(bn or 256), "ptxas": ptxas, "spills": spills,
                 "smem_bytes": smem(0 if name == "dx" else 1, int(bn or 256))}
                for (name, bn), ptxas, spills in ptxas_by_kernel(
                    lib.build_log, r"pair_train_(dx|dw)_kernel(?:ILi(\d+)E)?")]
    N = float(B_ * L_)
    ops = 2.0 * N * K_ * N_
    side = 2.0 * (a2.numel() + c2.numel() + W.numel())
    bounds = {"pair_train_dx": bound(nbytes=2.0 * N * N_ + side + 2.0 * (a2.numel() + c2.numel()),
                                     ops=ops),
              "pair_train_dw": bound(nbytes=2.0 * N * N_ + side, ops=ops)}
    rel = {k: v[0] / v[1] for k, v in outs.items()}
    pair_bound = bounds["pair_train_dx"]["bound_ms"] + bounds["pair_train_dw"]["bound_ms"]
    log("k4_bwd", batch=TRAIN_B, rows=int(N), width=H, rel_errs=rel, rel_tol=K45_REL_TOL,
        max_abs_errs={k: v[0] for k, v in outs.items()}, same_bits=same_bits,
        **{f"{k}_ms": v[0] for k, v in times.items()},
        **{f"{k}_plain_ms": v[1] for k, v in times.items()},
        **{f"{k}_tflops": ops / v[0] / 1e9 for k, v in times.items()},
        **{f"{k}_bound_share": bounds[k]["bound_ms"] / v[0] for k, v in times.items()},
        pair_ms=pair_ms, plain_pair_ms=plain_pair_ms, pair_bound_ms=pair_bound,
        pair_bound_share=pair_bound / pair_ms, pair_tflops=2 * ops / pair_ms / 1e9,
        cublas_yardstick_ms=gemm, ms_by_shape=by_shape,
        smem_bytes_per_kflop={"pair_train_dx": dxp.smem_bytes_per_kflop,
                              "pair_train_dw": dwp.smem_bytes_per_kflop},
        dx_plan={"ranges": dxp.ranges, "groups": dxp.groups, "grid": dxp.grid},
        dw_plan={"full": dwp.full, "pieces": dwp.pieces, "items": dwp.items, "grid": dwp.grid},
        variants=variants, card=card)
    if max(rel.values()) > K45_REL_TOL:
        raise AssertionError(f"K4-bwd disagrees with the plain backward: {outs}")
    if not all(same_bits.values()):
        raise AssertionError(f"K4-bwd gave other bits on a second call: {same_bits}")
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


def device_profile(fn, steps: int, keep=()):
    """Run ``fn`` ``steps`` times under ``torch.profiler``: (wall s, device
    busy s, top kernels by device time, ms a step), busy time the union of
    the kernels' intervals, and after the top ones every other kernel whose
    name holds a string of ``keep``; (wall, None, []) when the trace holds
    no device events."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = ranked[:14] + [kv for kv in ranked[14:] if any(k in kv[0] for k in keep)]
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


def k8b_ptxas(f32: bool = False) -> dict:
    """K8b's ptxas registers and spills at the tower's width (H 1024, four
    chunks of 8 elements a lane), with and without the residual, for bf16
    elements (or float32)."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    elem = "f" if f32 else "13__nv_bfloat16"
    return {"residual" if residual == "1" else "no_residual": {"ptxas": ptxas, "spills": spills}
            for (chunks, residual), ptxas, spills in ptxas_by_kernel(
                load_kernel_library("layer_norm").build_log,
                rf"add_layer_norm_kernelI{elem}Li(\d+)ELb([01])E") if chunks == "4"}


def tower_chunks():
    """The tower phases' token ids (phases 14 and 39), from one seeded
    generator in this order: one chunk of shape (a) for E5-large and one
    for BioGPT, then TOWER_CHUNKS chunks of (a) for E5-large with one
    all-masked filler row, in the last chunk."""
    import torch

    from protnote_tpu_torch.models.text_transformer import TextEncoderConfig

    gen = torch.Generator().manual_seed(32)
    _, Ba, Ta, lo, hi, _ = K8_SHAPES[0]
    e5, gpt = TextEncoderConfig.e5_large(), TextEncoderConfig.biogpt()
    one = {arch: token_batch(gen, Ba, Ta, lo, hi, cfg.vocab_size, cfg.pad_token_id)
           for arch, cfg in (("e5_large", e5), ("biogpt", gpt))}
    chunks = [token_batch(gen, Ba, Ta, lo, hi, e5.vocab_size, e5.pad_token_id,
                          filler=i == TOWER_CHUNKS - 1) for i in range(TOWER_CHUNKS)]
    return one, chunks


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
    _, Ba, Ta, lo, hi, _ = K8_SHAPES[0]
    one_chunk, chunks = tower_chunks()
    whole = {}
    for arch, cfg, seed in (("e5_large", TextEncoderConfig.e5_large(dtype=bf16), 33),
                            ("biogpt", TextEncoderConfig.biogpt(dtype=bf16), 34)):
        t0 = time.perf_counter()
        params = random_tower(cfg, seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ids, mask = one_chunk[arch]
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


def phase_tower_training(card: str, f32: bool = False):
    """Training the label tower at full width through ``Trainer.train``:
    E5-large with LoRA and with the last two layers unfrozen, BioGPT with
    LoRA (K8a-bwd causal); per run the steps' times, rates, peak memory, a
    profiled idle share, the kernels' launches and a validation pass through
    the tower; one step's gradients through the kernels against the plain
    chain.  Returns the backward kernels' launches over the three runs.
    ``f32`` (phase 40): ``MIXED_PRECISION False``'s configuration, the
    tower and the scorer in float32 (``f32_models``), fewer steps, the
    float32 kernels' counts (and none of the bf16 forms) and
    ``tower_grad_check_f32``."""
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
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.ops import text_attention as k8a
    from protnote_tpu_torch.train import step as step_mod
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves, tree_map
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev, dtype = torch.device("cuda"), torch.float32 if f32 else torch.bfloat16
    buckets = (256, 512, 1024)
    sfx = "_f32" if f32 else ""
    totals = {f"text_attention_bwd{sfx}": 0, f"add_layer_norm_bwd{sfx}": 0}
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = train_datasets(tmp)
        weights = train_ds.calculate_sequence_weights(
            train_ds.calculate_label_weights(power=0.5), "sum")
        pi_cfg, pn_cfg, ts = f32_models() if f32 else random_models()
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
            k8a.F32_LAUNCHES = k8a.F32_BWD_LAUNCHES = k8b.F32_LAUNCHES = k8b.F32_BWD_LAUNCHES = 0
            for counts in (st.LAUNCHES, ps.F32_LAUNCHES):
                for k in counts:
                    counts[k] = 0
            ps.LAUNCHES = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = trainer.train(FirstBatches(train_batcher(), steps_n), val_batcher())
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            tower = {"text_attention": k8a.LAUNCHES, "text_attention_bwd": k8a.BWD_LAUNCHES,
                     "add_layer_norm": k8b.LAUNCHES, "add_layer_norm_bwd": k8b.BWD_LAUNCHES}
            if f32:  # the float32 forms, and none of the bf16 ones
                bf16_forms = {**tower, "pair_mlp_layer": ps.LAUNCHES, **decomposed_launches()}
                launches = {"text_attention_f32": k8a.F32_LAUNCHES,
                            "text_attention_bwd_f32": k8a.F32_BWD_LAUNCHES,
                            "add_layer_norm_f32": k8b.F32_LAUNCHES,
                            "add_layer_norm_bwd_f32": k8b.F32_BWD_LAUNCHES,
                            "pair_mlp_layer_f32": ps.F32_LAUNCHES["pair_mlp_layer_f32"],
                            **{k: v for k, v in st.LAUNCHES.items() if v}}
                schedule = f32_train_schedule(steps_n, False)
                wrong = any(bf16_forms.values()) or \
                    any(launches.get(k) != v for k, v in schedule.items())
            else:
                launches = {**tower, **decomposed_launches()}
                bf16_forms, schedule, wrong = {}, {}, False
            peak = torch.cuda.max_memory_allocated() / 2**30
            trainer._train_step = step_fn
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            descs = statistics.median([x[3] for x in steps])
            hist = summary["history"][0]
            if len(steps) != steps_n or not all(math.isfinite(x) for x in losses) or \
                    any(v <= 0 for v in launches.values()) or wrong or \
                    not math.isfinite(hist.get("val_map_micro", float("nan"))):
                raise AssertionError(f"tower training {name}: losses {losses}, launches "
                                     f"{launches} (schedule {schedule}, bf16 {bf16_forms}), "
                                     f"history {hist}")
            for k in totals:
                totals[k] += launches[k]

            # three profiled steps, and one step's gradients against the plain chain
            inner = train_batcher()
            inner.set_epoch(1)
            batches = []
            for batch in inner:
                batches.append(batch)
                if len(batches) == (TOWER_F32_PROFILE_STEPS if f32 else PROFILE_STEPS):
                    break
            matrix = trainer._label_matrix_for(train_ds)
            placed = [trainer._place(batch_to_device_dict(b, dev), matrix, b) for b in batches]
            g_prof = torch.Generator(device=dev).manual_seed(1)
            it = iter(placed)

            def one_step():
                trainer.ts, _ = step_fn(trainer.ts, next(it), g_prof)

            wall, busy, top = device_profile(one_step, len(placed))
            check = tower_grad_check_f32 if f32 else tower_grad_check
            grads = check(trainer, placed[0], cfg, lora, step_mod, text_encoder_forward_reference)
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
            log(f"tower_train{sfx}", run=name, **fields, card=card)
            del trainer, ts0, text, adapters, placed, batches
            torch.cuda.empty_cache()

        steps_of = TOWER_F32_STEPS if f32 else (9, 9, 3)
        run("e5_large_lora", TextEncoderConfig.e5_large(dtype=dtype), 42, True, steps_of[0])
        run("e5_large_last2", TextEncoderConfig.e5_large(dtype=dtype), 43, False, steps_of[1])
        run("biogpt_lora", TextEncoderConfig.biogpt(dtype=dtype), 44, True, steps_of[2])
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


def tower_grad_check_f32(trainer, batch, cfg, lora: bool, step_mod, plain_forward) -> dict:
    """One float32 step's tower gradients on the run's weights and one batch
    of its label text, through the kernels and through the plain float32
    chain (K8a's and K8b's plain versions, plain autograd).  Held, each
    trained leaf (the LoRA adapters or the unfrozen layers) in L2 over the
    plain leaf's norm, within F32_GRAD_L2_TOL (1e-4):

    * the tower alone, one fixed cotangent on the pooled label embeddings
      (no ReLU on the way);
    * the whole train step with no ReLU gate free to flip: the plain chain's
      tower hands the scorer the kernels' hidden states, bit for bit, and
      differentiates through its own graph (``hk + (hp - hp.detach())``),
      so both steps run the same scorer forward; ``grad_norm`` too.

    Reported beside them: the whole step with each chain's own hidden
    states, where a scorer pre-activation within a rounding of 0 flips its
    ReLU gate, with phases 31 and 37's noise floor (the plain chain with the
    tower's hidden states moved by a relative F32_Z_NOISE), leaf by leaf.

    Leaves whose gradient is 0 in exact arithmetic are float32 noise on
    both sides and left out of the comparisons: the key bias (a softmax
    does not see a constant added to a row of scores) and, in the step,
    bert's last LayerNorm bias (the W_l head's BatchNorm removes its
    shift)."""
    import torch

    from protnote_tpu_torch.models.text_transformer import pool_hidden_states
    from protnote_tpu_torch.train.optim import tree_leaves
    from protnote_tpu_torch.train.step import make_train_step

    class KeepGrads:
        def update(self, grads, trainable, state):
            self.grads = grads
            return state

    trainable, kw = trainer.ts["trainable"], trainer._tower_kwargs
    text_params = trainable.get("text", trainer.ts.get("text_params"))
    adapters = trainable.get("lora")
    wrt = tree_leaves(trainable["lora" if lora else "text"])
    first = cfg.num_layers - TOWER_TRAIN_LAYERS
    sub = adapters if lora else text_params["layers"][first:]
    names = {id(t): n for n, t in named_tensors(sub).items()}
    ids, am = batch["label_input_ids"], batch["label_attention_mask"]
    cot = torch.randn(ids.shape[0], cfg.hidden_size, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3))
    kernel_forward = step_mod.text_encoder_forward

    def tower_grads(forward):
        for t in wrt:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                hidden = forward(text_params, ids, am, cfg, lora=adapters,
                                 lora_alpha=kw["lora_alpha"], lora_rank=kw["lora_rank"])
                pooled = pool_hidden_states(hidden, am, kw["pooling_method"])
                grads = torch.autograd.grad((pooled * cot).sum(), wrt)
        finally:
            for t in wrt:
                t.requires_grad_(False)
        return {names[id(t)]: g for t, g in zip(wrt, grads) if id(t) in names}

    def step_grads(forward):
        keep = KeepGrads()
        step = make_train_step(trainer.pi_cfg, trainer.pn_cfg, trainer.loss_fn, keep,
                               decision_threshold=THRESHOLD, **kw)
        step_mod.text_encoder_forward = forward
        try:
            _, m = step(trainer.ts, batch, torch.Generator(device="cuda").manual_seed(7))
        finally:
            step_mod.text_encoder_forward = kernel_forward
        grads = {names[id(t)]: g for t, g in zip(tree_leaves(trainer.ts["trainable"]),
                                                 keep.grads) if id(t) in names}
        return grads, float(m["grad_norm"])

    def pinned_forward(*args, **kwargs):  # the kernels' values, the plain chain's graph
        hp = plain_forward(*args, **kwargs)
        with torch.no_grad():
            hk = kernel_forward(*args, **kwargs)
        return hk + (hp - hp.detach())

    def noisy_forward(*args, **kwargs):  # the plain tower, its output moved by F32_Z_NOISE
        h = plain_forward(*args, **kwargs)
        noise = torch.randn(h.shape, device=h.device,
                            generator=torch.Generator(device=h.device).manual_seed(9))
        return h * (1.0 + F32_Z_NOISE * noise)

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    tower = {"kernels": tower_grads(kernel_forward), "plain": tower_grads(plain_forward)}
    steps = {"kernels": step_grads(kernel_forward), "pinned": step_grads(pinned_forward),
             "plain": step_grads(plain_forward), "noise_floor": step_grads(noisy_forward)}
    scale = max(float(g.abs().max()) for g in tower["plain"].values())
    noise = {n: max(float(tower["kernels"][n].abs().max()),
                    float(tower["plain"][n].abs().max())) / scale
             for n in tower["plain"] if n.endswith("/k/bias")}
    last_ln = f"/{TOWER_TRAIN_LAYERS - 1}/ffn_ln/bias" if cfg.arch == "bert" and not lora \
        else None
    kept = [n for n in tower["plain"] if n not in noise]
    step_kept = [n for n in kept if n != last_ln]
    kernels_step = steps["kernels"][0]
    tower_l2 = {n: l2(tower["kernels"][n], tower["plain"][n]) for n in kept}
    pinned_l2 = {n: l2(kernels_step[n], steps["pinned"][0][n]) for n in step_kept}
    raw = [{"leaf": n, "kernels": l2(kernels_step[n], steps["plain"][0][n]),
            "noise_floor": l2(steps["noise_floor"][0][n], steps["plain"][0][n])}
           for n in step_kept]
    norms = {k: v[1] for k, v in steps.items()}
    pinned_norm = abs(norms["kernels"] - norms["pinned"]) / norms["pinned"]

    def worst(errs: dict) -> list:
        n = max(errs, key=errs.get)
        return [errs[n], n]

    result = {"leaves": len(kept), "tower_l2_rel_err": worst(tower_l2),
              "step_l2_rel_err": worst(pinned_l2), "grad_norm_rel_err": pinned_norm,
              "raw_step_l2_rel_err": worst({r["leaf"]: r["kernels"] for r in raw}),
              "raw_step_leaves_within_tol": sum(r["kernels"] <= F32_GRAD_L2_TOL for r in raw),
              "raw_step_leaves_within_twice_floor": sum(
                  r["kernels"] <= max(F32_GRAD_L2_TOL, 2 * r["noise_floor"]) for r in raw),
              "raw_step_worst_floor_ratio": max(r["kernels"] / r["noise_floor"] for r in raw),
              "max_noise_floor_l2_rel": max(r["noise_floor"] for r in raw),
              "step_leaves": len(raw), "z_noise": F32_Z_NOISE, "grad_norm": norms,
              "zero_gradient_leaves": len(noise),
              "zero_gradient_max_share": max(noise.values()) if noise else None,
              "l2_tol": F32_GRAD_L2_TOL}
    log("tower_grad_check_f32", arch=cfg.arch, lora=lora, **result, raw_by_leaf=raw)
    if max(list(tower_l2.values()) + list(pinned_l2.values()) + [pinned_norm]) > \
            F32_GRAD_L2_TOL or max(noise.values(), default=0.0) > 1e-3 or \
            not math.isfinite(pinned_norm):
        raise AssertionError(f"float32 tower gradients through the kernels disagree with the "
                             f"plain chain: {result}")
    return result


def phase_k8_f32(card: str) -> dict:
    """Phase 38: K8a f32, K8a-bwd f32, K8b f32 and K8b-bwd f32 alone at
    phase 13's three shapes against their plain float32 versions on the same
    device tensors; float32 SDPA with a boolean mask and ``F.layer_norm``
    after a float32 add (and their backward) as yardsticks."""
    import torch
    import torch.nn.functional as F

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import layer_norm as k8b
    from protnote_tpu_torch.ops import text_attention as k8a
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    nh, hd, Hd = 16, 64, 1024
    gen = torch.Generator().manual_seed(50)
    dev = torch.device("cuda")
    gemm_precision(torch.float32)

    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    def counts(mod):
        return (mod.LAUNCHES, mod.BWD_LAUNCHES, mod.F32_LAUNCHES, mod.F32_BWD_LAUNCHES)

    out = {}
    for name, Bq, T, lo, hi, causal in K8_SHAPES:
        _, mask = token_batch(gen, Bq, T, lo, hi, 100, 1)
        q, k, v, g = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev) for _ in range(4))
        before = counts(k8a)
        got = k8a.masked_attention_cuda(q, k, v, mask, causal)
        grads = k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g)
        again = k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g)
        a_launches = [x - y for x, y in zip(counts(k8a), before)]
        want = k8a.masked_attention_reference(q, k, v, mask, causal)
        want_g = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
        torch.cuda.synchronize()
        a_errs = {"ctx": rel(got, want),
                  **{n: rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, want_g)}}
        finite = all(bool(torch.isfinite(t).all()) for t in (got, *grads))
        deterministic = all(torch.equal(a, b) for a, b in zip(grads, again))
        f_err = float((got - want).abs().max())
        b_err = max(float((a - b).abs().max()) for a, b in zip(grads, want_g))
        del got, grads, again, want, want_g
        keep = (mask > 0)[:, None, None, :]
        if causal:
            keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        ctx = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep)
        frac = 0.5 if causal else 1.0  # the products a causal row needs
        # (bytes, operations): q, k, v read and ctx written, two products;
        # q, k, v, dctx read and dq, dk, dv written, five products
        work = {"fwd": (4.0 * q.numel() * 4 + 4.0 * mask.numel(),
                        4.0 * Bq * nh * T * T * hd * frac),
                "bwd": (7.0 * q.numel() * 4 + 4.0 * mask.numel(),
                        10.0 * Bq * nh * T * T * hd * frac)}
        attn = {"ms": cuda_time_ms(lambda: k8a.masked_attention_cuda(q, k, v, mask, causal), 10),
                "plain_ms": cuda_time_ms(lambda: k8a.masked_attention_reference(
                    q, k, v, mask, causal), 3),
                "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep), 10),
                "max_abs_err": f_err, "rel_err": a_errs["ctx"]}
        attn_bwd = {"ms": cuda_time_ms(lambda: k8a.masked_attention_backward_cuda(
                        q, k, v, mask, causal, g), 5),
                    "plain_ms": cuda_time_ms(lambda: k8a.masked_attention_backward_reference(
                        q, k, v, mask, causal, g), 2),
                    "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
                        ctx, (ql, kl, vl), g, retain_graph=True), 5),
                    "max_abs_err": b_err, "rel_err": {n: a_errs[n] for n in ("dq", "dk", "dv")},
                    "deterministic": deterministic}
        for entry, (nbytes, ops) in ((attn, work["fwd"]), (attn_bwd, work["bwd"])):
            entry.update(bound(nbytes, ops, peak=TF32X3_FLOPS))
            entry["fma_bound_ms"] = bound(nbytes, ops, peak=F32_FLOPS)["bound_ms"]
            entry["tflops"] = ops / entry["ms"] / 1e9
        del ctx, ql, kl, vl, keep, q, k, v, g
        torch.cuda.empty_cache()

        rows = Bq * T
        x = torch.randn(rows, Hd, generator=gen).to(dev)
        r = None if causal else torch.randn(rows, Hd, generator=gen).to(dev)
        gy = torch.randn(rows, Hd, generator=gen).to(dev)
        scale = (0.5 + torch.rand(Hd, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(Hd, generator=gen)).to(dev)
        stats = torch.empty(rows, 2, device=dev)
        before = counts(k8b)
        y = k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5, stats)
        dn = k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)
        dn_again = k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)
        n_launches = [a - b for a, b in zip(counts(k8b), before)]
        want_y, plain_stats = k8b._reference_with_stats(x, r, scale, bias, 1e-5)
        want_dn = k8b.add_layer_norm_backward_reference(x, r, scale, plain_stats, gy)
        torch.cuda.synchronize()
        n_errs = {"y": rel(y, want_y), "stats": rel(stats, plain_stats),
                  **{n: rel(a, b) for n, a, b in zip(("dx", "dscale", "dbias"), dn, want_dn)}}
        finite = finite and all(bool(torch.isfinite(t).all()) for t in (y, *dn))
        deterministic = deterministic and all(torch.equal(a, b) for a, b in zip(dn, dn_again))
        ny_err = float((y - want_y).abs().max())
        nb_err = max(float((a - b).abs().max()) for a, b in zip(dn, want_dn))
        del y, dn, dn_again, want_y, want_dn
        xl = x.detach().clone().requires_grad_(True)
        rl = None if r is None else r.detach().clone().requires_grad_(True)
        sl, bl = (t.detach().clone().requires_grad_(True) for t in (scale, bias))
        yl = F.layer_norm(xl if rl is None else xl + rl, (Hd,), sl, bl, 1e-5)
        wrt = [t for t in (xl, rl, sl, bl) if t is not None]

        def n_kernel():
            return k8b.add_layer_norm_cuda(x, r, scale, bias, 1e-5, stats)

        def n_bwd():
            return k8b.add_layer_norm_backward_cuda(x, r, scale, stats, gy)

        norm = {"ms": cuda_time_ms(n_kernel, 20),
                "plain_ms": cuda_time_ms(lambda: k8b.add_layer_norm_reference(
                    x, r, scale, bias, 1e-5), 5),
                "library_ms": cuda_time_ms(lambda: F.layer_norm(
                    x if r is None else x + r, (Hd,), scale, bias, 1e-5), 20),
                "max_abs_err": ny_err, "rel_err": {n: n_errs[n] for n in ("y", "stats")},
                **bound(nbytes=4.0 * rows * Hd * (2 if r is None else 3) + 8.0 * Hd)}
        norm_bwd = {"ms": cuda_time_ms(n_bwd, 20),
                    "plain_ms": cuda_time_ms(lambda: k8b.add_layer_norm_backward_reference(
                        x, r, scale, stats, gy), 5),
                    "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
                        yl, wrt, gy, retain_graph=True), 20),
                    "max_abs_err": nb_err,
                    "rel_err": {n: n_errs[n] for n in ("dx", "dscale", "dbias")},
                    **bound(nbytes=4.0 * rows * Hd * (3 if r is None else 4) + 8.0 * rows
                            + 12.0 * Hd)}
        norm["device_ms"], norm["host_ms"] = device_and_host_ms(n_kernel, 20)
        norm_bwd["device_ms"], norm_bwd["host_ms"] = device_and_host_ms(n_bwd, 20)
        del x, r, gy, yl, xl, rl, sl, bl, wrt, stats, plain_stats
        torch.cuda.empty_cache()
        out[name] = {"text_attention_f32": attn, "text_attention_bwd_f32": attn_bwd,
                     "add_layer_norm_f32": norm, "add_layer_norm_bwd_f32": norm_bwd}
        log("k8_f32_check", shape=name, batch=Bq, tokens=T, lengths=[lo, hi], causal=causal,
            heads=nh, head_dim=hd, width=Hd, finite=finite, rel_tol=K8_F32_REL_TOL,
            attention_launches=a_launches, layer_norm_launches=n_launches, **out[name],
            card=card)
        worst = max(list(a_errs.values()) + list(n_errs.values()))
        if not finite or not deterministic or worst > K8_F32_REL_TOL or \
                a_launches != [0, 0, 1, 2 * k8a.backward_launches(T, torch.float32)] or \
                n_launches != [0, 0, 1, 4]:
            raise AssertionError(f"K8 float32 ({name}) disagrees with its plain version: "
                                 f"{a_errs} {n_errs} (rel tol {K8_F32_REL_TOL}), finite "
                                 f"{finite}, deterministic {deterministic}, launches "
                                 f"{a_launches} {n_launches}")
    log("k8_f32_ptxas", layer_norm=k8b_ptxas(f32=True),
        text_attention_f32=[{"kernel": n[0], "ptxas": p, "spills": s} for n, p, s in
                            ptxas_by_kernel(load_kernel_library("text_attention_f32").build_log,
                                            r"(attn_\w+_f32)")], card=card)
    return out


def phase_tower_f32(card: str, bf16_rows) -> dict:
    """Phase 39: the tower in float32 (``MIXED_PRECISION False`` and the
    native label-embedding generator): E5-large and BioGPT on phase 14's
    random weights (the same seeds, not rounded to bf16) against the plain
    float32 tower on one chunk each; then phase 14's 64 chunks through
    ``NativeLabelEncoder.embed_ids`` with a float32 config (descriptions/s,
    ms a chunk, peak memory, the float32 kernels' launches and none of the
    bf16 forms, a profile of 2 chunks), and the drift of phase 14's bf16
    rows (``bf16_rows``) from these float32 rows: each row's relative L2
    distance, its largest and mean.  Returns the launches of the 64-chunk
    run."""
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

    f32 = torch.float32
    one_chunk, chunks = tower_chunks()

    def reset():
        k8a.LAUNCHES = k8b.LAUNCHES = k8a.F32_LAUNCHES = k8b.F32_LAUNCHES = 0

    def launches():
        return ({"text_attention_f32": k8a.F32_LAUNCHES, "add_layer_norm_f32": k8b.F32_LAUNCHES},
                {"text_attention": k8a.LAUNCHES, "add_layer_norm": k8b.LAUNCHES})

    for arch, cfg, seed in (("e5_large", TextEncoderConfig.e5_large(dtype=f32), 33),
                            ("biogpt", TextEncoderConfig.biogpt(dtype=f32), 34)):
        params = random_tower(cfg, seed)
        ids, mask = one_chunk[arch]
        reset()
        with torch.inference_mode():
            got = pool_hidden_states(text_encoder_forward(params, ids, mask, cfg), mask, "mean")
            ran, bf16_forms = launches()
            want = pool_hidden_states(text_encoder_forward_reference(params, ids, mask, cfg),
                                      mask, "mean")
        torch.cuda.synchronize()
        err, finite = pooled_err(got, want)
        log("tower_f32_check", arch=arch, layers=cfg.num_layers, width=cfg.hidden_size,
            rel_err=err, rel_tol=TOWER_F32_REL_TOL, finite=finite, launches=ran,
            bf16_launches=bf16_forms, card=card)
        if not finite or err > TOWER_F32_REL_TOL or any(v <= 0 for v in ran.values()) or \
                any(bf16_forms.values()):
            raise AssertionError(f"the float32 {arch} tower disagrees with the plain float32 "
                                 f"tower: {err} (rel tol {TOWER_F32_REL_TOL}), finite {finite}, "
                                 f"launches {ran}, bf16 {bf16_forms}")
        del got, want
        if arch == "e5_large":
            e5_cfg, e5_params = cfg, params
        del params
        torch.cuda.empty_cache()

    encoder = NativeLabelEncoder(e5_cfg, e5_params, device="cuda")
    del e5_params
    encoder.embed_ids(*chunks[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    rows = torch.cat([encoder.embed_ids(ids, mask) for ids, mask in chunks])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    ran, bf16_forms = launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy, top = device_profile(lambda: encoder.embed_ids(*chunks[0]), 2)
    real = rows.norm(dim=1) > 0  # the filler row pools to zeros on both sides
    drift = ((bf16_rows.float() - rows).norm(dim=1)[real] / rows.norm(dim=1)[real])
    n = rows.shape[0]
    result = {"chunks": TOWER_CHUNKS, "rows": n, "seconds": sec, "descriptions_per_s": n / sec,
              "ms_per_chunk": sec * 1e3 / TOWER_CHUNKS, "peak_mem_gb": peak, "launches": ran,
              "bf16_launches": bf16_forms,
              "launches_per_chunk": {k: v / TOWER_CHUNKS for k, v in ran.items()},
              "profile_wall_ms_per_chunk": wall * 1e3 / 2,
              "idle_share": None if busy is None else 1.0 - busy / wall,
              "top_kernels_ms_per_chunk": top,
              "bf16_drift_max_row_rel": float(drift.max()),
              "bf16_drift_mean_row_rel": float(drift.mean()), "drift_rows": int(real.sum())}
    log("tower_f32", arch="e5_large", **result, card=card)
    if any(v <= 0 for v in ran.values()) or any(bf16_forms.values()) or \
            not bool(torch.isfinite(rows).all()) or int(real.sum()) != n - 1:
        raise AssertionError(f"the float32 tower run: {result}")
    del encoder, rows
    torch.cuda.empty_cache()
    return ran


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
    550 channels, one row dropped by the example mask; :func:`k7_bn`), each
    against the plain chain's autograd on the same tensors.  Times are of
    the whole chain's calls from CUDA events, beside the plain versions'
    (the backward alone, on a retained graph) and, for the convs, cuDNN's
    conv backward on the same shapes (``torch.nn.grad.conv1d_input`` /
    ``conv1d_weight``, the library time, which the port never calls);
    bounds are the convs' products for these lengths over the bf16 peak and
    the BN's bytes (each input read once, each output written once) over
    the memory rate."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.models.proteinfer import (
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

    out.update(k7_bn(card, params, state, lengths, act))
    out["masked_mean_pool_bwd"] = k7_pool_backward(lengths, T, cfg.output_channels, gen)
    out["masked_conv_dx"]["kernel_only_ms"] = dx_kernel_ms
    log("k7_bwd", batch=B, bucket=T, lengths=[int(n) for n in lens], kernels=out,
        ptxas=k7_ptxas("masked_conv_bwd"),
        rel_tol={"outputs": K45_REL_TOL, "stats": K7_F32_REL_TOL, "sums": K7_SUMS_REL_TOL},
        card=card)
    torch.cuda.empty_cache()
    return out


def k7_pool_backward(lengths, T: int, C: int, gen) -> dict:
    """The pool's transpose (``masked_mean_pool_backward``) at 32 sequences
    x ``T`` x ``C`` against ``masked_mean_pool_backward_reference`` on the
    same float32 cotangent: bit for bit (signed zeros included), its
    padding channels 0, the same bits on a second call; events, device and
    host ms beside the plain version's (alone, and with the copy to the
    padded pitch that the last conv's backward made of its contiguous
    result) and the bound: the cotangent read once, every row of the padded
    gradient written once."""
    import torch

    from protnote_tpu_torch.ops import masked_conv as k7

    dev = lengths.device
    g = torch.randn(B, C, generator=gen, device=dev)
    got = k7.masked_mean_pool_backward_cuda(g, lengths, T)
    again = k7.masked_mean_pool_backward_cuda(g, lengths, T)
    want = k7.masked_mean_pool_backward_reference(g, lengths, T, torch.bfloat16)
    bits = lambda t: t.contiguous().view(torch.int16)  # noqa: E731
    equal = torch.equal(bits(got), bits(want))
    pad_zero = not bool(padding_channels(got).view(torch.int16).any())
    same = torch.equal(bits(got), bits(again)) and torch.equal(bits(padding_channels(got)),
                                                               bits(padding_channels(again)))
    if not (equal and pad_zero and same):
        raise AssertionError(f"masked_mean_pool_backward: bit-equal {equal}, padding zero "
                             f"{pad_zero}, same bits twice {same}")
    kernel = lambda: k7.masked_mean_pool_backward_cuda(g, lengths, T)  # noqa: E731
    plain = lambda: k7.masked_mean_pool_backward_reference(g, lengths, T,  # noqa: E731
                                                           torch.bfloat16)
    device_ms, host_ms = device_and_host_ms(kernel, 20)
    out = {"max_abs_err": 0.0, "ms": cuda_time_ms(kernel, 20), "plain_ms": cuda_time_ms(plain, 20),
           "plain_with_copy_ms": cuda_time_ms(lambda: k7.pad_pitch(plain()), 20),
           **bound(nbytes=4.0 * B * C + 4.0 * B + 2.0 * B * T * got.stride(1)),
           "library_ms": None, "device_ms": device_ms, "host_ms": host_ms,
           "bit_equal": equal, "padding_zero": pad_zero, "same_bits": same}
    out["device_share_of_bound"] = None if device_ms is None else out["bound_ms"] / device_ms
    return out


def bn_ptxas() -> dict:
    """The ptxas registers and spills of K7-BN's four kernels."""
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    return {name: [regs, spills] for (name,), regs, spills in ptxas_by_kernel(
        load_kernel_library("masked_bn").build_log,
        r"(bn_stats_kernel|bn_apply_kernel|bn_grad_sums_kernel|bn_dx_kernel)")}


def copies_in(fn, batch: int, widths) -> dict:
    """The ``aten::copy_`` calls of one call of ``fn`` (``torch.profiler``
    with shapes): all of them, and those whose first input is a ``(batch,
    T, C)`` activation with C in ``widths``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    copies = [e for e in prof.events() if e.name == "aten::copy_"]
    acts = [e for e in copies if e.input_shapes and len(e.input_shapes[0]) == 3
            and e.input_shapes[0][0] == batch and e.input_shapes[0][2] in widths]
    return {"all": len(copies), "activations": len(acts)}


def padding_channels(t):
    """The padding channels of a ``(B, T, C)`` tensor at ``row_pitch(C)``:
    a ``(B, T, row_pitch(C) - C)`` view of its buffer."""
    import torch

    from protnote_tpu_torch.ops.masked_conv import row_pitch

    Bt, Tt, C = t.shape
    P = row_pitch(C)
    return torch.as_strided(t, (Bt, Tt, P - C), (Tt * P, P, 1), t.storage_offset() + C)


def k7_bn(card: str, params, state, lengths, act) -> dict:
    """K7-BN, the train-mode masked BN + ReLU (``masked_bn_relu_forward`` /
    ``_backward``), on the 10 BatchNorms of an encoder training step (1,100
    and 550 channels, 32 sequences at bucket 512, one row dropped by the
    example mask): x and dy at the convs' padded pitch, as training passes
    them (their padding channels uninitialised), each against the plain
    chain's autograd on the same tensors (y and dx within 2^-6 of the
    largest |value|, the running statistics within 1e-5, dscale and dbias
    within 1e-3); the same bits on a second call; y's and dx's padding
    channels 0; the kernels a wrapper call launches (counted in the C
    library, ``bn_kernels_launched``).
    Times of a step's 10 calls: CUDA events around back-to-back calls, the
    device and host time of each (``device_and_host_ms``), and from
    contiguous inputs (which the wrappers copy to the pitch first).  Bounds:
    the bytes the function needs over the memory rate, the forward x read
    and y written, the backward x and dy read and dx written (3 tensors: the
    ReLU's gate is recomputed from x, y is not read)."""
    import torch

    from protnote_tpu_torch.models.proteinfer import BN_EPS, BN_MOMENTUM
    from protnote_tpu_torch.ops import masked_conv as k7

    dev = torch.device("cuda")
    em = torch.ones(B, device=dev)
    em[3] = 0.0
    bns = [(bp[n], bs[n]) for bp, bs in zip(params["blocks"], state["blocks"])
           for n in ("bn1", "bn2")]
    items, errs = [], {"y": [], "stats": [], "dx": [], "sums": []}
    same_bits, padding_zero = True, True
    for p, s in bns:
        C = p["scale"].shape[0]
        x, g = k7.pad_pitch(act(C, 0.3)), k7.pad_pitch(act(C))
        fwd = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                             lengths, em, BN_EPS, BN_MOMENTUM)
        y, mean, var, stats, counts = fwd
        xg = x.clone().requires_grad_(True)
        pg = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y0, new0 = k7.masked_bn_relu_reference(xg, pg, s, lengths, em, BN_EPS, BN_MOMENTUM)
        dx0, ds0, db0 = torch.autograd.grad(y0, [xg, pg["scale"], pg["bias"]], g,
                                            retain_graph=True)
        bwd = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
        dx, ds, db = bwd
        fwd2 = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                              lengths, em, BN_EPS, BN_MOMENTUM)
        bwd2 = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
        same_bits = same_bits and all(torch.equal(a, b) for a, b in zip(fwd + bwd, fwd2 + bwd2))
        padding_zero = padding_zero and all(bool((padding_channels(t) == 0).all())
                                            for t in (y, dx))
        errs["y"].append(rel_max(y, y0))
        errs["stats"] += [rel_max(mean, new0["mean"]), rel_max(var, new0["var"])]
        errs["dx"].append(rel_max(dx, dx0))
        errs["sums"] += [rel_max(ds, ds0), rel_max(db, db0)]
        items.append((p, s, x, g, stats, counts, xg, pg, y0))
        del fwd2, bwd2
    flat = [(x.contiguous(), g.contiguous()) for _, _, x, g, *_ in items]

    def fwd_calls(inputs):
        return lambda: [k7.masked_bn_relu_forward_cuda(
            x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, BN_EPS, BN_MOMENTUM)
            for (p, s, *_), (x, _) in zip(items, inputs)]

    def bwd_calls(inputs):
        return lambda: [k7.masked_bn_relu_backward_cuda(
            x, g, p["scale"], stats, counts, lengths, em)
            for (p, s, _, _, stats, counts, *_), (x, g) in zip(items, inputs)]

    pitched = [(x, g) for _, _, x, g, *_ in items]
    times = {}
    for key, calls in (("fwd", fwd_calls), ("bwd", bwd_calls)):
        run = calls(pitched)
        launched = k7.bn_kernels_launched()
        run()
        torch.cuda.synchronize()
        launched = (k7.bn_kernels_launched() - launched) / len(items)
        times[key] = {"ms": cuda_time_ms(run, 5),
                      "contiguous_ms": cuda_time_ms(calls(flat), 5),
                      "launches_per_call": launched, "calls": len(items)}
        times[key]["device_ms"], times[key]["host_ms"] = device_and_host_ms(run, 5)
    fwd_plain_ms = cuda_time_ms(lambda: [k7.masked_bn_relu_reference(
        x, p, s, lengths, em, BN_EPS, BN_MOMENTUM) for p, s, x, *_ in items], 3)
    bwd_plain_ms = cuda_time_ms(lambda: [torch.autograd.grad(
        y0, [xg, pg["scale"], pg["bias"]], g, retain_graph=True)
        for p, s, x, g, stats, counts, xg, pg, y0 in items], 3)
    elems = sum(B * x.shape[1] * p["scale"].shape[0] for p, _, x, *_ in items)
    worst = {k: max(r for _, r in v) for k, v in errs.items()}
    out = {"masked_bn_relu_fwd": {
        "max_abs_err": max(e for e, _ in errs["y"]), "plain_ms": fwd_plain_ms,
        **bound(nbytes=2.0 * 2 * elems), "library_ms": None, "max_rel_err": worst["y"],
        "stats_rel_err": worst["stats"], **times["fwd"]},
        "masked_bn_relu_bwd": {
        "max_abs_err": max(e for e, _ in errs["dx"]), "plain_ms": bwd_plain_ms,
        **bound(nbytes=2.0 * 3 * elems), "library_ms": None, "max_rel_err": worst["dx"],
        "sums_rel_err": worst["sums"], **times["bwd"]}}
    for k in out.values():
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
        k["device_share_of_bound"] = (None if k["device_ms"] is None
                                      else k["bound_ms"] / k["device_ms"])
    log("k7_bn", batch=B, bucket=x.shape[1], kernels=out, same_bits=same_bits,
        padding_zero=padding_zero, pitches=sorted({x.stride(1) for _, _, x, *_ in items}),
        ptxas=bn_ptxas(),
        rel_tol={"outputs": K45_REL_TOL, "stats": K7_F32_REL_TOL, "sums": K7_SUMS_REL_TOL},
        card=card)
    if worst["y"] > K45_REL_TOL or worst["dx"] > K45_REL_TOL or \
            worst["stats"] > K7_F32_REL_TOL or worst["sums"] > K7_SUMS_REL_TOL:
        raise AssertionError(f"K7-BN disagrees with its plain version: {worst}")
    if not same_bits or not padding_zero:
        raise AssertionError(f"K7-BN: same bits {same_bits}, padding channels 0 {padding_zero}")
    if any(out[k]["launches_per_call"] != 2 for k in out):
        raise AssertionError(f"K7-BN launches a call: {out}")
    del items, flat, pitched
    return out


def encoder_grad_check(trainer, batch, cfg, dtype=None, grad_tol: float = GRAD_REL_TOL,
                       stats_tol: float = STATS_REL_TOL, noise: float = 0.0) -> dict:
    """One batch through the trainable encoder (``trainable["encoder"]``,
    float32 masters, bf16 compute, or float32 with ``dtype`` float32) with
    train-mode BatchNorm, through K7's kernels and through the plain chain,
    under one fixed cotangent on the pooled embeddings: each trained leaf's
    gradient through the kernels within ``grad_tol`` of the plain chain's in
    L2, and the new running statistics within ``stats_tol`` of the plain
    chain's largest |value|.  With ``noise``, a third run of the plain chain
    with each conv's output multiplied by 1 + ``noise`` x N(0, 1) (seeded)
    gives each leaf's noise floor, and a leaf may also lie within twice its
    floor: in float32 a rounding-level change of an activation flips the
    ReLU gates that lie within it of 0, and each flipped gate moves the
    leaves upstream by far more than a rounding."""
    import torch

    from protnote_tpu_torch.models import proteinfer as tpi
    from protnote_tpu_torch.train.optim import tree_leaves

    enc, state = trainer.ts["trainable"]["encoder"], trainer.ts["enc_state"]
    named = [(f"{name}.{k}", p[k]) for name, p, _ in k7_convs(enc, cfg) for k in ("kernel", "bias")]
    named += [(f"block{i}.{n}.{k}", bp[n][k]) for i, bp in enumerate(enc["blocks"])
              for n in ("bn1", "bn2") for k in ("scale", "bias")]
    leaves = [t for _, t in named]
    aa, lengths, em = batch["aa_ids"], batch["lengths"], batch["example_mask"]
    onehot = tpi.one_hot_sequences(aa, cfg.input_channels, dtype or torch.bfloat16)
    dev = aa.device
    cot = torch.randn(aa.shape[0], cfg.output_channels,
                      generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    conv_plain = tpi.masked_conv_reference
    gen = torch.Generator(device=dev)

    def noisy_conv(*args, **kwargs):
        y = conv_plain(*args, **kwargs)
        return y * (1.0 + noise * torch.randn(y.shape, generator=gen, device=dev))

    runs = {}
    for name in ("kernels", "plain") + (("noise",) if noise else ()):
        for t in leaves:
            t.requires_grad_(True)
        gen.manual_seed(9)
        tpi.masked_conv_reference = noisy_conv if name == "noise" else conv_plain
        try:
            if name == "kernels":
                P, new = tpi.embed_from_ids(enc, state, aa, lengths, cfg, train=True,
                                            example_mask=em)
            else:
                P, new = tpi.proteinfer_embed_reference(enc, state, onehot, lengths, cfg, True, em)
            runs[name] = (torch.autograd.grad((P * cot).sum(), leaves), new)
        finally:
            tpi.masked_conv_reference = conv_plain
            for t in leaves:
                t.requires_grad_(False)
    gp = runs["plain"][0]

    def l2(run):
        return {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for (n, _), a, b in zip(named, runs[run][0], gp)}

    rel = l2("kernels")
    floor = l2("noise") if noise else {n: 0.0 for n in rel}
    stats = max(rel_max(a, b)[1] for a, b in zip(tree_leaves(runs["kernels"][1]),
                                                 tree_leaves(runs["plain"][1])))
    bad = {n: v for n, v in rel.items() if v > max(grad_tol, 2 * floor[n])}
    if bad or stats > stats_tol:
        raise AssertionError(f"the encoder's gradients or statistics through K7 differ from "
                             f"the plain chain's: {bad} (floor {floor}), stats {stats}")
    return {"sequences": int(aa.shape[0]), "leaves": len(named),
            "max_leaf_rel_l2": max(rel.values()), "worst_leaf": max(rel, key=rel.get),
            "stats_rel_err": stats, "noise": noise, "max_noise_floor": max(floor.values()),
            "leaves_within_tol": sum(v <= grad_tol for v in rel.values()),
            "leaf_rel_l2": {k: [round(v, 8), round(floor[k], 8)] for k, v in rel.items()}}


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
    The ``aten::copy_`` calls of one step are counted by ``torch.profiler``
    (all of them, and those of the chain's (B, T, C) activations).  Returns
    the first run's launches of K7's kernels and a summary (step ms, seqs/s,
    peaks at 512 and 1024, idle share, copies a step, the
    ENCODER_BN_TRAIN_MODE step)."""
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
        if any((v > 0) == (k in K7_F32 + K7_F32_TRAIN) for k, v in fields["launches"].items()):
            raise AssertionError(f"encoder training skipped a kernel or ran a float32 one: "
                                 f"{fields['launches']}")
        result = {k: fields["launches"][k] for k in k7.LAUNCHES}
        inner = batcher(train_ds, 512, True)
        inner.set_epoch(1)
        batches = []
        for b in inner:
            batches.append(b)
            if len(batches) == PROFILE_STEPS + 1:
                break
        matrix = trainer._label_matrix_for(train_ds)
        placed = [trainer._place(batch_to_device_dict(b, dev), matrix) for b in batches]
        g_prof = torch.Generator(device=dev).manual_seed(1)
        it = iter(placed)
        step_fn = trainer._train_step

        def one_step():
            trainer.ts, _ = step_fn(trainer.ts, next(it), g_prof)

        wall, busy, top = device_profile(one_step, PROFILE_STEPS, keep=("pool_",))
        pool_bwd = [ms for name, ms in top if "pool_backward_kernel" in name]
        fields.update(pool_bwd_launches_per_step=fields["launches"]["masked_mean_pool_bwd"]
                      / fields["steps"],
                      pool_bwd_device_ms_per_step=sum(pool_bwd) if pool_bwd else None,
                      pool_bwd_bound_ms=bound(nbytes=4.0 * TRAIN_B * pi_cfg.output_channels
                                              + 2.0 * TRAIN_B * 512
                                              * k7.row_pitch(pi_cfg.output_channels))["bound_ms"])
        if fields["pool_bwd_launches_per_step"] != 1:
            raise AssertionError(f"encoder training: the pool's backward kernel ran "
                                 f"{fields['pool_bwd_launches_per_step']} times a step")
        fields.update(copies_per_step=copies_in(one_step, TRAIN_B,
                                                {pi_cfg.output_channels,
                                                 pi_cfg.bottleneck_channels}))
        placed = placed[:PROFILE_STEPS]
        fields.update(profile_wall_ms_per_step=wall * 1e3 / len(placed),
                      profile_device_busy_ms_per_step=None if busy is None
                      else busy * 1e3 / len(placed),
                      idle_share=None if busy is None else 1.0 - busy / wall,
                      top_kernels_ms_per_step=top,
                      grad_check=encoder_grad_check(trainer, placed[0], pi_cfg))
        log("encoder_train", run="train_sequence_encoder", **fields, card=card)
        summary = {k: fields[k] for k in ("median_warm_step_ms", "seqs_per_s", "peak_mem_gb",
                                          "idle_share", "copies_per_step",
                                          "pool_bwd_device_ms_per_step")}
        summary["grad_check_worst"] = fields["grad_check"]["max_leaf_rel_l2"]

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
        fields = run("train_sequence_encoder_1024", trainer, 1024, ENCODER_1024_STEPS, False)
        summary["peak_mem_gb_1024"] = fields["peak_mem_gb"]
        log("encoder_train", run="train_sequence_encoder_1024", **fields, card=card)
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
                launches[k] for k in ("masked_conv_dx", "masked_conv_dw", "masked_bn_relu_bwd",
                                      "masked_mean_pool_bwd")):
            raise AssertionError(f"ENCODER_BN_TRAIN_MODE: launches {launches}, running "
                                 f"statistics moved {moved}, weights frozen {frozen}")
        log("encoder_train", run="encoder_bn_train_mode", **fields, stats_moved=moved,
            card=card)
        summary["bn_train_mode_step_ms"] = fields["median_warm_step_ms"]
        del trainer
        torch.cuda.empty_cache()
    return result, summary


def phase_k6(card: str, f32: bool = False) -> dict:
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
    None.  ``f32`` (phase 32): the ``_f32`` forms on float32 tensors (w
    too), every output within F32_REL_TOL of the plain float32 version's
    largest |value| (the column sums within the tile depth's figure)."""
    import torch

    from protnote_tpu_torch.ops import streaming_train as st

    dev = torch.device("cuda")
    dt = torch.float32 if f32 else torch.bfloat16
    N = TRAIN_B * STREAM_TILE
    g = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        r = 0.3 * torch.randn(H, device=dev, generator=g)
        z = (torch.randn(N, H, device=dev, generator=g) + r).to(dt)
        em = torch.ones(TRAIN_B, device=dev)
        em[-1] = 0.0
        lm = (torch.rand(STREAM_TILE, device=dev, generator=g) < 0.98).float()
        rows = (em[:, None] * lm[None, :]).reshape(N, 1)
        inv = 0.5 + torch.rand(H, device=dev, generator=g)
        shift = 0.3 * torch.randn(H, device=dev, generator=g)
        w = (torch.randn(H, device=dev, generator=g) * (6.0 / H) ** 0.5).to(dt)
        b = torch.tensor(0.1, device=dev)
        dy = torch.randn(N, H, device=dev, generator=g).to(dt)
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
        sums = {"s1", "s2", "dinv", "dshift", "dw", "db"}
        errs, rel, times = {}, {}, {}
        before = dict(st.LAUNCHES)
        for name, (kern, plain, outs) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs[name] = {o: delta(a, b_) for o, a, b_ in zip(outs, got, want)}
            rel[name] = {o: d[0] / max(d[1], 1e-30) for o, d in errs[name].items()}
            if f32:
                tols = {o: depth_tol(N) if o in sums else F32_REL_TOL for o in outs}
            else:
                tols = {o: K45_REL_TOL if a.dtype == torch.bfloat16 else K6_SUMS_REL_TOL
                        for o, a in zip(outs, got)}
            if any(rel[name][o] > tols[o] for o in outs) or \
                    any(a.dtype != b_.dtype for a, b_ in zip(got, want)):
                raise AssertionError(f"{name} disagrees with its plain version: {errs[name]}")
            del got, want
            times[name] = (cuda_time_ms(kern, 20), cuda_time_ms(plain, 3))
        sfx = "_f32" if f32 else ""
        launched = {k for k in st.LAUNCHES if st.LAUNCHES[k] != before[k]}
        if launched != {k + sfx for k in calls}:
            raise AssertionError(f"K6's wrappers launched {launched}")
    nh, e = float(N) * H, z.element_size()
    ops = {  # bytes: each input read once, each output written once; f32 operations
        "stream_moments": bound(e * nh + 4 * N + 12 * H, 5 * nh, F32_FLOPS),
        "stream_moments_backward": bound(2 * e * nh + 4 * N + 12 * H, 4 * nh, F32_FLOPS),
        "affine_relu": bound(2 * e * nh + 8 * H, 3 * nh, F32_FLOPS),
        "affine_relu_backward": bound(3 * e * nh + 16 * H, 6 * nh, F32_FLOPS),
        "stream_head": bound(e * nh + 4 * N + (8 + e) * H, 5 * nh, F32_FLOPS),
        "stream_head_backward": bound(2 * e * nh + 4 * N + (16 + e) * H + 4, 11 * nh,
                                      F32_FLOPS),
    }
    log(f"k6{sfx}_kernels_alone", rows=N, width=H, tile=STREAM_TILE, dtype=str(dt),
        max_abs_errs={k: {o: d[0] for o, d in v.items()} for k, v in errs.items()},
        rel_errs=rel, bf16_rel_tol=None if f32 else K45_REL_TOL,
        sums_rel_tol=depth_tol(N) if f32 else K6_SUMS_REL_TOL,
        f32_rel_tol=F32_REL_TOL if f32 else None,
        ms={k: v[0] for k, v in times.items()}, plain_ms={k: v[1] for k, v in times.items()},
        bound_ms={k: v["bound_ms"] for k, v in ops.items()},
        library="none: no single PyTorch call computes these functions", card=card)
    first = {k: next(iter(v.values()))[0] for k, v in errs.items()}  # the main output's
    return {k + sfx: {"max_abs_err": first[k], "ms": times[k][0], "plain_ms": times[k][1],
                      **ops[k], "library_ms": None} for k in calls}


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


# ----------------------------------------------------------------------
# the dense scorer (phases 24-27)


def dense_act_check(card: str, bn: bool, z, dy, rows, n, seed) -> dict:
    """K5's dense form (``bn``: centred BN; else the bias) with dropout at
    full width against its plain version in column slices (each column's
    work is independent; the mask's columns placed by ``col0``): y and (BN)
    the moments from the forward; dz and dscale/dbias (or dbias) from the
    backward, the plain backward on the kernel's statistics as phase 8 does
    for K5 (a pre-activation within an ulp of 0 would otherwise gate
    differently); the kernels' times beside the plain version's (its slices
    in turn) and the bytes bound (z in, y out; z and dy in, dz out).  On
    float32 z the ``_f32`` forms, held within F32_REL_TOL (the moments and
    the column sums within the pair depth's figure), and the kept values
    and the mask the same bits as the plain version's: y of the bias form
    and its dz whole, y of the BN form on the kernel's own affine.

    The BN check moves z's last DENSE_PLAIN_COLS columns DENSE_OFFSET times
    their spread (1) from 0 for its run (put back after) and holds that
    slice on its own (the ``*_offset`` errors) at the same tolerances, where
    one-pass moments lose their bits; in float32 that slice's y is held on
    the kernel's own affine (its bits, as above): at |mean| / std = 1e3,
    float32's z * inv + shift cancels ten bits, so moments an ulp apart (the
    plain version's own sums against any other order's) move y by ~1e-5 of
    its largest value, and the error from the plain version's own moments is
    logged beside.  Logged too: the bytes a call moves and the standalone
    floor (forward: 2 reads + 1 write; backward: 4 reads + 1 write) beside
    the bound (the kernels line's: each input read once, each output written
    once)."""
    import torch

    from protnote_tpu_torch.ops import dense_scorer as ds

    dev = z.device
    f32 = z.dtype == torch.float32
    N, Hh = z.shape
    gen = torch.Generator().manual_seed(77)
    scale = (0.5 + torch.rand(Hh, generator=gen)).to(dev)
    bias = (0.2 * torch.randn(Hh, generator=gen)).to(dev)
    layer, rate, step = 0, DENSE_RATE, DENSE_PLAIN_COLS
    cols = range(0, Hh, step)
    off = Hh - step  # the offset slice (BN)
    saved = None
    with torch.no_grad():
        if bn:
            saved = z[:, off:].clone()
            z[:, off:] = (saved.float() + DENSE_OFFSET).to(z.dtype)
            fwd = lambda: ds._bn_relu_dropout_fwd_cuda(z, rows, n, scale, bias, seed,  # noqa: E731
                                                       layer, rate)
            out = fwd()
            stats = (out[1], *out[3:])  # mean, istd, inv, shift of the kernel
            bwd = lambda: ds._bn_relu_dropout_grads_cuda(  # noqa: E731
                z, dy, rows, n, scale, *stats, seed, layer, rate)
            pf = lambda j: ds._bn_relu_dropout_fwd_plain(  # noqa: E731
                z[:, j:j + step], rows, n, scale[j:j + step], bias[j:j + step], seed, layer,
                rate, j)
            pb = lambda j: ds._bn_relu_dropout_grads_plain(  # noqa: E731
                z[:, j:j + step], dy[:, j:j + step], rows, n, scale[j:j + step],
                *(t[j:j + step] for t in stats), seed, layer, rate, j)
            fwd_names, bwd_names = ("y", "mean", "var"), ("dz", "dscale", "dbias")
        else:
            fwd = lambda: (ds._bias_relu_dropout_fwd_cuda(z, bias, seed, layer, rate),)  # noqa: E731
            out = fwd()
            bwd = lambda: ds._bias_relu_dropout_grads_cuda(  # noqa: E731
                z, dy, bias, seed, layer, rate)
            pf = lambda j: (ds._bias_relu_dropout_fwd_plain(  # noqa: E731
                z[:, j:j + step], bias[j:j + step], seed, layer, rate, j),)
            pb = lambda j: ds._bias_relu_dropout_grads_plain(  # noqa: E731
                z[:, j:j + step], dy[:, j:j + step], bias[j:j + step], seed, layer, rate, j)
            fwd_names, bwd_names = ("y",), ("dz", "dbias")
        grads = bwd()
        deltas = {k: [] for k in fwd_names + bwd_names}
        for j in cols:
            sl = slice(j, j + step)
            tag = "_offset" if bn and j == off else ""
            for k, got, want in list(zip(fwd_names, out, pf(j))) + list(zip(bwd_names, grads,
                                                                            pb(j))):
                deltas.setdefault(k + tag, []).append(
                    delta(got[:, sl] if got.dim() == 2 else got[sl], want))
        y_own = None
        if bn and f32:  # the offset slice's y on the kernel's own affine
            deltas["y_offset_from_own_moments"] = deltas.pop("y_offset")
            deltas["y_offset"] = [delta(out[0][:, off:], ds._drop_plain(
                torch.relu(z[:, off:] * out[4][off:] + out[5][off:]), seed, layer, rate, off))]
            y_own = merge_deltas(deltas.pop("y_offset_from_own_moments"))[1]
        rel = {k: merge_deltas(v)[1] for k, v in deltas.items()}
        errs = {k: merge_deltas(v)[0] for k, v in deltas.items()}
        exact = None
        if f32:  # the mask and the kept values, bit for bit
            if bn:
                exact = sum(int((out[0][:, j:j + step] != ds._drop_plain(
                    torch.relu(z[:, j:j + step] * out[4][j:j + step] + out[5][j:j + step]),
                    seed, layer, rate, j)).sum()) for j in cols)
            else:
                exact = int(errs["y"] != 0.0) + int(errs["dz"] != 0.0)
        del out, grads
        if saved is not None:
            z[:, off:] = saved
            del saved
        fwd_ms, bwd_ms = cuda_time_ms(fwd, 3), cuda_time_ms(bwd, 3)
        plain_ms = cuda_time_ms(lambda: [pf(j) for j in cols])
        plain_bwd_ms = cuda_time_ms(lambda: [pb(j) for j in cols])
    nb = N * Hh * z.element_size()
    name = "bn_relu_dropout" if bn else "bias_relu_dropout"
    sums = {"mean", "var", "dscale", "dbias"}
    tol = {k: (depth_tol(N) if k.removesuffix("_offset") in sums else F32_REL_TOL) if f32
           else K45_REL_TOL for k in rel}
    # bytes a call moves: BN forward z twice + y, backward z, dy twice + dz;
    # the bias forms one pass each
    fwd_bytes, bwd_bytes = (3 * nb, 5 * nb) if bn else (2 * nb, 3 * nb)
    log(f"dense_{name}{'_f32' if f32 else ''}", rows=N, width=Hh, rate=rate, rel_errs=rel,
        rel_tol=tol, offset_spreads=DENSE_OFFSET if bn else None,
        y_offset_rel_err_from_own_moments=y_own, mismatched_bits=exact, fwd_ms=fwd_ms,
        bwd_ms=bwd_ms, plain_fwd_ms=plain_ms, plain_bwd_ms=plain_bwd_ms,
        fwd_bound_ms=bound(nbytes=2 * nb)["bound_ms"],
        bwd_bound_ms=bound(nbytes=3 * nb)["bound_ms"],
        fwd_gb_moved=fwd_bytes / 1e9, bwd_gb_moved=bwd_bytes / 1e9,
        fwd_floor_ms=bound(nbytes=3 * nb)["bound_ms"] if bn else None,
        bwd_floor_ms=bound(nbytes=5 * nb)["bound_ms"] if bn else None,
        fwd_share_of_floor=bound(nbytes=3 * nb)["bound_ms"] / fwd_ms if bn else None,
        bwd_share_of_floor=bound(nbytes=5 * nb)["bound_ms"] / bwd_ms if bn else None, card=card)
    if any(rel[k] > tol[k] for k in rel) or exact:
        raise AssertionError(f"{name} disagrees with its plain version: {rel}, mismatched "
                             f"bits {exact}")
    sfx = "_f32" if f32 else ""
    return {f"{name}_forward{sfx}": {"max_abs_err": errs["y"], "ms": fwd_ms, "plain_ms": plain_ms,
                                **bound(nbytes=2 * nb), "library_ms": None},
            f"{name}_backward{sfx}": {"max_abs_err": errs["dz"], "ms": bwd_ms,
                                 "plain_ms": plain_bwd_ms, **bound(nbytes=3 * nb),
                                 "library_ms": None}}


def phase_dense_kernels(card: str) -> dict:
    """Phase 24: the dense scorer's kernels alone at full width (32
    sequences x 32,102 labels, d 1024, H 3072) against their plain versions
    on the same device tensors: K5's centred BN + ReLU + dropout and the
    bias form, forward and backward (2^-6 of each tensor's largest |value|,
    in column slices), the keep mask the same bits as the plain hash; the
    first layer (``pair_first_add``: the same bits; ``pair_train_prod``:
    2^-6, and its time on a serving chunk); its backward (``pair_side_sums``
    1e-3, ``pair_train_dw_prod`` 2^-6, the weighted side sums of dJ 1e-3);
    each kernel's time, the plain version's, its bound and the library
    call's: ``torch.add`` into a bf16 out for the first add (the same bits),
    cuBLAS on the materialised prod rows; the side sums' partial rows'
    bytes and the floor with them."""
    import torch

    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import pair_scorer as ps

    dev = torch.device("cuda")
    Bq, L, d, Hh = TRAIN_B, NUM_LABELS, D_LATENT, H
    N = Bq * L
    gen = torch.Generator().manual_seed(71)
    seed = torch.tensor([1234567, 7654321], dtype=torch.int64, device=dev)
    times = {}
    z = (torch.randn(N, Hh, generator=gen, dtype=torch.float32).to(dev) + 0.3).to(torch.bfloat16)
    dy = torch.randn(N, Hh, generator=gen, dtype=torch.float32).to(dev).to(torch.bfloat16)
    em = torch.ones(Bq, device=dev)
    em[-1] = 0
    lm = (torch.rand(L, generator=gen) < 0.98).float().to(dev)
    rows = (em[:, None] * lm[None, :]).reshape(N, 1)
    n = rows.sum()
    for bn in (True, False):
        times.update(dense_act_check(card, bn, z, dy, rows, n, seed))
        torch.cuda.empty_cache()
    del z
    torch.cuda.empty_cache()

    # the keep mask, bit for bit: the bias form on z = 1 keeps bf16(1 / keep)
    # exactly where the hash keeps
    with torch.no_grad():
        ones = torch.ones(N, Hh, dtype=torch.bfloat16, device=dev)
        yk = ds._bias_relu_dropout_fwd_cuda(ones, torch.zeros(Hh, device=dev), seed, 1,
                                            DENSE_RATE)
        del ones
        wrong = kept = 0
        rix = torch.arange(N, device=dev)[:, None]
        for j in range(0, Hh, DENSE_PLAIN_COLS):
            m = ds.keep_mask(seed, 1, DENSE_RATE, rix,
                             torch.arange(j, j + DENSE_PLAIN_COLS, device=dev)[None, :])
            wrong += int(((yk[:, j:j + DENSE_PLAIN_COLS] != 0) != m).sum())
            kept += int(m.sum())
        del yk, m
    log("dense_keep_mask", elements=N * Hh, mismatches=wrong, keep_rate=kept / (N * Hh),
        rate=DENSE_RATE)
    if wrong:
        raise AssertionError(f"the kernels' keep mask differs from the hash in {wrong} places")
    torch.cuda.empty_cache()

    # the first layer and its backward
    a = torch.randn(Bq, Hh, generator=gen).to(dev)
    c = torch.randn(L, Hh, generator=gen).to(dev)
    P_e = torch.randn(Bq, d, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(L, d, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(d, Hh, generator=gen) * (2.0 / d) ** 0.5).to(dev, torch.bfloat16)
    chunk = 2048
    with torch.no_grad():
        z1 = ds._first_fwd_cuda(a, c, P_e, L_e, None).view(Bq, L, Hh)
        err = max(int((z1[:, l0:l0 + chunk] != (a[:, None] + c[None, l0:l0 + chunk])
                       .to(torch.bfloat16)).sum()) for l0 in range(0, L, chunk))
        add_ms = cuda_time_ms(lambda: ds._first_fwd_cuda(a, c, P_e, L_e, None), 3)
        add_plain_ms = cuda_time_ms(lambda: (a[:, None] + c[None]).to(torch.bfloat16))
        # one PyTorch call: the float32 sum rounded once into a bf16 out
        z_lib = torch.empty(Bq, L, Hh, dtype=torch.bfloat16, device=dev)
        torch.add(a[:, None], c[None], out=z_lib)
        lib_same = bool(torch.equal(z_lib, z1))
        add_lib_ms = cuda_time_ms(lambda: torch.add(a[:, None], c[None], out=z_lib), 3)
        del z1, z_lib
        log("dense_first_add", mismatched_elements=err, ms=add_ms, plain_ms=add_plain_ms,
            library_ms=add_lib_ms, library_same_bits=lib_same, card=card)
        if err or not lib_same:
            raise AssertionError(f"pair_first_add differs from bf16(a + c) in {err} places "
                                 f"(torch.add into bf16 the same bits: {lib_same})")
        times["pair_first_add"] = {"max_abs_err": 0.0, "ms": add_ms, "plain_ms": add_plain_ms,
                                   **bound(nbytes=N * Hh * 2 + (Bq + L) * Hh * 4),
                                   "library_ms": add_lib_ms}

        zp = ds.pair_prod_cuda(a, c, P_e, L_e, w).view(Bq, L, Hh)

        def prod_plain(l0, l1):
            prod = (P_e[:, None] * L_e[None, l0:l1]).reshape(-1, d)
            pre = (a[:, None] + c[None, l0:l1]).reshape(-1, Hh) + prod.float() @ w.float()
            return pre.to(torch.bfloat16).view(Bq, -1, Hh)

        p_err = p_big = 0.0
        for l0 in range(0, L, chunk):
            want = prod_plain(l0, min(l0 + chunk, L)).float()
            p_err = max(p_err, float((zp[:, l0:l0 + chunk].float() - want).abs().max()))
            p_big = max(p_big, float(want.abs().max()))
        del zp
        prod_ms = cuda_time_ms(lambda: ds.pair_prod_cuda(a, c, P_e, L_e, w), 3)
        prod_plain_ms = cuda_time_ms(lambda: [prod_plain(l0, min(l0 + chunk, L))
                                          for l0 in range(0, L, chunk)])
        rows_p = (P_e[:, None] * L_e[None]).reshape(N, d)
        lib_ms = cuda_time_ms(lambda: rows_p @ w, 3)
        # K1's serving form: a chunk of the serving plan, ReLU'd into its
        # padded rows (phase 27 runs it once a chunk)
        sch = ps.launch_plan(Bq, L * K_DESCRIPTIONS, Hh, 2).chunks[0]
        s_out = torch.empty(Bq * sch.nl_pad, Hh, dtype=torch.bfloat16, device=dev)
        s_c, s_le, s_wt = c[:sch.nl], L_e[:sch.nl], w.t().contiguous()
        serve_ms = cuda_time_ms(lambda: ds.pair_prod_cuda(
            a, s_c, P_e, s_le, w, relu=True, out=s_out, rows_per_seq=sch.nl_pad, wt=s_wt), 10)
        del s_out
    flop = 2.0 * N * d * Hh
    serve_bound = bound(ops=2.0 * Bq * sch.nl_pad * d * Hh)["bound_ms"]
    log("dense_prod_first_layer", rel_err=p_err / p_big, rel_tol=K45_REL_TOL, ms=prod_ms,
        plain_ms=prod_plain_ms, cublas_prod_ms=lib_ms, tflops=flop / prod_ms / 1e9,
        serving_chunk_rows=Bq * sch.nl_pad, serving_chunk_ms=serve_ms,
        serving_chunk_bound_ms=serve_bound, card=card)
    if p_err > K45_REL_TOL * p_big:
        raise AssertionError(f"pair_train_prod disagrees with its plain version: {p_err}")
    times["pair_train_prod"] = {"max_abs_err": p_err, "ms": prod_ms, "plain_ms": prod_plain_ms,
                                **bound(nbytes=N * Hh * 2, ops=flop), "library_ms": lib_ms,
                                "serving_chunk_ms": serve_ms,
                                "serving_chunk_bound_ms": serve_bound}

    with torch.no_grad():
        dz = dy
        sb, sl = ds.side_sums_cuda(dz, Bq, L)
        sb2, sl2 = ds.side_sums_cuda(dz, Bq, L)
        same = bool(torch.equal(sb, sb2) and torch.equal(sl, sl2))
        del sb2, sl2
        dz3 = dz.view(Bq, L, Hh)
        want_b = torch.stack([dz3[b].float().sum(0) for b in range(Bq)])
        want_l = torch.zeros(L, Hh, device=dev)
        for b in range(Bq):
            want_l += dz3[b].float()
        s_rel = max(rel_err(sb, want_b), rel_err(sl, want_l))
        s_abs = max(float((sb - want_b).abs().max()), float((sl - want_l).abs().max()))
        del want_l
        side_ms = cuda_time_ms(lambda: ds.side_sums_cuda(dz, Bq, L), 3)
        side_plain_ms = cuda_time_ms(lambda: (dz3.float().sum(1), dz3.float().sum(0)))
        dw = ds.dw_prod_cuda(P_e, L_e, dz)
        want_w = torch.zeros(d, Hh, device=dev)
        for l0 in range(0, L, chunk):
            pr = (P_e[:, None] * L_e[None, l0:l0 + chunk]).reshape(-1, d)
            want_w += pr.float().t() @ dz3[:, l0:l0 + chunk].reshape(-1, Hh).float()
        w_rel = rel_err(dw, want_w)
        w_abs = float((dw.float() - want_w).abs().max())
        dw_ms = cuda_time_ms(lambda: ds.dw_prod_cuda(P_e, L_e, dz), 3)
        dw_plain_ms = cuda_time_ms(lambda: [(P_e[:, None] * L_e[None, l0:l0 + chunk])
                                        .reshape(-1, d).float().t() @
                                        dz3[:, l0:l0 + chunk].reshape(-1, Hh).float()
                                        for l0 in range(0, L, chunk)])
        dw_lib_ms = cuda_time_ms(lambda: rows_p.t() @ dz, 3)
        dJ = dz @ w.t()
        wb, wl = ds.side_sums_cuda(dJ, Bq, L, u=P_e, v=L_e)
        dJ3 = dJ.view(Bq, L, d)
        want_b = torch.stack([(dJ3[b].float() * L_e.float()).sum(0) for b in range(Bq)])
        want_l = torch.zeros(L, d, device=dev)
        for b in range(Bq):
            want_l += dJ3[b].float() * P_e[b].float()
        ws_rel = max(rel_err(wb, want_b), rel_err(wl, want_l))
        del dJ, dJ3, want_l, rows_p
    side_bytes = N * Hh * 2 + (Bq + L) * Hh * 4
    part_bytes = side_partial_bytes(Bq, L, Hh)
    log("dense_first_backward", side_sums_rel_err=s_rel, side_sums_same_bits=same,
        dw_prod_rel_err=w_rel, weighted_side_sums_rel_err=ws_rel, side_sums_ms=side_ms,
        side_sums_plain_ms=side_plain_ms, side_sums_partial_bytes=part_bytes,
        side_sums_floor_ms=bound(nbytes=side_bytes + part_bytes)["bound_ms"], dw_prod_ms=dw_ms,
        dw_prod_plain_ms=dw_plain_ms, cublas_dw_ms=dw_lib_ms, dw_tflops=flop / dw_ms / 1e9,
        card=card)
    if not (s_rel <= K7_SUMS_REL_TOL and ws_rel <= K7_SUMS_REL_TOL and w_rel <= K45_REL_TOL
            and same):
        raise AssertionError(f"the first layer's backward disagrees: side sums {s_rel}, "
                             f"weighted {ws_rel}, dW_prod {w_rel}, same bits {same}")
    times["pair_side_sums"] = {"max_abs_err": s_abs, "ms": side_ms, "plain_ms": side_plain_ms,
                               **bound(nbytes=side_bytes), "library_ms": None,
                               "partial_bytes": part_bytes,
                               "floor_ms": bound(nbytes=side_bytes + part_bytes)["bound_ms"]}
    times["pair_train_dw_prod"] = {"max_abs_err": w_abs, "ms": dw_ms, "plain_ms": dw_plain_ms,
                                   **bound(nbytes=N * Hh * 2, ops=flop), "library_ms": dw_lib_ms}
    del dy, dz, dz3
    torch.cuda.empty_cache()
    times.update(dense_k1_check(card))
    return times


def side_partial_bytes(B: int, L: int, K: int) -> int:
    """The bytes of ``pair_side_sums``'s partial sb rows (chunks x B x K
    float32), written and read once: its design's floor beyond the bound."""
    from protnote_tpu_torch.ops import dense_scorer as ds

    chunks, _ = ds.side_sums_plan(L)
    return 2 * chunks * B * K * 4


def plain_head(a, c, w_out):
    """The one-layer head's plain version: ``bf16(relu(a[b] + c[l])) . w_out``
    in float32, (B, L) without b_out, in label tiles."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    out = torch.empty(a.shape[0], c.shape[0], dtype=torch.float32, device=a.device)
    for l0 in range(0, c.shape[0], LABEL_TILE):
        h = torch.relu(a[:, None] + c[None, l0:l0 + LABEL_TILE]).to(torch.bfloat16)
        out[:, l0:l0 + h.shape[1]] = ps._f32_product(h, w_out[:, None], torch.bfloat16)[..., 0]
    return out


def dense_k1_check(card: str) -> dict:
    """K1's two new forms at full serving width (32 sequences x 64,204 label
    rows): ``w1_prod`` (``pair_train_prod``'s ReLU'd first layer, then the
    two hidden layers) and no hidden layer (``pair_mlp_head``), each against
    the plain scorer: logits to 5e-2; the head also alone against
    :func:`plain_head` on the same a and c."""
    import torch

    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import pair_scorer as ps

    gen = torch.Generator().manual_seed(72)
    dev = torch.device("cuda")
    P_e = torch.randn(B, D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT, generator=gen).to(dev,
                                                                               torch.bfloat16)
    Lr = L_e.shape[0]
    out = {}
    for form, n_hidden, prod in (("prod", 2, True), ("one_layer", 0, False),
                                 ("one_layer_prod", 0, True)):
        folded = random_folded(gen, D_LATENT, H, n_hidden, dev)
        if prod:
            folded.w1_prod = ((torch.rand(D_LATENT, H, generator=gen) * 2 - 1) *
                              (6.0 / (3 * D_LATENT)) ** 0.5).to(dev, torch.bfloat16)
        with torch.inference_mode():
            got = ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE)
            want = ps.pair_logits_tiled_reference(folded, P_e, L_e, LABEL_TILE)
            err = float((got - want).abs().max())
            ms = cuda_time_ms(lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE), 2)
            plain_ms = cuda_time_ms(lambda: ps.pair_logits_tiled_reference(folded, P_e, L_e,
                                                                       LABEL_TILE))
            if form == "one_layer":  # the head alone, kernel and plain, on one call's a, c
                kern = ps._K1Kernel(folded, P_e, L_e, torch.bfloat16)
                logits = kern.new_logits()
                kern.head(logits)
                head_want = plain_head(kern.a, kern.c, kern.w_out) + folded.b_out
                head_err = float((logits - head_want).abs().max())
                head_ms = cuda_time_ms(lambda: kern.head(logits), 3)
                head_plain_ms = cuda_time_ms(lambda: plain_head(kern.a, kern.c, kern.w_out))
                del kern, logits, head_want
        flop = 2.0 * B * Lr * (D_LATENT * H * prod + n_hidden * H * H)
        log(f"dense_k1_{form}", max_abs_logit_err=err, logit_atol=LOGIT_ATOL,
            logit_std=float(want.std()), ms=ms, plain_ms=plain_ms,
            tflops=flop / ms / 1e9 if flop else None,
            launches_a_call=len(ps.launch_plan(B, Lr, H, max(n_hidden, 1)).chunks), card=card)
        if not (bool(torch.isfinite(got).all()) and err <= LOGIT_ATOL):
            raise AssertionError(f"K1 {form} disagrees with the plain scorer: {err}")
        if form == "one_layer":
            # reads a, c and w_out and writes the logits; a + c and the
            # multiply-add are 3 float32 operations a pair and column
            log("dense_k1_head", max_abs_logit_err=head_err, ms=head_ms,
                plain_ms=head_plain_ms, card=card)
            if head_err > LOGIT_ATOL:
                raise AssertionError(f"pair_mlp_head disagrees with the plain head: {head_err}")
            out["pair_mlp_head"] = {
                "max_abs_err": head_err, "ms": head_ms, "plain_ms": head_plain_ms,
                **bound(nbytes=(B + Lr) * H * 4 + H * 2 + B * Lr * 4, ops=3.0 * B * Lr * H,
                        peak=F32_FLOPS),
                "library_ms": None}
        del got, want, folded
        torch.cuda.empty_cache()
    return out


def dense_models(**params):
    """Full-width configs as :func:`random_models` with config keys
    ``params`` (FEATURE_FUSION, OUTPUT_MLP_BATCHNORM, OUTPUT_MLP_NUM_LAYERS,
    PAIR_BACKEND, OUTPUT_MLP_DROPOUT, GRADIENT_CHECKPOINTING) and seeded
    random weights, the ProtNote linears He-scaled."""
    import torch

    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer

    pi_cfg = ProteInferConfig(compute_dtype=torch.bfloat16)
    pn_cfg = ProtNoteConfig.from_params(
        params, protein_embedding_dim=pi_cfg.output_channels, label_embedding_dim=D_LATENT,
        inference_descriptions_per_label=K_DESCRIPTIONS, label_tile=LABEL_TILE,
        compute_dtype=torch.bfloat16)
    pi_params, pi_state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_params, pn_state = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    he_scale_linears(pn_params)
    return pi_cfg, pn_cfg, {"trainable": {"protnote": pn_params}, "model_state": pn_state,
                            "enc_params": pi_params, "enc_state": pi_state}


def reset_dense_launches() -> None:
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st

    for counts in (ds.LAUNCHES, st.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ps.LAUNCHES = ps.HEAD_LAUNCHES = 0


def dense_launch_counts() -> dict:
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st

    return {**ds.LAUNCHES, "pair_mlp_layer": ps.LAUNCHES, "pair_mlp_head": ps.HEAD_LAUNCHES,
            **{k: v for k, v in st.LAUNCHES.items() if v}}


DENSE_SETTINGS = (
    ("dense_dropout", {}),
    ("prod", {"FEATURE_FUSION": "concatenation_prod"}),
    ("no_bn", {"OUTPUT_MLP_BATCHNORM": False}),
    ("remat", {"GRADIENT_CHECKPOINTING": True}),
)


def phase_dense_training(card: str) -> dict:
    """Phase 25: ``Trainer.train`` through the materialised dense scorer at
    full width (32 sequences a step against all 32,102 labels), one epoch of
    ``DENSE_STEPS`` steps for each setting of ``DENSE_SETTINGS``, each with
    ``PAIR_BACKEND dense`` and ``OUTPUT_MLP_DROPOUT`` 0.1: the per-step
    losses (finite), median warm step ms, seqs/s, peak memory, the launches
    (each the schedule's, ``dense_launches`` a step; none of K4, K5 or K6),
    and a ``torch.profiler`` pass of two steps (idle share, device ms a step
    by kernel).  Returns the launches summed over the settings."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.data.dataset import DatasetConfig
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    types = ("name", "label")
    cfg = DatasetConfig(dataset_type="train", label_augmentation_descriptions=types,
                        inference_go_descriptions=types,
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_ds = fasta_dataset(tmp, "dense.fasta", TRAIN_B * (DENSE_STEPS + 2), 23, cfg)

        def batcher(seed=42):
            return BucketBatcher(train_ds, TRAIN_B, buckets=(256, 512, 1024), shuffle=True,
                                 drop_last=True, seed=seed, device_label_gather=True)

        for name, extra in DENSE_SETTINGS:
            params = {"PAIR_BACKEND": "dense", "OUTPUT_MLP_DROPOUT": DENSE_RATE, **extra}
            pi_cfg, pn_cfg, ts = dense_models(**params)
            opt = Optimizer(TRAIN_PARAMS)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt)
            trainer = Trainer(ts0, pi_cfg, pn_cfg, TrainerConfig(
                num_epochs=1, decision_threshold=THRESHOLD), device=dev,
                loss_fn=get_loss_fn(TRAIN_PARAMS), optimizer=opt)
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, batch, gen, steps=steps, step_fn=step_fn):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, batch, gen)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]),
                              float(m["grad_norm"])))
                return ts_, m

            trainer._train_step = timed_step
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_dense_launches()
            b = batcher()
            trainer.train(b, None)
            torch.cuda.synchronize()
            launches = dense_launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            trainer._train_step = step_fn
            losses = [x[1] for x in steps]
            per_step = ds.dense_launches(
                pn_cfg.output_mlp_num_layers, True, pn_cfg.output_mlp_batchnorm,
                pn_cfg.feature_fusion == "concatenation_prod",
                remat=pn_cfg.gradient_checkpointing)
            want = {k: v * len(steps) for k, v in per_step.items()}
            got = {k: launches[k] for k in want}
            others = {k: v for k, v in launches.items() if k not in want and v}
            if not steps or not all(math.isfinite(x) for x in losses) or got != want or \
                    others or not any(v for v in got.values()):
                raise AssertionError(f"dense training {name}: losses {losses}, launches {got} "
                                     f"(schedule {want}), others {others}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            # two profiled steps on batches of the same data
            placed = []
            matrix = trainer._label_matrix_for(train_ds)
            for batch in batcher(seed=7):
                placed.append(trainer._place(batch_to_device_dict(batch, dev), matrix))
                if len(placed) == 2:
                    break
            gen = torch.Generator(device=dev).manual_seed(1)
            it = iter(placed)

            def one_step(trainer=trainer, it=it, gen=gen, step_fn=step_fn):
                trainer.ts, _ = step_fn(trainer.ts, next(it), gen)

            wall, busy, top = device_profile(one_step, len(placed))
            log(f"dense_train_{name}", settings=params, sequences_per_step=TRAIN_B,
                labels=NUM_LABELS, steps=len(steps), step_losses=losses,
                grad_norms=[x[2] for x in steps], first_step_ms=steps[0][0] * 1e3,
                median_warm_step_ms=med * 1e3, seqs_per_s=TRAIN_B / med, peak_mem_gb=peak,
                launches=got, profiled_wall_ms_per_step=wall * 1e3 / len(placed),
                device_busy_ms_per_step=None if busy is None else busy * 1e3 / len(placed),
                idle_share=None if busy is None else 1.0 - busy / wall,
                top_kernels_ms_per_step=top, card=card)
            del trainer, ts0, ts, placed, it, one_step
            torch.cuda.empty_cache()
    return total


def phase_dense_eval(card: str) -> dict:
    """Phase 26: ``Trainer.evaluate`` with ``PAIR_BACKEND dense`` on phase
    7's 256-sequence FASTA: the materialised chain in label chunks (the
    first layer through ``pair_first_add``, eval BN + ReLU through K6's
    ``affine_relu``, the hidden products and the head in ``torch.matmul``),
    then K3.  Its seqs/s (a second, warm pass), launches and finite metrics;
    the first batch's logits against the same eval step with the plain dense
    scorer (5e-2)."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from protnote_tpu_torch.models import fusion
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        data = eval_dataset(tmp)
        batcher = eval_batcher(data)
    pi_cfg, pn_cfg, ts = dense_models(PAIR_BACKEND="dense")
    trainer = Trainer(ts, pi_cfg, pn_cfg,
                      TrainerConfig(decision_threshold=THRESHOLD, estimate_map=True),
                      device="cuda")
    trainer.evaluate(batcher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_dense_launches()
    for k in k3.LAUNCHES:
        k3.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    metrics = trainer.evaluate(batcher)["metrics"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {**{k: v for k, v in dense_launch_counts().items() if v},
                "affine_relu": st.LAUNCHES["affine_relu"],
                **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}}
    if not (launches.get("pair_first_add", 0) > 0 and launches["affine_relu"] > 0 and
            launches["eval_acc_update"] > 0 and not launches.get("pair_mlp_layer")):
        raise AssertionError(f"dense evaluation skipped a kernel: {launches}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"dense evaluation: non-finite metrics {metrics}")
    batch = next(iter(batcher))
    matrix = trainer._label_matrix_for(data)
    arrays = trainer._place(batch_to_device_dict(batch, trainer.device), matrix)
    arrays = trainer._swap_in_latents(arrays, trainer._label_latents(arrays))
    got = trainer._eval_step(trainer.ts, arrays)["logits"]
    with mock.patch.object(fusion, "pair_logits_dense", ds.pair_logits_dense_reference):
        want = trainer._eval_step(trainer.ts, arrays)["logits"]
    err = float((got - want).abs().max())
    log("dense_eval", sequences=len(data), seconds=sec, seqs_per_s=len(data) / sec,
        batch_ms=sec * 1e3 / len(batcher), chunk_rows=ds.EVAL_CHUNK_ROWS, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, max_abs_logit_err=err,
        logit_atol=LOGIT_ATOL, logit_std=float(want.std()), metrics=metrics, card=card)
    if not (bool(torch.isfinite(got).all()) and err <= LOGIT_ATOL):
        raise AssertionError(f"dense evaluation disagrees with the plain dense scorer: {err}")
    return {k: v for k, v in launches.items() if k in DENSE_KERNELS}


# phase 27's forms: (name, settings, the kernels each must launch)
DENSE_SERVING = (
    ("prod", {"FEATURE_FUSION": "concatenation_prod"}, ("pair_train_prod", "pair_mlp_layer")),
    ("one_layer", {"OUTPUT_MLP_NUM_LAYERS": 1}, ("pair_mlp_head",)),
)


def phase_dense_serving(card: str) -> dict:
    """Phase 27: ``ServingEngine`` with ``FEATURE_FUSION concatenation_prod``
    (K1's prod form: ``pair_train_prod`` a chunk, then the hidden layers)
    and with ``OUTPUT_MLP_NUM_LAYERS 1`` (``pair_mlp_head``): scores against
    the plain forward (probabilities 1e-2, as phase 5), then three full
    batches of 32 sequences (one bucket) timed, with their launches: the
    first-layer launch once a label chunk of each batch."""
    import numpy as np
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(9)
    matrix = random_label_matrix()
    vocab = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    total = {}
    for name, params, needed in DENSE_SERVING:
        pi_cfg, pn_cfg, ts = dense_models(**params)
        engine = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, buckets=(512, 1024),
                               max_batch=B, device="cuda")
        seqs, _ = phase_parity(engine, rng, name=f"dense_serving_{name}_parity")
        full = random_sequences(rng, rng.integers(100, 500, B))  # one batch, bucket 512
        engine.score(full)
        torch.cuda.synchronize()
        reset_dense_launches()
        t0 = time.perf_counter()
        for _ in range(3):
            probs = engine.score(full)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        launches = {k: v for k, v in dense_launch_counts().items() if v}
        # the prod layer once a label chunk; the one-layer head once a batch
        chunks = len(ps.launch_plan(B, NUM_LABELS * K_DESCRIPTIONS, H, 1).chunks)
        first = launches.get("pair_train_prod" if name == "prod" else "pair_mlp_head", 0)
        if not np.isfinite(probs).all() or any(launches.get(k, 0) <= 0 for k in needed) or \
                first != 3 * (chunks if name == "prod" else 1):
            raise AssertionError(f"dense serving {name}: launches {launches}, {chunks} chunks "
                                 "a batch")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(f"dense_serving_{name}", settings=params, batch=B, labels=NUM_LABELS,
            label_rows=NUM_LABELS * K_DESCRIPTIONS, batch_ms=ms, seqs_per_s=B * 1e3 / ms,
            launches_3_batches=launches, card=card)
        del engine, ts
        torch.cuda.empty_cache()
    return total


# float32 inference on the card (MIXED_PRECISION False): K1 in float32
# (csrc/pair_scorer_f32.cu), its prod form, the float32 head and K2's
# float32 form, each within F32_REL_TOL of its plain float32 version's
# largest |logit| (the split product leaves out terms below 2^-24 of each
# product; the rest is float32 summation in other orders); then serving,
# evaluation and predict end to end in float32 on F32_SEQUENCES sequences
F32_REL_TOL = 1e-5
SPLIT_FLOPS = BF16_FLOPS / 6  # six bf16 products a float32 product (bf16x3)
F32_SEQUENCES = 64
F32_FORMS = ("pair_mlp_layer_f32", "pair_mlp_layer_f32_prod", "pair_mlp_head_f32",
             "pair_int8_layer_f32", "pair_int8_layer_f32_dynamic")


def random_folded_f32(gen, n_hidden: int, prod: bool, device):
    """:func:`random_folded`'s He-uniform scales in float32 (no bf16
    rounding: every weight uses float32's bits), with a float32 w1_prod."""
    import torch

    from protnote_tpu_torch.ops.pair_scorer import FoldedOutputMLP

    def u(shape, fan_in):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * (6.0 / fan_in) ** 0.5).to(device)

    d = D_LATENT
    return FoldedOutputMLP(
        w1_p=u((d, H), 2 * d), w1_l=u((d, H), 2 * d), b1=0.1 * u((H,), 2 * d),
        w1_prod=u((d, H), 3 * d) if prod else None,
        hidden=[(u((H, H), H), 0.1 * u((H,), H)) for _ in range(n_hidden)],
        w_out=u((H,), H), b_out=torch.tensor(-0.5, device=device))


def event_ms(fn):
    """``(fn(), ms)``: one call timed by CUDA events (after an earlier call)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def f32_close(name: str, got, want) -> dict:
    """Raise unless ``got`` is finite and within F32_REL_TOL of ``want``'s
    largest |value|; the error and the scale."""
    import torch

    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= F32_REL_TOL * scale):
        raise AssertionError(f"{name} disagrees with its plain float32 version: {err} against "
                             f"{F32_REL_TOL} x {scale}")
    return {"max_abs_err": err, "max_abs_value": scale, "rel_err": err / scale}


def bf16_launches() -> tuple:
    from protnote_tpu_torch.ops import pair_scorer as ps

    return ps.LAUNCHES, ps.HEAD_LAUNCHES, ps.INT8_LAUNCHES["pair_int8_layer"]


def plain_head_f32(a, c, w_out):
    """The float32 head's plain version: ``relu(a[b] + c[l]) . w_out`` in
    float32 (TF32 off), (B, L) without b_out, in label tiles."""
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision

    gemm_precision(torch.float32)
    out = torch.empty(a.shape[0], c.shape[0], dtype=torch.float32, device=a.device)
    for l0 in range(0, c.shape[0], LABEL_TILE):
        h = torch.relu(a[:, None] + c[None, l0:l0 + LABEL_TILE])
        out[:, l0:l0 + h.shape[1]] = h @ w_out
    return out


def f32_layer_errors(folded, P_e, L_e) -> dict:
    """The split's error a layer on the plan's first chunk (8,192 rows): the
    prod layer's and the first hidden layer's float32 outputs from one
    launch each, against the plain float32 layer on the same rows, within
    F32_REL_TOL of its largest |value|."""
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import pair_scorer as ps

    gemm_precision(torch.float32)
    k = ps._K1Kernel(folded, P_e, L_e, torch.float32)
    ch = k.plan.chunks[0]
    rows = B * ch.nl_pad
    a, c = k.a, k.c[ch.l0:ch.l0 + ch.nl_pad]
    pre = (a[:, None] + c[None]).reshape(rows, H)
    out = {}
    with torch.cuda.device(k.device):
        if k.prod:
            k.first_prod(ch)
            prod = (P_e[:, None] * L_e[None, ch.l0:ch.l0 + ch.nl_pad]).reshape(rows, -1)
            x = torch.relu(pre + prod @ folded.w1_prod)
            out["prod_layer"] = f32_close("the prod layer", k.work[0][:rows], x)
        else:
            x = torch.relu(pre)
        i, mode = k.modes()[0]
        stored = ps.k1_workspaces(i, mode & ~2, k.prod)[1]
        k.launch(ch, i, mode & ~2, None)  # the first hidden layer, stored
        torch.cuda.synchronize()
        W, b = folded.hidden[0]
        out["hidden_layer_1"] = f32_close("the first hidden layer", k.work[stored][:rows],
                                          torch.relu(x @ W + b))
    del k
    return out


def phase_f32_kernels(card: str, k2: dict) -> dict:
    """Phase 28: K1 in float32 at the full serving width (32 sequences x
    64,204 label rows, d 1024, H 3072, two hidden layers; float32 weights
    and inputs), its prod form and its one-layer head, and K2's float32
    form (static and dynamic scales), each against its plain float32
    version (``pair_logits_tiled_reference`` / ``_int8_reference`` at
    ``compute_dtype`` float32, cuBLAS with TF32 off) within F32_REL_TOL of
    the largest |logit|; the split's error a layer on one chunk; times by
    CUDA events beside the bound at the split's rate (989 / 6 TFLOP/s) and
    at the FMA pipe's 67, the plain version's, and ``gemm_ms``: cuBLAS
    float32 on the two bare H x H products of one 8,192-row chunk times the
    call's chunks (a yardstick, not the same function).  No bf16 K1 or K2
    layer launches."""
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import pair_scorer as ps

    gen = torch.Generator().manual_seed(220)
    dev = torch.device("cuda")
    f32 = torch.float32
    P_e = torch.randn(B, D_LATENT, generator=gen).to(dev)
    L_e = torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT, generator=gen).to(dev)
    Lr = L_e.shape[0]
    before = bf16_launches()
    out = {}
    with torch.inference_mode():
        for form, prod in (("pair_mlp_layer_f32", False), ("pair_mlp_layer_f32_prod", True)):
            folded = random_folded_f32(gen, 2, prod, dev)
            ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE, f32)
            got, ms = event_ms(lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e, LABEL_TILE,
                                                                 f32))
            want, plain_ms = event_ms(lambda: ps.pair_logits_tiled_reference(
                folded, P_e, L_e, LABEL_TILE, f32))
            close = f32_close(form, got, want)
            layers = f32_layer_errors(folded, P_e, L_e)
            flop = 2.0 * B * Lr * (2 * H * H + (D_LATENT * H if prod else 0))
            fields = {"ms": ms, "plain_ms": plain_ms, **bound(ops=flop, peak=SPLIT_FLOPS),
                      "library_ms": None}
            extra = {"bound_fma_ms": flop / F32_FLOPS * 1e3, "tflops": flop / ms / 1e9}
            if not prod:
                plan = ps.launch_plan(B, Lr, H, 2)
                x = torch.rand(plan.workspace_rows, H, generator=gen).to(dev)
                gemm_precision(f32)
                Ws = [W for W, _ in folded.hidden]
                chunk_ms = cuda_time_ms(lambda: [x @ W for W in Ws], 3)
                extra.update(gemm_chunk_ms=chunk_ms, gemm_ms=chunk_ms * len(plan.chunks),
                             chunks=len(plan.chunks))
                del x
                two_hidden = folded
            out[form] = {**fields, "max_abs_err": close["max_abs_err"]}
            log(f"f32_{form}", **close, **fields, **extra, split_error_by_layer=layers,
                logit_std=float(want.std()), rel_tol=F32_REL_TOL, card=card)
            del got, want
            torch.cuda.empty_cache()
        # the one-layer head: the call, then the head alone on its a and c
        head = random_folded_f32(gen, 0, False, dev)
        got = ps.pair_logits_tiled_cuda(head, P_e, L_e, LABEL_TILE, f32)
        want = ps.pair_logits_tiled_reference(head, P_e, L_e, LABEL_TILE, f32)
        call = f32_close("the float32 one-layer scorer", got, want)
        kern = ps._K1Kernel(head, P_e, L_e, f32)
        logits = kern.new_logits()
        kern.head(logits)
        head_want = plain_head_f32(kern.a, kern.c, kern.w_out) + head.b_out
        alone = f32_close("pair_mlp_head_f32", logits, head_want)
        head_ms = cuda_time_ms(lambda: kern.head(logits), 3)
        head_plain_ms = cuda_time_ms(lambda: plain_head_f32(kern.a, kern.c, kern.w_out))
        nbytes = (B + Lr) * H * 4 + H * 4 + B * Lr * 4
        out["pair_mlp_head_f32"] = {
            "max_abs_err": alone["max_abs_err"], "ms": head_ms, "plain_ms": head_plain_ms,
            **bound(nbytes=nbytes, ops=3.0 * B * Lr * H, peak=F32_FLOPS), "library_ms": None}
        log("f32_pair_mlp_head_f32", call=call, alone=alone, **out["pair_mlp_head_f32"],
            bytes=nbytes, card=card)
        del kern, logits, head_want, got, want
        # K2's float32 form on the two-hidden-layer weights of K1's check
        for form, static in (("pair_int8_layer_f32", True), ("pair_int8_layer_f32_dynamic", False)):
            scales = ps.calibrate_act_scales(two_hidden, P_e, L_e) if static else None
            q = ps.quantize_folded(two_hidden, act_scales=scales)
            got = ps.pair_logits_tiled_int8_cuda(q, P_e, L_e, LABEL_TILE, f32)
            want, plain_ms = event_ms(lambda: ps.pair_logits_tiled_int8_reference(
                q, P_e, L_e, LABEL_TILE, f32))
            close = f32_close(form, got, want)
            ms = cuda_time_ms(lambda: ps.pair_logits_tiled_int8_cuda(q, P_e, L_e, LABEL_TILE,
                                                                     f32), 3)
            out[form] = {"max_abs_err": close["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
                         **bound(ops=2.0 * 2 * H * H * B * Lr, peak=INT8_OPS),
                         "library_ms": k2["pair_int8_layer"]["library_ms"]}
            log(f"f32_{form}", **close, **{k: v for k, v in out[form].items() if k not in close},
                scales=scales,
                bf16_form_ms=k2["pair_int8_layer"]["ms"] if static else None, card=card)
            del got, want, q
    if bf16_launches() != before:
        raise AssertionError(f"a float32 call launched a bf16 K1 or K2 layer: {before} -> "
                             f"{bf16_launches()}")
    return out


def f32_models(**params):
    """Full-width configs with ``MIXED_PRECISION False`` and config keys
    ``params``: the encoder and the scorer in float32 (ProteInfer 1100
    channels x 5 blocks, latent 1024, output MLP 3 x 3072), seeded random
    weights, the ProtNote linears He-scaled."""
    import torch

    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer

    pi_cfg = ProteInferConfig()
    pn_cfg = ProtNoteConfig.from_params(
        params, protein_embedding_dim=pi_cfg.output_channels, label_embedding_dim=D_LATENT,
        inference_descriptions_per_label=K_DESCRIPTIONS, label_tile=LABEL_TILE,
        compute_dtype=torch.float32)
    pi_params, pi_state = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_params, pn_state = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    he_scale_linears(pn_params)
    return pi_cfg, pn_cfg, {"trainable": {"protnote": pn_params}, "model_state": pn_state,
                            "enc_params": pi_params, "enc_state": pi_state}


def reset_f32_path_counts() -> None:
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import threshold_sweep as k9

    for counts in (ps.F32_LAUNCHES, k3.LAUNCHES, k9.LAUNCHES):
        for k in counts:
            counts[k] = 0
    ps.LAUNCHES = ps.HEAD_LAUNCHES = 0
    reset_int8_launches()
    reset_k7_launches()


def f32_serving(rng, card: str) -> dict:
    """Float32 serving: a full-width engine behind the HTTP front end, two
    full batches, a ``/v1/reload`` of its own weights (the same bits, the
    probabilities within two float16 steps), its probabilities against the
    plain float32 chain; then one batch with ``concatenation_prod`` and one
    with ``OUTPUT_MLP_NUM_LAYERS 1``."""
    import tempfile
    import threading

    import numpy as np
    import torch

    from protnote_tpu_torch.cli.serve import make_reload_fn
    from protnote_tpu_torch.core.checkpoint import save_checkpoint
    from protnote_tpu_torch.models.convert import to_jax_tree
    from protnote_tpu_torch.serving import ServingEngine, make_http_server
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    matrix = random_label_matrix()
    vocab = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    pi_cfg, pn_cfg, ts = f32_models()
    t0 = time.perf_counter()
    engine = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, buckets=(512, 1024),
                           max_batch=B, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if engine.latents.dtype != torch.float32:
        raise AssertionError(f"float32 serving's label latents are {engine.latents.dtype}")
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "engine.ckpt")
    save_checkpoint(ckpt, to_jax_tree(engine.ts), epoch=0)
    trainer = Trainer(engine.ts, engine.pi_cfg, engine.pn_cfg, TrainerConfig(), device="cuda")
    server, batcher = make_http_server(engine, port=0, host="127.0.0.1",
                                       reload_fn=make_reload_fn(engine, trainer))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    small = random_sequences(rng, [120, 333, 480, 77])
    try:
        batch_ms = []
        for _ in range(2):  # two full batches of one bucket
            seqs = random_sequences(rng, rng.integers(100, 500, B))
            body, ms = post(url + "/v1/predict", {"sequences": seqs, "top_k": 10})
            batch_ms.append(ms)
            probs = np.array([p for row in body["predictions"] for _, p in row])
            if len(body["predictions"]) != B or not np.isfinite(probs).all():
                raise AssertionError("float32 serving: top-k wrong")
        before = engine.score(small)
        old = named_tensors(engine.ts)
        t0 = time.perf_counter()
        reload_body, _ = post(url + "/v1/reload", {"model_file": ckpt})
        reload_s = time.perf_counter() - t0
        after = engine.score(small)
        new = named_tensors(engine.ts)
        same_bits = old.keys() == new.keys() and all(torch.equal(new[k], v)
                                                     for k, v in old.items())
        reload_err = float(np.abs(after - before).max())
        del old, new
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        tmp.cleanup()
    want = plain_probs(engine, small)
    parity = float(np.abs(after - want).max())
    log("f32_serving", batch=B, labels=NUM_LABELS, build_seconds=build_s, request_ms=batch_ms,
        seqs_per_s=B * 1e3 / float(np.mean(batch_ms)), reload_seconds=reload_s,
        reload_same_bits=same_bits, reload_max_abs_prob_change=reload_err,
        max_abs_prob_err=parity, prob_atol=RELOAD_PROB_ATOL, card=card)
    if reload_body.get("status") != "reloaded" or not same_bits or reload_err > RELOAD_PROB_ATOL:
        raise AssertionError(f"float32 /v1/reload changed the model: {reload_body}, "
                             f"{same_bits}, {reload_err}")
    if not parity <= RELOAD_PROB_ATOL:
        raise AssertionError(f"float32 serving disagrees with the plain chain: {parity}")
    del engine, trainer
    torch.cuda.empty_cache()
    out = {"seqs_per_s": B * 1e3 / float(np.mean(batch_ms))}
    for name, params in (("prod", {"FEATURE_FUSION": "concatenation_prod"}),
                         ("one_layer", {"OUTPUT_MLP_NUM_LAYERS": 1})):
        pi_cfg, pn_cfg, ts = f32_models(**params)
        engine = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, buckets=(512, 1024),
                               max_batch=B, device="cuda")
        full = random_sequences(rng, rng.integers(100, 500, B))
        probs, ms = event_ms(lambda: engine.score(full))
        want = plain_probs(engine, small)
        err = float(np.abs(engine.score(small) - want).max())
        log(f"f32_serving_{name}", settings=params, batch_ms=ms, seqs_per_s=B * 1e3 / ms,
            max_abs_prob_err=err, prob_atol=RELOAD_PROB_ATOL, card=card)
        if not (np.isfinite(probs).all() and err <= RELOAD_PROB_ATOL):
            raise AssertionError(f"float32 serving ({name}) disagrees with the plain chain: "
                                 f"{err}")
        out[f"{name}_seqs_per_s"] = B * 1e3 / ms
        del engine, ts
        torch.cuda.empty_cache()
    return out


def f32_eval(card: str) -> dict:
    """Float32 evaluation of a 64-sequence FASTA through ``Trainer.evaluate``:
    K7 f32 + K1 f32, then K3 and the K9 sweep of the CLI's 99 thresholds;
    then ``PAIR_BACKEND tiled_int8`` with ``INT8_CALIBRATE`` off (K2's
    float32 form, dynamic scales)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from protnote_tpu_torch.data.dataset import DatasetConfig
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import threshold_sweep as k9
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = DatasetConfig(dataset_type="test", inference_go_descriptions=("name", "label"),
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        ds = fasta_dataset(tmp, "eval_f32.fasta", F32_SEQUENCES, 41, cfg)
    pi_cfg, pn_cfg, ts = f32_models()
    out = {}
    for name, pn, sweep, calibrate in (("sweep", pn_cfg, True, True),
                                       ("int8_dynamic", dataclasses.replace(
                                           pn_cfg, pair_backend="tiled_int8"), False, False)):
        trainer = Trainer(ts, pi_cfg, pn, TrainerConfig(
            decision_threshold=THRESHOLD, estimate_map=True, int8_calibrate=calibrate),
            device="cuda")
        batcher = eval_batcher(ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.evaluate(batcher, threshold_sweep=sweep_thresholds() if sweep else None)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        metrics = res["metrics"]
        if not all(np.isfinite(v) for v in metrics.values()) or \
                (sweep and not np.isfinite(res["threshold"][1])):
            raise AssertionError(f"float32 evaluation ({name}): non-finite {metrics}")
        out[name] = len(ds) / sec
        log(f"f32_eval_{name}", sequences=len(ds), batches=len(batcher), seconds=sec,
            seqs_per_s=len(ds) / sec, threshold=res.get("threshold"),
            map_micro=metrics["map_micro"], k3=dict(k3.LAUNCHES), k9=dict(k9.LAUNCHES),
            card=card)
        del trainer, batcher
        torch.cuda.empty_cache()
    return out


def f32_predict(card: str) -> dict:
    """``cli/predict.py`` with ``--override MIXED_PRECISION False`` on a
    64-sequence FASTA (half unlabeled), the default config with the
    32,102 x 2 label cache file: ``build_predictor``, the int8 calibration
    step and the scoring generator (``predict.main``'s window less its
    parquet writes, which phase 22 times), ``auto`` (K1 f32) and
    ``tiled_int8`` (K2's float32 form, static scales calibrated on the first
    batch); the first batch's float32 logits within 1e-4 of the plain
    chain's largest |logit| (``K7_F32_CHAIN_REL_TOL``: the encoder's float32
    chain and the scorer's split), the int8 form's on the kernels' encoder
    output (an int8 code flips with its input's last bit)."""
    import tempfile

    import torch

    from protnote_tpu_torch.cli import predict
    from protnote_tpu_torch.core.config import (
        generate_label_embedding_path,
        load_config,
        resolve_paths,
    )
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
    from protnote_tpu_torch.train.step import batch_to_device_dict

    out = {}
    with tempfile.TemporaryDirectory() as tmp, protnote_env(tmp):
        config = resolve_paths(load_config())
        emb_path = generate_label_embedding_path(
            config["params"], config["paths_resolved"]["GO_BASE_LABEL_EMBEDDING_PATH"])
        _, _, cache = label_cache()
        LabelEmbeddingCache.save(emb_path, cache.embeddings, cache.ids, cache.description_types,
                                 cache.descriptions, cache.token_counts)
        del cache
        fasta = write_fasta(os.path.join(tmp, "query.fasta"), F32_SEQUENCES, 43, labeled=False)
        for backend in ("auto", "tiled_int8"):
            out_dir = os.path.join(tmp, f"shards_{backend}")
            args = predict.build_argparser().parse_args(
                ["--fasta", fasta, "--name", f"f32_{backend}", "--output-dir", out_dir,
                 "--rows-per-shard", "128", "--override", "PAIR_BACKEND", backend,
                 "MIXED_PRECISION", "False"])
            _, _, _, ds, trainer, batcher, label_matrix, _ = predict.build_predictor(args)
            if trainer.pn_cfg.compute_dtype != torch.float32:
                raise AssertionError("predict with MIXED_PRECISION False is not float32")
            t0 = time.perf_counter()
            trainer.ensure_int8_calibrated(batcher)
            written = sum(len(ids) for _, ids, _ in
                          predict.score_batches(trainer, batcher, label_matrix))
            sec = time.perf_counter() - t0  # the generator reads every batch back
            batch = next(iter(batcher))
            arrays = trainer._place(batch_to_device_dict(batch, trainer.device), label_matrix,
                                    batch)
            latents = trainer._label_latents(arrays)
            got = trainer._eval_step(trainer.ts, trainer._swap_in_latents(arrays, latents))
            want = plain_logits(trainer.ts, trainer.pi_cfg, trainer.pn_cfg, arrays["aa_ids"],
                                arrays["lengths"], latents, plain_encoder=backend == "auto")
            keep = arrays["example_mask"] > 0
            scale = float(want[keep].abs().max())
            err = float((got["logits"][keep] - want[keep]).abs().max())
            out[backend] = written / sec
            log("f32_predict", backend=backend, sequences=written, seconds=sec,
                seqs_per_s=written / sec,
                scales=trainer.pn_cfg.int8_act_scales, max_abs_logit_err=err,
                max_abs_logit=scale, rel_tol=K7_F32_CHAIN_REL_TOL,
                latents_dtype=str(latents.dtype), card=card)
            if written != F32_SEQUENCES or not err <= K7_F32_CHAIN_REL_TOL * scale:
                raise AssertionError(f"float32 predict ({backend}): {written} sequences, "
                                     f"logits {err} against the plain chain")
            del trainer, batcher, label_matrix, latents, got, want, arrays
            torch.cuda.empty_cache()
    return out


def phase_f32_paths(card: str) -> dict:
    """Phase 29: ``MIXED_PRECISION False`` end to end through the entry
    points' own code: serving (two batches, a ``/v1/reload``, the prod and
    one-layer forms), evaluation (K3 and the K9 sweep; int8 dynamic) and
    ``predict`` (bf16-free: K7 f32, K1 f32, K2's float32 form).  Every count
    is set to 0 just before and read just after; each float32 form must
    have launched, and no bf16 K1, K2 layer or K7 conv."""
    import numpy as np

    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import threshold_sweep as k9

    rng = np.random.default_rng(22)
    reset_f32_path_counts()
    rates = {"serving": f32_serving(rng, card), "eval": f32_eval(card),
             "predict": f32_predict(card)}
    launches = {**ps.F32_LAUNCHES, **{f"k7_{k}": v for k, v in k7.LAUNCHES.items() if v},
                "eval_acc_update": k3.LAUNCHES["update"],
                "threshold_sweep_update": k9.LAUNCHES["update"],
                "pair_int8_codes": ps.INT8_LAUNCHES["pair_int8_codes"],
                "pair_int8_row_scale": ps.INT8_LAUNCHES["pair_int8_row_scale"]}
    bf16 = {"pair_mlp_layer": ps.LAUNCHES, "pair_mlp_head": ps.HEAD_LAUNCHES,
            "pair_int8_layer": ps.INT8_LAUNCHES["pair_int8_layer"],
            "masked_conv_fwd": k7.LAUNCHES["masked_conv_fwd"]}
    log("f32_paths", rates=rates, launches=launches, bf16_launches=bf16, card=card)
    if any(launches[k] <= 0 for k in F32_FORMS + ("eval_acc_update", "threshold_sweep_update")) \
            or k7.LAUNCHES["masked_conv_fwd_f32"] <= 0 or any(bf16.values()):
        raise AssertionError(f"the float32 paths skipped a float32 kernel or ran a bf16 one: "
                             f"{launches}, {bf16}")
    return launches



# float32 training on the card (MIXED_PRECISION False): K4 in float32
# (pair_scorer_f32.cu:pair_train_hidden_f32), K4-bwd's float32 kernels
# (pair_train_bwd_f32.cu) and K5's float32 entry points at the training
# width, each against its plain float32 version (cuBLAS, TF32 off) within
# F32_REL_TOL of the plain tensor's largest |value|, and the float32 sums
# over the pair rows (K5's moments, dscale and dbias; dW) within the
# depth's figure of tests/test_torch_pair_train_f32.py (float32 additions
# of partial sums in a fixed order drift as a random walk: 2 x 2^-24 x
# sqrt(rows / 64), 1.5e-5 at 1,027,264 pair rows).  dW is held to that
# figure against a float64 truth on four 128 x 128 tiles: cuBLAS float32 at
# this depth is itself 2.9e-4 of the largest |value| from float64 on K5's
# dz (2.2e-4 from the kernel, whose own distance was 6.7e-6, on an H100
# 80GB HBM3 at 700 W), so against the plain version it is held to
# DW_PLAIN_REL_TOL; then
# Trainer.train in float32 at full width:
# F32_TRAIN_STEPS steps and a validation pass, F32_REMAT_STEPS with
# GRADIENT_CHECKPOINTING, and one step's gradients and running statistics
# against the plain float32 chain on a batch of F32_GRAD_B sequences (the
# plain chain's temporaries do not fit beside 32 sequences' activations),
# each output-MLP leaf within F32_GRAD_L2_TOL of its L2 norm (the step's
# float32 sums over half a million pair rows in other orders), every leaf
# of the backward kernels alone likewise; the projection heads' leaves, whose
# gradient through the first layer's analytic BatchNorm moves ~1e3 times as
# far as a rounding-level change of z, within twice the distance that a
# relative F32_Z_NOISE on z moves them (f32_grad_check)
F32_TRAIN_KERNELS = ("pair_train_hidden_f32", "pair_train_dx_f32", "pair_train_dw_f32",
                     "bn_relu_forward_f32", "bn_relu_backward_f32")
F32_TRAIN_STEPS, F32_REMAT_STEPS = 5, 3
F32_GRAD_B = 16
F32_GRAD_L2_TOL = 1e-4
F32_Z_NOISE = 1e-6
DW_PLAIN_REL_TOL = 1e-3
DW_TRUTH_TILE = 128


def depth_tol(rows: int) -> float:
    """The figure of a float32 sum over ``rows`` pair rows
    (tests/test_torch_pair_train_f32.py), at least F32_REL_TOL."""
    return max(F32_REL_TOL, 2 * 2.0 ** -24 * math.sqrt(rows / 64))


def dw_truth(a2, c2, dz, got, want, tiles) -> dict:
    """dW's kernel (``got``) and plain (``want``) values against float64 on
    the 128 x 128 ``tiles`` (k0, n0): each one's largest |error| over the
    plain dW's largest |value|."""
    import torch

    T = DW_TRUTH_TILE
    scale = float(want.abs().max())
    out = {"kernel": 0.0, "plain": 0.0}
    for k0, n0 in tiles:
        x1 = torch.relu(a2[:, None, k0:k0 + T] + c2[None, :, k0:k0 + T]).reshape(-1, T).double()
        truth = x1.T @ dz[:, n0:n0 + T].double()
        del x1
        for name, t in (("kernel", got), ("plain", want)):
            err = float((t[k0:k0 + T, n0:n0 + T].double() - truth).abs().max()) / scale
            out[name] = max(out[name], err)
        del truth
    return out


def f32_train_schedule(steps: int, remat: bool) -> dict:
    """The float32 training kernels' launches over ``steps`` decomposed
    steps (3 output-MLP layers): K4 and the two K5 BatchNorms forward once
    a step and once more under remat (the backward recomputes them), their
    backward once."""
    again = 2 if remat else 1
    return {"pair_train_hidden_f32": again * steps, "pair_train_dx_f32": steps,
            "pair_train_dw_f32": steps, "bn_relu_forward_f32": 2 * again * steps,
            "bn_relu_backward_f32": 2 * steps}


def phase_f32_train_kernels(card: str) -> dict:
    """Phase 30: K4, K4-bwd and K5 in float32 alone at the training path's
    32-sequence shapes (a2 (32, 3072), c2 (32,102, 3072), W (3072, 3072), z
    and dz (1,027,264 x 3072) float32: 12.6 GB each), each against its plain
    float32 version on the same device tensors (K5's in column slices): the
    error over the plain tensor's largest |value|, the same bits on a second
    call, CUDA-event times beside the bound (the products at the split's 165
    TFLOP/s, K5's bytes at 3.35 TB/s) and the FMA pipe's bound, the plain
    version's time, and cuBLAS float32 on the bare products (x1
    materialised: a yardstick, not the same function).  K4-bwd's dz is K5's
    backward output (zero at masked pairs)."""
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st

    dev, f32 = torch.device("cuda"), torch.float32
    gemm_precision(f32)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for the float32 plain versions")
    p, s = random_output_mlp(dev)
    gen = torch.Generator().manual_seed(30)
    dgen = torch.Generator(device=dev).manual_seed(31)
    before = {k: st.LAUNCHES[k] for k in DECOMPOSED_KERNELS}
    out, extra, same = {}, {}, {}
    with torch.no_grad():
        a2 = torch.randn(TRAIN_B, H, generator=gen).to(dev)
        c2 = torch.randn(NUM_LABELS, H, generator=gen).to(dev)
        W = (torch.randn(H, H, generator=gen) * (2.0 / H) ** 0.5).to(dev)
        N = TRAIN_B * NUM_LABELS
        # K4
        z = st._pair_hidden_fwd_cuda(a2, c2, W)
        same["pair_train_hidden_f32"] = bool(torch.equal(z, st._pair_hidden_fwd_cuda(a2, c2, W)))
        torch.cuda.empty_cache()
        k4 = delta(z, st._pair_hidden_fwd_plain(a2, c2, W))
        torch.cuda.empty_cache()
        x1 = st._pair_x1(a2, c2)
        cublas_fwd = cuda_time_ms(lambda: torch.matmul(x1, W), 2)
        del x1
        torch.cuda.empty_cache()
        times = {"pair_train_hidden_f32": (
            cuda_time_ms(lambda: st._pair_hidden_fwd_cuda(a2, c2, W), 3),
            cuda_time_ms(lambda: st._pair_hidden_fwd_plain(a2, c2, W), 1))}
        torch.cuda.empty_cache()
        # K5 on K4's output
        em = torch.ones(TRAIN_B, device=dev)
        em[-1] = 0.0
        lm = (torch.rand(NUM_LABELS, generator=gen) < 0.98).float().to(dev)
        rows = (em[:, None] * lm[None, :]).reshape(-1, 1)
        n = rows.sum()
        bn = (p["bns"][1]["scale"], p["bns"][1]["bias"], s["bns"][1]["mean"])
        f = st._bn_relu_fwd_cuda(z, rows, n, *bn)
        same["bn_relu_forward_f32"] = all(torch.equal(x, y) for x, y in zip(
            f, st._bn_relu_fwd_cuda(z, rows, n, *bn)))
        torch.cuda.empty_cache()
        dy = torch.randn(z.shape, device=dev, generator=dgen)
        stats = (f[1], f[3], f[4], f[5])  # mean, istd, inv, shift of the kernel
        g = st._bn_relu_grads_cuda(z, dy, rows, n, bn[0], *stats)
        same["bn_relu_backward_f32"] = all(torch.equal(x, y) for x, y in zip(
            g, st._bn_relu_grads_cuda(z, dy, rows, n, bn[0], *stats)))
        torch.cuda.empty_cache()
        cols = [slice(j, j + K5_PLAIN_COLS) for j in range(0, H, K5_PLAIN_COLS)]

        def fwd_plain(c):
            return st._bn_relu_fwd_plain(z[:, c], rows, n, *(t[c] for t in bn))

        def bwd_plain(c):
            return st._bn_relu_grads(z[:, c], dy[:, c], rows, n, bn[0][c], *(t[c] for t in stats))

        k5f = {"y": [], "mean": [], "var": []}
        k5b = {"dz": [], "dscale": [], "dbias": []}
        for c in cols:
            y0, mean0, var0 = fwd_plain(c)[:3]
            for parts, got, want in zip(k5f.values(), (f[0][:, c], f[1][c], f[2][c]),
                                        (y0, mean0, var0)):
                parts.append(delta(got, want))
            del y0
            for parts, got, want in zip(k5b.values(), (g[0][:, c], g[1][c], g[2][c]),
                                        bwd_plain(c)):
                parts.append(delta(got, want))
        del f
        torch.cuda.empty_cache()
        times["bn_relu_forward_f32"] = (
            cuda_time_ms(lambda: st._bn_relu_fwd_cuda(z, rows, n, *bn), 5),
            cuda_time_ms(lambda: [fwd_plain(c) for c in cols], 1))
        torch.cuda.empty_cache()
        times["bn_relu_backward_f32"] = (
            cuda_time_ms(lambda: st._bn_relu_grads_cuda(z, dy, rows, n, bn[0], *stats), 5),
            cuda_time_ms(lambda: [bwd_plain(c) for c in cols], 1))
        dz = g[0]
        del g, z, dy
        torch.cuda.empty_cache()
        # K4-bwd on K5's dz
        got = st._pair_hidden_backward_cuda(a2, c2, W, dz)
        again = st._pair_hidden_backward_cuda(a2, c2, W, dz)
        same["pair_train_dx_f32"] = bool(torch.equal(got[0], again[0])
                                         and torch.equal(got[1], again[1]))
        same["pair_train_dw_f32"] = bool(torch.equal(got[2], again[2]))
        del again
        want = st._pair_hidden_backward_plain(a2, c2, W, dz)
        k4b = {k: delta(x, y) for k, x, y in zip(("da2", "dc2", "dw"), got, want)}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        dxp = st.pair_dx_f32_plan(TRAIN_B, NUM_LABELS, H, H, sms)
        dwp = st.pair_dw_plan(TRAIN_B, NUM_LABELS, H, H, sms, block_n=st.F32_TILE)
        T = DW_TRUTH_TILE
        worst = int((got[2] - want[2]).abs().view(H // T, T, H // T, T).amax(dim=(1, 3)).argmax())
        piece = dwp.item(dwp.full)[:2] if dwp.tail else (0, 0)
        truth_tiles = [(0, 0), (worst // (H // T) * T, worst % (H // T) * T), piece,
                       (H - T, H - T)]
        truth = dw_truth(a2, c2, dz, got[2], want[2], truth_tiles)
        del got, want
        torch.cuda.empty_cache()
        w3 = ps.stacked_pieces(W, transpose=False)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def plain_dx():
            x1 = st._pair_x1(a2, c2)
            gate = x1 > 0
            del x1
            dx1 = dz @ W.T
            dx1.mul_(gate)
            del gate
            dx1 = dx1.view(TRAIN_B, NUM_LABELS, -1)
            return dx1.sum(1), dx1.sum(0)

        times["pair_train_dx_f32"] = (
            cuda_time_ms(lambda: st._pair_dx_f32_cuda(a2, c2, w3, dz, dxp, stream), 3),
            cuda_time_ms(plain_dx, 1))
        times["pair_train_dw_f32"] = (
            cuda_time_ms(lambda: st._pair_dw_f32_cuda(a2, c2, dz, dwp, stream), 3),
            cuda_time_ms(lambda: st._pair_x1(a2, c2).T @ dz, 1))
        cublas_dx = cuda_time_ms(lambda: torch.matmul(dz, W.t()), 2)
        x1 = st._pair_x1(a2, c2)
        cublas_dw = cuda_time_ms(lambda: torch.matmul(x1.t(), dz), 2)
        del x1, dz
        torch.cuda.empty_cache()
    launches = {k: st.LAUNCHES[k] - before[k] for k in DECOMPOSED_KERNELS}
    if any(launches.values()):
        raise AssertionError(f"a float32 call launched a bf16 K4, K4-bwd or K5: {launches}")
    rel = {"pair_train_hidden_f32": {"z": merge_deltas([k4])},
           "bn_relu_forward_f32": {k: merge_deltas(v) for k, v in k5f.items()},
           "bn_relu_backward_f32": {k: merge_deltas(v) for k, v in k5b.items()},
           "pair_train_dx_f32": {k: merge_deltas([k4b[k]]) for k in ("da2", "dc2")},
           "pair_train_dw_f32": {"dw": merge_deltas([k4b["dw"]])}}
    sums = {"mean", "var", "dscale", "dbias"}  # float32 sums over the N pair rows
    tol = {k: {o: depth_tol(N) if o in sums else DW_PLAIN_REL_TOL if o == "dw" else F32_REL_TOL
               for o in v} for k, v in rel.items()}
    rel["pair_train_dw_f32"]["dw_kernel_vs_float64"] = (0.0, truth["kernel"])
    tol["pair_train_dw_f32"]["dw_kernel_vs_float64"] = depth_tol(N)
    ops = 2.0 * N * H * H
    nbytes = {"bn_relu_forward_f32": 8.0 * N * H + 4 * N + 32 * H,
              "bn_relu_backward_f32": 12.0 * N * H + 4 * N + 28 * H}
    cublas = {"pair_train_hidden_f32": cublas_fwd, "pair_train_dx_f32": cublas_dx,
              "pair_train_dw_f32": cublas_dw}
    abs_err = {"pair_train_hidden_f32": k4[0], "bn_relu_forward_f32": rel["bn_relu_forward_f32"]
               ["y"][0], "bn_relu_backward_f32": rel["bn_relu_backward_f32"]["dz"][0],
               "pair_train_dx_f32": max(k4b["da2"][0], k4b["dc2"][0]),
               "pair_train_dw_f32": k4b["dw"][0]}
    for k in F32_TRAIN_KERNELS:
        ms, plain_ms = times[k]
        b = bound(nbytes=nbytes[k]) if k in nbytes else bound(ops=ops, peak=SPLIT_FLOPS)
        out[k] = {"max_abs_err": abs_err[k], "ms": ms, "plain_ms": plain_ms, **b,
                  "library_ms": None}
        fields = {"cublas_bare_product_ms": cublas[k], "tflops": ops / ms / 1e9,
                  "bound_fma_ms": ops / F32_FLOPS * 1e3} if k in cublas else {}
        extra[k] = {"rel_errs": {o: d[1] for o, d in rel[k].items()}, "rel_tol": tol[k],
                    "same_bits": same[k], "bound_share": b["bound_ms"] / ms, **fields}
        if k == "pair_train_dw_f32":
            extra[k].update(truth_tiles=truth_tiles, plain_vs_float64=truth["plain"])
        log(f"f32_train_{k}", **out[k], **extra[k], card=card)
    bad = {k: v["rel_errs"] for k, v in extra.items()
           if any(e > tol[k][o] for o, e in v["rel_errs"].items()) or not v["same_bits"]}
    if bad:
        raise AssertionError(f"a float32 training kernel disagrees with its plain version or "
                             f"gave other bits on a second call: {bad}")
    log("f32_train_kernels", batch=TRAIN_B, labels=NUM_LABELS, width=H, rows=N,
        dx_plan={"units": dxp.units, "grid": dxp.grid},
        dw_plan={"full": dwp.full, "pieces": dwp.pieces, "items": dwp.items, "grid": dwp.grid},
        smem_bytes=st.f32_train_smem_bytes(), card=card)
    return out


def f32_grad_check(trainer, ds, card: str) -> dict:
    """One float32 step's gradients and new running statistics on one batch
    of F32_GRAD_B sequences from the same weights and generator seed, through
    four chains: the kernels; the plain float32 chain
    (``pair_logits_dense_decomposed_reference``); that chain with K4-bwd's
    kernels for its backward (the backward alone: the same forward); and
    that chain with K4's output perturbed by a relative F32_Z_NOISE (seeded
    normal noise, the kernel's own forward error at this width: the noise
    floor).  Held, each in L2 over the plain chain's leaf norm: every leaf of
    the backward alone within F32_GRAD_L2_TOL; every output-MLP leaf and
    running statistic of the kernels within F32_GRAD_L2_TOL; every leaf of
    the kernels within F32_GRAD_L2_TOL or twice the noise floor's distance.
    The projection heads reach the loss through the first layer's analytic
    BatchNorm, whose gradient is a small difference of sums over the labels:
    a rounding-level change of z moves them ~1e3 times as far (on an H100
    80GB HBM3 at 700 W, 1e-6 of z moved W_l's gradients 1.0e-3)."""
    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.models import fusion
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, make_train_step

    class KeepGrads:
        def update(self, grads, trainable, state):
            self.grads = grads
            return state

    dev = torch.device("cuda")
    batch = next(iter(BucketBatcher(ds, F32_GRAD_B, buckets=(256, 512, 1024), shuffle=True,
                                    drop_last=True, seed=5, device_label_gather=True)))
    arrays = trainer._place(batch_to_device_dict(batch, dev), trainer._label_matrix_for(ds))
    names = {id(t): n for n, t in named_tensors(trainer.ts["trainable"]).items()}
    leaf_names = [names[id(t)] for t in tree_leaves(trainer.ts["trainable"])]
    plain_fwd = st._pair_hidden_fwd_plain

    def noisy_fwd(a2, c2, w):
        z = plain_fwd(a2, c2, w)
        noise = torch.randn(z.shape, device=z.device,
                            generator=torch.Generator(device=z.device).manual_seed(9))
        return z.mul_(noise.mul_(F32_Z_NOISE).add_(1.0))

    plain = st.pair_logits_dense_decomposed_reference
    chains = (("kernels", st.pair_logits_dense_decomposed, {}),
              ("plain", plain, {}),
              ("backward_kernels", plain,
               {"_pair_hidden_backward_plain": st._pair_hidden_backward_cuda}),
              ("z_noise", plain, {"_pair_hidden_fwd_plain": noisy_fwd}))
    runs = {}
    for name, scorer, patch in chains:
        keeper = KeepGrads()
        step = make_train_step(trainer.pi_cfg, trainer.pn_cfg, get_loss_fn(TRAIN_PARAMS), keeper,
                               decision_threshold=THRESHOLD)
        saved = [(fusion, "pair_logits_dense_decomposed", fusion.pair_logits_dense_decomposed)]
        saved += [(st, k, getattr(st, k)) for k in patch]
        fusion.pair_logits_dense_decomposed = scorer
        for k, v in patch.items():
            setattr(st, k, v)
        try:
            before = dict(st.LAUNCHES)
            ts, m = step(trainer.ts, arrays, torch.Generator(device=dev).manual_seed(3))
            torch.cuda.synchronize()
        finally:
            for mod, k, v in saved:
                setattr(mod, k, v)
        launched = {k: st.LAUNCHES[k] - before[k] for k in st.LAUNCHES
                    if st.LAUNCHES[k] != before[k]}
        stats = tree_leaves(ts["model_state"]["output_mlp"])
        runs[name] = ([g.float() for g in keeper.grads], [t.float() for t in stats],
                      float(m["loss"]), launched)
        del ts, keeper
        torch.cuda.empty_cache()
    want = {"kernels": f32_train_schedule(1, trainer.pn_cfg.gradient_checkpointing),
            "plain": {}, "backward_kernels": {"pair_train_dx_f32": 1, "pair_train_dw_f32": 1},
            "z_noise": {}}
    if any(runs[k][3] != v for k, v in want.items()):
        raise AssertionError("the gradient check's launches: "
                             f"{({k: r[3] for k, r in runs.items()})}")

    def l2(a, b):
        na = float(b.norm())
        return float((a - b).norm()) / na if na > 0 else float((a - b).norm())

    gp = runs["plain"][0]
    rows = [{"leaf": n, **{k: l2(runs[k][0][i], gp[i])
                           for k in ("kernels", "backward_kernels", "z_noise")}}
            for i, n in enumerate(leaf_names)]
    stat_rel = [l2(a, b) for a, b in zip(runs["kernels"][1], runs["plain"][1])]
    mlp = [r for r in rows if r["leaf"].startswith("/protnote/output_mlp")]
    bad = [r for r in rows if r["backward_kernels"] > F32_GRAD_L2_TOL or
           (r in mlp and r["kernels"] > F32_GRAD_L2_TOL) or
           r["kernels"] > max(F32_GRAD_L2_TOL, 2 * r["z_noise"])]
    out = {"sequences": F32_GRAD_B, "leaves": len(rows), "output_mlp_leaves": len(mlp),
           "max_output_mlp_l2_rel": max(r["kernels"] for r in mlp),
           "max_l2_rel": max(r["kernels"] for r in rows),
           "max_backward_kernels_l2_rel": max(r["backward_kernels"] for r in rows),
           "max_z_noise_l2_rel": max(r["z_noise"] for r in rows), "z_noise": F32_Z_NOISE,
           "max_stat_l2_rel": max(stat_rel), "loss_kernels": runs["kernels"][2],
           "loss_plain": runs["plain"][2], "l2_tol": F32_GRAD_L2_TOL}
    log("f32_train_grad_check", **out, by_leaf=rows, card=card)
    if bad or max(stat_rel) > F32_GRAD_L2_TOL or not math.isfinite(out["loss_kernels"]):
        raise AssertionError(f"a float32 step's gradients or running statistics through the "
                             f"kernels differ from the plain chain's: {out}, {bad}")
    return out


def f32_train_run(card: str, ds, val_ds, steps: int, remat: bool, checks: bool) -> dict:
    """``Trainer.train`` with MIXED_PRECISION False on ``ds`` (one epoch of
    at least ``steps`` steps of TRAIN_B sequences, and a validation pass on
    ``val_ds`` when given): per-step losses, median warm step ms, seqs/s,
    peak memory, the launches against the schedule (none of the bf16 K4,
    K4-bwd or K5; K7 f32 on every step and K1 f32 in validation), and with
    ``checks`` two profiled steps, the gradient check and a PNTPU1
    checkpoint written and read back."""
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    pi_cfg, pn_cfg, ts = f32_models(GRADIENT_CHECKPOINTING=remat)
    opt = Optimizer(TRAIN_PARAMS)
    ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"], ts["enc_params"],
                           ts["enc_state"], opt)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True,
                             checkpoint_dir=tmp, run_name="f32")
        trainer = Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev,
                          loss_fn=get_loss_fn(TRAIN_PARAMS), optimizer=opt)
        steps_, step_fn = [], trainer._train_step

        def timed_step(ts_, batch, gen):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ts_, m = step_fn(ts_, batch, gen)
            torch.cuda.synchronize()
            steps_.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"])))
            return ts_, m

        def batcher(seed=42):
            return BucketBatcher(ds, TRAIN_B, buckets=(256, 512, 1024), shuffle=True,
                                 drop_last=True, seed=seed, device_label_gather=True)

        val_b = None if val_ds is None else BucketBatcher(
            val_ds, TRAIN_B, buckets=(256, 512, 1024), descriptions_per_label=K_DESCRIPTIONS,
            device_label_gather=True)
        trainer._train_step = timed_step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for counts in (st.LAUNCHES, ps.F32_LAUNCHES):
            for k in counts:
                counts[k] = 0
        ps.LAUNCHES = ps.HEAD_LAUNCHES = 0
        reset_k7_launches()
        summary = trainer.train(batcher(), val_b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer._train_step = step_fn
        train_launches = {k: v for k, v in st.LAUNCHES.items() if v}
        want = f32_train_schedule(len(steps_), remat)
        others = {"pair_mlp_layer": ps.LAUNCHES, "masked_conv_fwd": k7.LAUNCHES["masked_conv_fwd"]}
        losses = [x[1] for x in steps_]
        if len(steps_) < steps or not all(math.isfinite(x) for x in losses) or \
                train_launches != want or any(others.values()) or \
                k7.LAUNCHES["masked_conv_fwd_f32"] <= 0 or \
                (val_b is not None and ps.F32_LAUNCHES["pair_mlp_layer_f32"] <= 0):
            raise AssertionError(f"float32 training (remat {remat}): {len(steps_)} steps, losses "
                                 f"{losses}, launches {train_launches} (schedule {want}), bf16 "
                                 f"{others}, f32 {dict(ps.F32_LAUNCHES)}")
        med = statistics.median([x[0] for x in steps_[1:]])
        hist = summary["history"][0]
        result = {"steps": len(steps_), "median_warm_step_ms": med * 1e3,
                  "seqs_per_s": TRAIN_B / med, "peak_mem_gb": peak, "launches": train_launches}
        log(f"f32_train{'_remat' if remat else ''}", sequences_per_step=TRAIN_B,
            labels=NUM_LABELS, step_losses=losses, grad_norms=[x[2] for x in steps_],
            first_step_ms=steps_[0][0] * 1e3, **result, k1_f32_launches=dict(ps.F32_LAUNCHES),
            val_map_micro=hist.get("val_map_micro"), val_loss=hist.get("val_loss"), card=card)
        if checks:
            placed = []
            matrix = trainer._label_matrix_for(ds)
            for batch in batcher(seed=7):
                placed.append(trainer._place(batch_to_device_dict(batch, dev), matrix))
                if len(placed) == 2:
                    break
            gen = torch.Generator(device=dev).manual_seed(1)
            it = iter(placed)

            def one_step():
                trainer.ts, _ = step_fn(trainer.ts, next(it), gen)

            wall, busy, top = device_profile(one_step, len(placed))
            result["idle_share"] = None if busy is None else 1.0 - busy / wall
            log("f32_train_profile", steps=len(placed), wall_ms_per_step=wall * 1e3 / 2,
                device_busy_ms_per_step=None if busy is None else busy * 1e3 / 2,
                idle_share=result["idle_share"], top_kernels_ms_per_step=top, card=card)
            del placed, it
            torch.cuda.empty_cache()
            result["grad_check"] = f32_grad_check(trainer, ds, card)
            trainer.save("f32")
            path = os.path.join(tmp, "f32_f32.ckpt")
            restored = Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev,
                               loss_fn=get_loss_fn(TRAIN_PARAMS), optimizer=Optimizer(TRAIN_PARAMS))
            restored.load(path)
            a = [x for x in tree_leaves(trainer.ts) if isinstance(x, torch.Tensor)]
            b = [x for x in tree_leaves(restored.ts) if isinstance(x, torch.Tensor)]
            if len(a) != len(b) or not all(x.dtype == y.dtype and torch.equal(x, y)
                                           for x, y in zip(a, b)) or \
                    trainer.ts["step"] != restored.ts["step"]:
                raise AssertionError("the float32 checkpoint read back differs from the state")
            log("f32_train_checkpoint", leaves=len(a), step=int(restored.ts["step"]),
                bytes=os.path.getsize(path), card=card)
            del restored
        del trainer
    torch.cuda.empty_cache()
    return result


def phase_f32_training(card: str) -> dict:
    """Phase 31: ``Trainer.train`` with MIXED_PRECISION False at full width
    (the default config: 32 sequences a step against all 32,102 labels, H
    3072; seeded random weights and label embeddings), F32_TRAIN_STEPS steps
    and a validation pass (K1 f32), two profiled steps, the gradient check
    and a checkpoint round trip; then F32_REMAT_STEPS steps with
    GRADIENT_CHECKPOINTING.  Returns the launches of the float32 kernels
    summed over both runs."""
    import tempfile

    from protnote_tpu_torch.data.dataset import DatasetConfig

    types = ("name", "label")
    train_cfg = DatasetConfig(dataset_type="train", label_augmentation_descriptions=types,
                              inference_go_descriptions=types,
                              inference_descriptions_per_label=K_DESCRIPTIONS)
    val_cfg = DatasetConfig(dataset_type="validation", inference_go_descriptions=types,
                            inference_descriptions_per_label=K_DESCRIPTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        # lengths 100-1000 over three buckets, whole batches only: two
        # batches' more sequences than the steps wanted
        ds = fasta_dataset(tmp, "f32_train.fasta", TRAIN_B * (F32_TRAIN_STEPS + 2), 31,
                           train_cfg)
        remat_ds = fasta_dataset(tmp, "f32_remat.fasta", TRAIN_B * (F32_REMAT_STEPS + 2), 33,
                                 train_cfg)
        val_ds = fasta_dataset(tmp, "f32_val.fasta", F32_SEQUENCES, 32, val_cfg)
    run = f32_train_run(card, ds, val_ds, F32_TRAIN_STEPS, remat=False, checks=True)
    remat = f32_train_run(card, remat_ds, None, F32_REMAT_STEPS, remat=True, checks=False)
    log("f32_training", default=run, remat=remat, card=card)
    return {k: run["launches"].get(k, 0) + remat["launches"].get(k, 0) for k in F32_TRAIN_KERNELS}


# ----------------------------------------------------------------------
# the streamed and dense scorers in float32 (phases 32-35)

DENSE_F32_B = 16  # dense float32 training: 8 (B x L, 3072) float32 tensors fit at 16
# the dense gradient check's batch: the plain chain's int64 mask hashing
# takes (B x L, 3072) int64 temporaries, which do not fit at 16
DENSE_F32_GRAD_B = 8
F32_STREAM_STEPS = 3  # float32 streamed training steps, cache by the rule and off
F32_DENSE_STEPS = 3  # float32 dense training steps a setting
STREAM_F32_KERNELS = tuple(f"{k}_f32" for k in K6_KERNELS)
DENSE_F32_KERNELS = tuple(f"{k}_f32" for k in DENSE_KERNELS)
F32_DENSE_SETTINGS = (
    ("bn_dropout", {"OUTPUT_MLP_DROPOUT": DENSE_RATE}),
    ("prod_no_bn_remat", {"OUTPUT_MLP_DROPOUT": DENSE_RATE, "OUTPUT_MLP_BATCHNORM": False,
                          "FEATURE_FUSION": "concatenation_prod",
                          "GRADIENT_CHECKPOINTING": True}),
)


def phase_stream_dense_f32_kernels(card: str) -> dict:
    """Phase 32: the streamed and dense scorers' float32 kernels alone at
    their paths' shapes, each against its plain float32 version on the same
    device tensors (TF32 off), CUDA-event times beside the bound, the plain
    version's and (where one call computes the function) the library's:
    K6's ``_f32`` forms on one 32-sequence x 2,048-label tile (phase 20a's
    check on float32); at DENSE_F32_B sequences x 32,102 labels, d 1024, H
    3072, K5's dense float32 forms (dropout 0.1; their mask and kept values
    the same bits), ``pair_first_add_f32`` (the same bits as ``torch.add``),
    ``pair_train_prod_f32`` (F32_REL_TOL of the plain version's largest
    |value|; the bound at the split's 165 TFLOP/s), ``pair_side_sums_f32``
    plain and weighted (the label depth's figure; the same bits twice) and
    ``pair_train_dw_prod_f32`` (within 1e-3 of cuBLAS float32, within the
    pair depth's figure of float64 on four 128 x 128 tiles, the same bits
    twice); no bf16 form launched."""
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import dense_scorer as ds

    times = phase_k6(card, f32=True)
    torch.cuda.empty_cache()
    gemm_precision(torch.float32)
    dev = torch.device("cuda")
    Bq, L, d, Hh = DENSE_F32_B, NUM_LABELS, D_LATENT, H
    N = Bq * L
    g = torch.Generator(device=dev).manual_seed(91)
    seed = torch.tensor([7654321, 1234567], dtype=torch.int64, device=dev)
    before = dict(ds.LAUNCHES)
    with torch.no_grad():
        z = torch.randn(N, Hh, device=dev, generator=g).add_(0.3)
        dy = torch.randn(N, Hh, device=dev, generator=g)
        em = torch.ones(Bq, device=dev)
        em[-1] = 0
        lm = (torch.rand(L, device=dev, generator=g) < 0.98).float()
        rows = (em[:, None] * lm[None, :]).reshape(N, 1)
        n = rows.sum()
    for bn in (True, False):
        times.update(dense_act_check(card, bn, z, dy, rows, n, seed))
        torch.cuda.empty_cache()
    del z
    torch.cuda.empty_cache()

    with torch.no_grad():
        a = torch.randn(Bq, Hh, device=dev, generator=g)
        c = torch.randn(L, Hh, device=dev, generator=g)
        P_e = torch.randn(Bq, d, device=dev, generator=g)
        L_e = torch.randn(L, d, device=dev, generator=g)
        w = torch.randn(d, Hh, device=dev, generator=g) * (2.0 / d) ** 0.5
        # the first add: the same bits as one torch.add into a float32 out
        z1 = ds._first_fwd_cuda(a, c, P_e, L_e, None)
        z_lib = torch.empty(Bq, L, Hh, device=dev)
        torch.add(a[:, None], c[None], out=z_lib)
        add_same = bool(torch.equal(z1, z_lib.view(N, Hh)))
        del z1
        add_ms = cuda_time_ms(lambda: ds._first_fwd_cuda(a, c, P_e, L_e, None), 3)
        add_plain_ms = cuda_time_ms(lambda: ds._first_fwd_plain(a, c, P_e, L_e, None))
        add_lib_ms = cuda_time_ms(lambda: torch.add(a[:, None], c[None], out=z_lib), 3)
        del z_lib
        torch.cuda.empty_cache()
        if not add_same:
            raise AssertionError("pair_first_add_f32 differs from a[b] + c[l]")
        times["pair_first_add_f32"] = {"max_abs_err": 0.0, "ms": add_ms,
                                       "plain_ms": add_plain_ms,
                                       **bound(nbytes=N * Hh * 4 + (Bq + L) * Hh * 4),
                                       "library_ms": add_lib_ms}
        # the prod first layer
        chunk = 2048
        zp = ds.pair_prod_cuda(a, c, P_e, L_e, w).view(Bq, L, Hh)

        def prod_plain(l0, l1):
            return ds._first_fwd_plain(a, c[l0:l1], P_e, L_e[l0:l1], w).view(Bq, -1, Hh)

        p_err = p_big = 0.0
        for l0 in range(0, L, chunk):
            want = prod_plain(l0, min(l0 + chunk, L))
            p_err = max(p_err, float((zp[:, l0:l0 + chunk] - want).abs().max()))
            p_big = max(p_big, float(want.abs().max()))
        del zp, want
        prod_ms = cuda_time_ms(lambda: ds.pair_prod_cuda(a, c, P_e, L_e, w), 3)
        prod_plain_ms = cuda_time_ms(lambda: [prod_plain(l0, min(l0 + chunk, L))
                                              for l0 in range(0, L, chunk)])
        rows_p = (P_e[:, None] * L_e[None]).reshape(N, d)
        prod_lib_ms = cuda_time_ms(lambda: rows_p @ w, 3)
        torch.cuda.empty_cache()
        # the backward: the side sums, dW_prod, the weighted side sums of dJ
        dz = dy
        dz3 = dz.view(Bq, L, Hh)
        sb, sl = ds.side_sums_cuda(dz, Bq, L)
        sb2, sl2 = ds.side_sums_cuda(dz, Bq, L)
        side_same = bool(torch.equal(sb, sb2) and torch.equal(sl, sl2))
        del sb2, sl2
        s_rel = max(rel_err(sb, dz3.sum(1)), rel_err(sl, dz3.sum(0)))
        s_abs = max(float((sb - dz3.sum(1)).abs().max()), float((sl - dz3.sum(0)).abs().max()))
        side_ms = cuda_time_ms(lambda: ds.side_sums_cuda(dz, Bq, L), 3)
        side_plain_ms = cuda_time_ms(lambda: (dz3.sum(1), dz3.sum(0)))
        dw = ds.dw_prod_cuda(P_e, L_e, dz)
        dw_same = bool(torch.equal(dw, ds.dw_prod_cuda(P_e, L_e, dz)))
        want_w = rows_p.t() @ dz
        w_rel = rel_err(dw, want_w)
        w_abs = float((dw - want_w).abs().max())
        T = DW_TRUTH_TILE
        truth_err = 0.0
        for k0, n0 in ((0, 0), (d - T, 0), (0, Hh - T), (d - T, Hh - T)):
            truth = rows_p[:, k0:k0 + T].double().t() @ dz[:, n0:n0 + T].double()
            truth_err = max(truth_err, float((dw[k0:k0 + T, n0:n0 + T].double() - truth)
                                             .abs().max()))
        truth_rel = truth_err / float(want_w.abs().max())
        del want_w, truth
        dw_ms = cuda_time_ms(lambda: ds.dw_prod_cuda(P_e, L_e, dz), 3)
        dw_plain_ms = cuda_time_ms(lambda: ds._prod_rows(P_e, L_e).t() @ dz)
        dw_lib_ms = cuda_time_ms(lambda: rows_p.t() @ dz, 3)
        del rows_p
        torch.cuda.empty_cache()
        dJ = dz @ w.t()
        wb, wl = ds.side_sums_cuda(dJ, Bq, L, u=P_e, v=L_e)
        dJ3 = dJ.view(Bq, L, d)
        want_b = torch.stack([(dJ3[b] * L_e).sum(0) for b in range(Bq)])
        want_l = torch.zeros(L, d, device=dev)
        for b in range(Bq):
            want_l += dJ3[b] * P_e[b]
        ws_rel = max(rel_err(wb, want_b), rel_err(wl, want_l))
        del dJ, dJ3, want_l, dz3
    torch.cuda.empty_cache()
    launched = {k for k in ds.LAUNCHES if ds.LAUNCHES[k] != before[k]}
    flop = 2.0 * N * d * Hh
    tols = {"prod": F32_REL_TOL, "side_sums": depth_tol(L), "dw_prod": DW_PLAIN_REL_TOL,
            "dw_prod_vs_float64": depth_tol(N)}
    errs = {"prod": p_err / p_big, "side_sums": s_rel, "weighted_side_sums": ws_rel,
            "dw_prod": w_rel, "dw_prod_vs_float64": truth_rel}
    log("dense_f32_first_layer", batch=Bq, labels=L, rows=N, latent=d, width=Hh,
        rel_errs=errs, rel_tol=tols, first_add_same_bits_as_torch_add=add_same,
        side_sums_same_bits=side_same, dw_prod_same_bits=dw_same, prod_ms=prod_ms,
        prod_plain_ms=prod_plain_ms, cublas_prod_ms=prod_lib_ms,
        prod_tflops=flop / prod_ms / 1e9, dw_prod_ms=dw_ms, dw_prod_plain_ms=dw_plain_ms,
        cublas_dw_ms=dw_lib_ms, dw_tflops=flop / dw_ms / 1e9, side_sums_ms=side_ms,
        side_sums_plain_ms=side_plain_ms, launched=sorted(launched), card=card)
    if errs["prod"] > tols["prod"] or max(s_rel, ws_rel) > tols["side_sums"] or \
            w_rel > tols["dw_prod"] or truth_rel > tols["dw_prod_vs_float64"] or \
            not (side_same and dw_same):
        raise AssertionError(f"the dense first layer in float32 disagrees: {errs}, same bits "
                             f"{side_same} {dw_same}")
    if launched != set(DENSE_F32_KERNELS):
        raise AssertionError(f"the dense float32 kernels launched {sorted(launched)}")
    times["pair_train_prod_f32"] = {"max_abs_err": p_err, "ms": prod_ms,
                                    "plain_ms": prod_plain_ms,
                                    **bound(nbytes=N * Hh * 4, ops=flop, peak=SPLIT_FLOPS),
                                    "library_ms": prod_lib_ms}
    part_bytes = side_partial_bytes(Bq, L, Hh)
    times["pair_side_sums_f32"] = {"max_abs_err": s_abs, "ms": side_ms,
                                   "plain_ms": side_plain_ms,
                                   **bound(nbytes=N * Hh * 4 + (Bq + L) * Hh * 4),
                                   "library_ms": None, "partial_bytes": part_bytes,
                                   "floor_ms": bound(nbytes=N * Hh * 4 + (Bq + L) * Hh * 4 +
                                                     part_bytes)["bound_ms"]}
    times["pair_train_dw_prod_f32"] = {"max_abs_err": w_abs, "ms": dw_ms,
                                       "plain_ms": dw_plain_ms,
                                       **bound(nbytes=N * Hh * 4, ops=flop, peak=SPLIT_FLOPS),
                                       "library_ms": dw_lib_ms}
    for k in DENSE_F32_KERNELS:
        b_ = times[k]
        log(f"f32_kernel_{k}", **b_, bound_share=b_["bound_ms"] / b_["ms"], card=card)
    return times


def reset_scorer_launches() -> None:
    from protnote_tpu_torch.ops import pair_scorer as ps

    reset_dense_launches()
    for k in ps.F32_LAUNCHES:
        ps.F32_LAUNCHES[k] = 0
    reset_k7_launches()


def scorer_launch_counts() -> dict:
    """Every kernel count of the scorers (K1, K4, K4-bwd, K5, K6, the dense
    scorer's; each form) that is not 0."""
    from protnote_tpu_torch.ops import pair_scorer as ps

    return {**{k: v for k, v in dense_launch_counts().items() if v},
            **{k: v for k, v in ps.F32_LAUNCHES.items() if v}}


def f32_scorer_run(card: str, name: str, ds, batch: int, steps: int, params: dict,
                   schedule, grad_check=None) -> dict:
    """``Trainer.train`` with MIXED_PRECISION False and config keys
    ``params`` on the first ``steps`` batches of ``batch`` sequences of
    ``ds``: per-step losses (finite), median warm step ms, seqs/s, peak
    memory, the scorers' launches against ``schedule(steps)`` (every count
    not 0, and no other), two profiled steps (idle share, device ms a step
    by kernel); then ``grad_check(trainer)`` where given.  Returns the run's
    fields with its launches."""
    import statistics

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    pi_cfg, pn_cfg, ts = f32_models(**params)
    opt = Optimizer(TRAIN_PARAMS)
    ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"], ts["enc_params"],
                           ts["enc_state"], opt)
    trainer = Trainer(ts0, pi_cfg, pn_cfg, TrainerConfig(num_epochs=1,
                                                         decision_threshold=THRESHOLD),
                      device=dev, loss_fn=get_loss_fn(TRAIN_PARAMS), optimizer=opt)
    steps_, step_fn = [], trainer._train_step

    def timed_step(ts_, b, gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ts_, m = step_fn(ts_, b, gen)
        torch.cuda.synchronize()
        steps_.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"])))
        return ts_, m

    def batcher(seed=42):
        return BucketBatcher(ds, batch, buckets=(256, 512, 1024), shuffle=True,
                             drop_last=True, seed=seed, device_label_gather=True)

    trainer._train_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_scorer_launches()
    trainer.train(FirstBatches(batcher(), steps), None)
    torch.cuda.synchronize()
    launches = scorer_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer._train_step = step_fn
    losses = [x[1] for x in steps_]
    want = {k: v for k, v in schedule(len(steps_)).items() if v}
    if len(steps_) != steps or not all(math.isfinite(x) for x in losses) or \
            launches != want or k7.LAUNCHES["masked_conv_fwd_f32"] <= 0:
        raise AssertionError(f"float32 training {name}: {len(steps_)} steps, losses {losses}, "
                             f"launches {launches} (schedule {want}), K7 f32 "
                             f"{k7.LAUNCHES['masked_conv_fwd_f32']}")
    med = statistics.median([x[0] for x in steps_[1:]] or [steps_[0][0]])
    placed = []
    matrix = trainer._label_matrix_for(ds)
    for b in batcher(seed=7):
        placed.append(trainer._place(batch_to_device_dict(b, dev), matrix))
        if len(placed) == 2:
            break
    gen = torch.Generator(device=dev).manual_seed(1)
    it = iter(placed)

    def one_step():
        trainer.ts, _ = step_fn(trainer.ts, next(it), gen)

    wall, busy, top = device_profile(one_step, len(placed))
    result = {"steps": len(steps_), "sequences_per_step": batch, "labels": NUM_LABELS,
              "settings": params, "step_losses": losses, "grad_norms": [x[2] for x in steps_],
              "first_step_ms": steps_[0][0] * 1e3, "median_warm_step_ms": med * 1e3,
              "seqs_per_s": batch / med, "peak_mem_gb": peak, "launches": launches,
              "profiled_wall_ms_per_step": wall * 1e3 / len(placed),
              "device_busy_ms_per_step": None if busy is None else busy * 1e3 / len(placed),
              "idle_share": None if busy is None else 1.0 - busy / wall,
              "top_kernels_ms_per_step": top}
    log(f"f32_train_{name}", **result, card=card)
    del placed, it
    torch.cuda.empty_cache()
    if grad_check is not None:
        result["grad_check"] = grad_check(trainer)
    del trainer, ts0, ts
    torch.cuda.empty_cache()
    return result


def f32_step_grads(trainer, ds, batch: int, chains, card: str, run: str) -> dict:
    """One float32 step's gradients, new running statistics and loss on one
    batch of ``batch`` sequences from the same weights and generator seed
    through each of ``chains`` (name, ProtNote config, {(module, name):
    replacement} patched for the step); the first chain is the one under
    test, the second its reference and the third the reference with its
    first layer's output perturbed by a relative F32_Z_NOISE (the noise
    floor).  Held, each in L2 over the reference's leaf norm: every
    output-MLP leaf and running statistic within F32_GRAD_L2_TOL, every
    leaf within F32_GRAD_L2_TOL or twice the noise floor's distance, the
    loss within F32_GRAD_L2_TOL."""
    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, make_train_step

    class KeepGrads:
        def update(self, grads, trainable, state):
            self.grads = grads
            return state

    dev = torch.device("cuda")
    b0 = next(iter(BucketBatcher(ds, batch, buckets=(256, 512, 1024), shuffle=True,
                                 drop_last=True, seed=5, device_label_gather=True)))
    arrays = trainer._place(batch_to_device_dict(b0, dev), trainer._label_matrix_for(ds))
    names = {id(t): n for n, t in named_tensors(trainer.ts["trainable"]).items()}
    leaf_names = [names[id(t)] for t in tree_leaves(trainer.ts["trainable"])]
    runs = {}
    for name, cfg, patch in chains:
        keeper = KeepGrads()
        step = make_train_step(trainer.pi_cfg, cfg, get_loss_fn(TRAIN_PARAMS), keeper,
                               decision_threshold=THRESHOLD)
        saved = [(mod, k, getattr(mod, k)) for mod, k in patch]
        for (mod, k), v in patch.items():
            setattr(mod, k, v)
        try:
            ts, m = step(trainer.ts, arrays, torch.Generator(device=dev).manual_seed(3))
            torch.cuda.synchronize()
        finally:
            for mod, k, v in saved:
                setattr(mod, k, v)
        stats = tree_leaves(ts["model_state"]["output_mlp"])
        runs[name] = ([g.float() for g in keeper.grads], [t.float() for t in stats],
                      float(m["loss"]))
        del ts, keeper
        torch.cuda.empty_cache()
    test, ref, noise = (c[0] for c in chains)

    def l2(a, b):
        nb = float(b.norm())
        return float((a - b).norm()) / nb if nb > 0 else float((a - b).norm())

    rows = [{"leaf": n, test: l2(runs[test][0][i], runs[ref][0][i]),
             noise: l2(runs[noise][0][i], runs[ref][0][i])} for i, n in enumerate(leaf_names)]
    stat_rel = [l2(a, b) for a, b in zip(runs[test][1], runs[ref][1])]
    loss_rel = abs(runs[test][2] - runs[ref][2]) / abs(runs[ref][2])
    mlp = [r for r in rows if r["leaf"].startswith("/protnote/output_mlp")]
    bad = [r for r in rows if (r in mlp and r[test] > F32_GRAD_L2_TOL) or
           r[test] > max(F32_GRAD_L2_TOL, 2 * r[noise])]
    out = {"sequences": batch, "leaves": len(rows), "output_mlp_leaves": len(mlp),
           "max_output_mlp_l2_rel": max(r[test] for r in mlp),
           "max_l2_rel": max(r[test] for r in rows),
           "max_noise_floor_l2_rel": max(r[noise] for r in rows), "z_noise": F32_Z_NOISE,
           "max_stat_l2_rel": max(stat_rel) if stat_rel else 0.0, "loss_rel": loss_rel,
           "loss": runs[test][2], "loss_reference": runs[ref][2], "l2_tol": F32_GRAD_L2_TOL}
    log(f"f32_grad_check_{run}", **out, by_leaf=rows, card=card)
    if bad or max(stat_rel, default=0.0) > F32_GRAD_L2_TOL or loss_rel > F32_GRAD_L2_TOL or \
            not math.isfinite(out["loss"]):
        raise AssertionError(f"{run}: a float32 step's gradients, running statistics or loss "
                             f"differ from the reference chain's: {out}, {bad}")
    return out


def noisy(fn):
    """``fn`` with its (first) output perturbed by a relative F32_Z_NOISE of
    seeded normal noise."""
    import torch

    def f(*args):
        z = fn(*args)
        noise = torch.randn(z.shape, device=z.device,
                            generator=torch.Generator(device=z.device).manual_seed(9))
        return z.mul_(noise.mul_(F32_Z_NOISE).add_(1.0))

    return f


def phase_f32_streamed_training(card: str) -> dict:
    """Phase 33: ``Trainer.train`` with MIXED_PRECISION False and
    ``TRAIN_STREAMING_LABEL_TILE`` 2048 at full width (32 sequences x 32,102
    labels, H 3072), F32_STREAM_STEPS steps with the z1 cache by the rule
    and with ``TRAIN_STREAMING_CACHE False``: step ms, seqs/s, peak memory,
    idle share and kernel ms by name, the launches against
    ``streamed_launches(..., float32)`` a step (K4 f32, K4-bwd f32 and K6
    f32; no bf16 form, no K5); then one step on a 16-sequence batch through
    the streamed scorer against the decomposed float32 scorer (the same
    function) by :func:`f32_step_grads`, K4 f32's output perturbed for the
    noise floor.  Returns the launches summed over both runs."""
    import dataclasses
    import tempfile

    import torch

    from protnote_tpu_torch.data.dataset import DatasetConfig
    from protnote_tpu_torch.ops import streaming_train as st

    types = ("name", "label")
    cfg = DatasetConfig(dataset_type="train", label_augmentation_descriptions=types,
                        inference_go_descriptions=types,
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    tiles = -(-NUM_LABELS // STREAM_TILE)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = fasta_dataset(tmp, "f32_stream.fasta", TRAIN_B * (F32_STREAM_STEPS + 2), 35, cfg)
    cache_rule = st.streaming_cache_first(TRAIN_B, tiles * STREAM_TILE, STREAM_TILE, H, 4, 3,
                                          torch.device("cuda"))

    def grad_check(trainer):
        dec = dataclasses.replace(trainer.pn_cfg, train_label_tile=0)
        return f32_step_grads(trainer, ds, F32_GRAD_B, (
            ("streamed", trainer.pn_cfg, {}), ("decomposed", dec, {}),
            ("z_noise", dec, {(st, "_pair_hidden_fwd_cuda"): noisy(st._pair_hidden_fwd_cuda)})),
            card, "streamed_vs_decomposed")

    for name, cache in (("streamed_cache_rule", None), ("streamed_cache_off", False)):
        on = cache_rule if cache is None else cache
        per_step = st.streamed_launches(3, tiles, on, torch.float32)
        run = f32_scorer_run(
            card, name, ds, TRAIN_B, F32_STREAM_STEPS,
            {"TRAIN_STREAMING_LABEL_TILE": STREAM_TILE, "TRAIN_STREAMING_CACHE": cache},
            lambda n, per_step=per_step: {k: v * n for k, v in per_step.items()},
            grad_check if cache is None else None)
        log(f"f32_streamed_{name}", cache_first=on, launches_per_step=per_step,
            median_warm_step_ms=run["median_warm_step_ms"], peak_mem_gb=run["peak_mem_gb"],
            card=card)
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_f32_dense_training(card: str) -> dict:
    """Phase 34: ``Trainer.train`` with MIXED_PRECISION False and
    ``PAIR_BACKEND dense`` at DENSE_F32_B sequences x 32,102 labels (the
    batch whose eight (B x L, 3072) float32 tensors the card holds),
    F32_DENSE_STEPS steps of each of ``F32_DENSE_SETTINGS`` (dropout 0.1
    with BatchNorm; dropout, ``concatenation_prod``, no BatchNorm and
    ``GRADIENT_CHECKPOINTING``): step ms, seqs/s, peak memory, idle share,
    kernel ms by name, the launches against ``dense_launches(...,
    float32)`` a step and no other scorer kernel; after the first setting,
    one step on a DENSE_F32_GRAD_B-sequence batch through the kernels
    against the plain
    float32 dense scorer (the same dropout masks) by
    :func:`f32_step_grads`, the plain first layer's output perturbed for
    the noise floor.  Returns the launches summed over the settings."""
    import tempfile

    import torch

    from protnote_tpu_torch.data.dataset import DatasetConfig
    from protnote_tpu_torch.models import fusion
    from protnote_tpu_torch.ops import dense_scorer as ds

    types = ("name", "label")
    cfg = DatasetConfig(dataset_type="train", label_augmentation_descriptions=types,
                        inference_go_descriptions=types,
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        data = fasta_dataset(tmp, "f32_dense.fasta", DENSE_F32_B * (F32_DENSE_STEPS + 2), 37, cfg)

    def grad_check(trainer):
        return f32_step_grads(trainer, data, DENSE_F32_GRAD_B, (
            ("kernels", trainer.pn_cfg, {}),
            ("plain", trainer.pn_cfg, {(fusion, "pair_logits_dense"):
                                       ds.pair_logits_dense_reference}),
            ("z_noise", trainer.pn_cfg, {(fusion, "pair_logits_dense"):
                                         ds.pair_logits_dense_reference,
                                         (ds, "_first_fwd_plain"): noisy(ds._first_fwd_plain)})),
            card, "dense_vs_plain")

    total = {}
    for i, (name, extra) in enumerate(F32_DENSE_SETTINGS):
        params = {"PAIR_BACKEND": "dense", **extra}
        _, pn_cfg, _ = f32_models(**params)
        per_step = ds.dense_launches(
            pn_cfg.output_mlp_num_layers, True, pn_cfg.output_mlp_batchnorm,
            pn_cfg.feature_fusion == "concatenation_prod",
            remat=pn_cfg.gradient_checkpointing, dtype=torch.float32)
        run = f32_scorer_run(card, f"dense_{name}", data, DENSE_F32_B, F32_DENSE_STEPS, params,
                             lambda n, per_step=per_step: {k: v * n for k, v in per_step.items()},
                             grad_check if i == 0 else None)
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_f32_dense_eval(card: str) -> dict:
    """Phase 35: ``Trainer.evaluate`` with MIXED_PRECISION False and
    ``PAIR_BACKEND dense`` on an F32_SEQUENCES-sequence FASTA: the first layer
    through ``pair_first_add_f32``, eval BN + ReLU through K6's
    ``affine_relu_f32``, K3 after; seqs/s of a second (warm) pass,
    launches (no K1), finite metrics, and the first batch's logits against
    the plain float32 dense scorer's within F32_REL_TOL of their largest
    |value|.  Returns its dense-scorer launches."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from protnote_tpu_torch.data.dataset import DatasetConfig
    from protnote_tpu_torch.models import fusion
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = DatasetConfig(dataset_type="test", inference_go_descriptions=("name", "label"),
                        inference_descriptions_per_label=K_DESCRIPTIONS)
    with tempfile.TemporaryDirectory() as tmp:
        data = fasta_dataset(tmp, "eval_f32_dense.fasta", F32_SEQUENCES, 43, cfg)
        batcher = eval_batcher(data)
    pi_cfg, pn_cfg, ts = f32_models(PAIR_BACKEND="dense")
    trainer = Trainer(ts, pi_cfg, pn_cfg,
                      TrainerConfig(decision_threshold=THRESHOLD, estimate_map=True),
                      device="cuda")
    trainer.evaluate(batcher)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_scorer_launches()
    for k in k3.LAUNCHES:
        k3.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    metrics = trainer.evaluate(batcher)["metrics"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {**scorer_launch_counts(),
                **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}}
    if set(k for k in launches if not k.startswith("eval_acc")) != \
            {"pair_first_add_f32", "affine_relu_f32"} or launches["eval_acc_update"] <= 0:
        raise AssertionError(f"float32 dense evaluation launched {launches}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"float32 dense evaluation: non-finite metrics {metrics}")
    batch = next(iter(batcher))
    arrays = trainer._place(batch_to_device_dict(batch, trainer.device),
                            trainer._label_matrix_for(data))
    arrays = trainer._swap_in_latents(arrays, trainer._label_latents(arrays))
    got = trainer._eval_step(trainer.ts, arrays)["logits"]
    with mock.patch.object(fusion, "pair_logits_dense", ds.pair_logits_dense_reference):
        want = trainer._eval_step(trainer.ts, arrays)["logits"]
    err = f32_close("dense_eval_logits", got, want)
    log("f32_dense_eval", sequences=len(data), seconds=sec, seqs_per_s=len(data) / sec,
        batch_ms=sec * 1e3 / len(batcher), chunk_rows=ds.EVAL_CHUNK_ROWS, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, logits=err,
        logit_std=float(want.std()), metrics=metrics, card=card)
    del trainer
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if k in DENSE_F32_KERNELS}


# ----------------------------------------------------------------------
# training the encoder in float32 (phases 36-37)

F32_ENC_STEPS = 5  # float32 encoder-training steps at bucket 512 (the first warms up)
F32_ENC_BN_STEPS = 3  # ENCODER_BN_TRAIN_MODE steps
F32_ENC_GRAD_B = 16  # the gradient check's batch
F32_ENC_PROFILE_STEPS = 2
F32_ENC_CLI_SEQUENCES = 128  # the CLI run's training FASTA (lengths 100-1000)


def k7_f32_schedule(steps: int, cfg) -> dict:
    """K7's launches over ``steps`` float32 encoder-training steps: each conv
    forward and dW once (11), dX on all but conv1 (10), each BatchNorm
    forward and backward once (10 + 10), the pool and its transpose once;
    nothing else of K7."""
    from protnote_tpu_torch.ops import masked_conv as k7

    convs, bns = 1 + 2 * cfg.num_resnet_blocks, 2 * cfg.num_resnet_blocks
    want = {"masked_conv_fwd_f32": convs, "masked_conv_dx_f32": convs - 1,
            "masked_conv_dw_f32": convs, "masked_bn_relu_fwd_f32": bns,
            "masked_bn_relu_bwd_f32": bns, "masked_mean_pool_f32": 1,
            "masked_mean_pool_bwd_f32": 1}
    return {k: steps * want.get(k, 0) for k in k7.LAUNCHES}


def dw_float64(x, dy, lengths, taps: int, dilation: int):
    """A masked conv's dW and dbias in float64 on the card: a tap's dW the
    product of the masked input shifted by the tap with the masked output
    gradient over every (b, t)."""
    import torch

    from protnote_tpu_torch.ops import masked_conv as k7

    T = x.shape[1]
    mask = k7.valid_mask(lengths, T).double()
    xm, gm = x.double() * mask, dy.double() * mask
    g2 = gm.reshape(-1, gm.shape[2])
    dw = []
    for j in range(taps):
        s = dilation * (j - (taps - 1) // 2)
        shifted = torch.zeros_like(xm)
        if abs(s) < T:
            if s >= 0:
                shifted[:, :T - s] = xm[:, s:]
            else:
                shifted[:, -s:] = xm[:, :T + s]
        dw.append(shifted.reshape(-1, xm.shape[2]).T @ g2)
    return torch.stack(dw), g2.sum(0)


def phase_k7_f32_train_kernels(card: str) -> dict:
    """Phase 36: K7's float32 training kernels alone at full width (1,100
    channels, 5 blocks, 32 sequences at bucket 512, lengths 30-512, one row
    dropped by the example mask), on random float32 activations and
    cotangents at the chain's padded pitch: ``masked_conv_dx_f32`` on the 10
    block convs against the plain float32 autograd (cuDNN, TF32 off) within
    1e-5 of its largest |value|, zero past each length; ``masked_conv_dw_f32``
    (dW and dbias) on all 11 against float64 (:func:`dw_float64`) within
    1e-5; K7-BN's float32 forward and backward on the 10 BatchNorms against
    the plain float32 BatchNorm (y, running statistics) and the plain
    backward on the kernel's statistics (dx, dscale, dbias), within 1e-5;
    the float32 pool transpose bit for bit.  Each the same bits
    twice.  A wide-range case: the first dilated conv's x and dy offset by
    300 (every third piece of the split carries bits), dX and dW within
    1e-5 as above.  Times from CUDA events of a step's calls beside the
    bound (the products these lengths need over the split's 165 TFLOP/s,
    and over the FMA pipe's 67 beside it; the BN's and the transpose's
    bytes over the memory rate), the plain versions' (the backward alone,
    on a retained graph) and cuDNN's float32 ``conv1d_input`` /
    ``conv1d_weight`` (TF32 off; the library time, never called by the
    port); the transpose's device time (``torch.profiler``, taken again
    where a profile holds no device event); the kernels' ptxas registers
    and spills."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.layers import gemm_precision, tree_to
    from protnote_tpu_torch.models.proteinfer import (
        BN_EPS,
        BN_MOMENTUM,
        ProteInferConfig,
        init_proteinfer,
        one_hot_sequences,
    )
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    dev, f32, T = torch.device("cuda"), torch.float32, 512
    gemm_precision(f32)
    cfg = ProteInferConfig()
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    params, state = tree_to(params, dev), tree_to(state, dev)
    rng = np.random.default_rng(36)
    lens = k7_lengths(rng, T)
    lengths = torch.from_numpy(lens).to(dev)
    gen = torch.Generator(device=dev).manual_seed(37)

    def act(c, shift=0.0):
        return k7.pad_pitch(torch.randn(B, T, c, generator=gen, device=dev) + shift)

    ids = torch.from_numpy(rng.integers(0, 21, (B, T))).to(dev)
    pad_rows = torch.arange(T, device=dev)[None, :] >= lengths[:, None].long()
    errs = {"dx": [], "dw": [], "db": []}
    same, dx_zero = True, True
    dx_calls, dw_calls, plain_dx, plain_dw, lib_dx, lib_dw = [], [], [], [], [], []
    for name, p, d in k7_convs(params, cfg):
        w, b = p["kernel"].contiguous(), p["bias"]
        taps, cin, cout = w.shape
        pad = d * (taps - 1) // 2
        x = (k7.pad_pitch(one_hot_sequences(ids, cfg.input_channels, f32)) if name == "conv1"
             else k7.pad_pitch(torch.relu(act(cin))))
        dy = act(cout)
        dw, db = k7.masked_conv_dw_f32_cuda(x, dy, lengths, taps, d)
        dw2, db2 = k7.masked_conv_dw_f32_cuda(x, dy, lengths, taps, d)
        same = same and torch.equal(dw, dw2) and torch.equal(db, db2)
        truth_w, truth_b = dw_float64(x, dy, lengths, taps, d)
        errs["dw"].append(rel_max(dw, truth_w))
        errs["db"].append(rel_max(db, truth_b))
        del truth_w, truth_b, dw2, db2
        xg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
        y = k7.masked_conv_reference(xg, wg, bg, lengths, d)
        x_t, dy_t = (t.contiguous().transpose(1, 2).contiguous() for t in (x, dy))
        w_t = w.permute(2, 1, 0).contiguous()
        plain_dw.append(lambda y=y, wg=wg, bg=bg, dy=dy: torch.autograd.grad(
            y, [wg, bg], dy, retain_graph=True))
        lib_dw.append(lambda x_t=x_t, w_t=w_t, dy_t=dy_t, pad=pad, d=d:
                      torch.nn.grad.conv1d_weight(x_t, w_t.shape, dy_t, padding=pad, dilation=d))
        dw_calls.append((x, dy, taps, d))
        if name != "conv1":
            dx = k7.masked_conv_dx_f32_cuda(dy, w, lengths, d)
            same = same and torch.equal(dx, k7.masked_conv_dx_f32_cuda(dy, w, lengths, d))
            dx_zero = dx_zero and not bool(dx[pad_rows].any())
            (gx,) = torch.autograd.grad(y, [xg], dy, retain_graph=True)
            errs["dx"].append(rel_max(dx, gx))
            del dx, gx
            plain_dx.append(lambda y=y, xg=xg, dy=dy: torch.autograd.grad(
                y, [xg], dy, retain_graph=True))
            lib_dx.append(lambda x_t=x_t, w_t=w_t, dy_t=dy_t, pad=pad, d=d:
                          torch.nn.grad.conv1d_input(x_t.shape, w_t, dy_t, padding=pad,
                                                     dilation=d))
            dx_calls.append((dy, w, d))
    # the wide-range case on the first dilated conv
    x0, dy0, _, d0 = dw_calls[1]
    w0 = dx_calls[0][1]
    xw, dyw = k7.pad_pitch(x0 + 300.0), k7.pad_pitch(dy0 + 300.0)
    dx = k7.masked_conv_dx_f32_cuda(dyw, w0, lengths, d0)
    dw, db = k7.masked_conv_dw_f32_cuda(xw, dyw, lengths, w0.shape[0], d0)
    same = same and torch.equal(dx, k7.masked_conv_dx_f32_cuda(dyw, w0, lengths, d0))
    xg = xw.detach().clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(k7.masked_conv_reference(xg, w0, torch.zeros_like(dyw[0, 0]),
                                                         lengths, d0), [xg], dyw)
    truth_w, truth_b = dw_float64(xw, dyw, lengths, w0.shape[0], d0)
    wide = {"dx": rel_max(dx, gx), "dw": rel_max(dw, truth_w), "db": rel_max(db, truth_b)}
    del xw, dyw, dx, dw, db, xg, gx, truth_w, truth_b
    dx_ms = cuda_time_ms(lambda: [k7.masked_conv_dx_f32_cuda(dy, w, lengths, d)
                                  for dy, w, d in dx_calls], 3)
    layouts = [k7.conv_weight_layout_f32(w, dx=True) for _, w, _ in dx_calls]
    dx_kernel_ms = cuda_time_ms(lambda: [
        k7.masked_conv_dx_f32_cuda(dy, w, lengths, d, layout=lay)
        for (dy, w, d), lay in zip(dx_calls, layouts)], 3)
    dw_ms = cuda_time_ms(lambda: [k7.masked_conv_dw_f32_cuda(x, dy, lengths, taps, d)
                                  for x, dy, taps, d in dw_calls], 3)
    dw_plans = [k7._dw_plan_on(lengths, T, taps, d, x.shape[2], dy.shape[2], dev, f32=True)
                for x, dy, taps, d in dw_calls]
    flop_dx = k7_flops(lens, T, params, cfg, skip_conv1=True)
    flop_dw = k7_flops(lens, T, params, cfg)
    out = {}
    for key, ms, plain, lib, flop, names in (
            ("masked_conv_dx_f32", dx_ms, plain_dx, lib_dx, flop_dx, ("dx",)),
            ("masked_conv_dw_f32", dw_ms, plain_dw, lib_dw, flop_dw, ("dw", "db"))):
        out[key] = {"max_abs_err": max(e for n in names for e, _ in errs[n]),
                    "max_rel_err": max(r for n in names for _, r in errs[n]), "ms": ms,
                    "plain_ms": cuda_time_ms(lambda: [f() for f in plain], 2),
                    **bound(ops=flop, peak=SPLIT_FLOPS),
                    "fma_bound_ms": bound(ops=flop, peak=F32_FLOPS)["bound_ms"],
                    "library_ms": cuda_time_ms(lambda: [f() for f in lib], 2),
                    "tflops": flop / ms / 1e9, "calls": len(plain)}
        out[key]["share_of_bound"] = out[key]["bound_ms"] / ms
    out["masked_conv_dx_f32"]["kernel_only_ms"] = dx_kernel_ms
    out["masked_conv_dx_f32"]["zero_past_lengths"] = dx_zero
    out["masked_conv_dw_f32"].update(splits=[pl.splits for pl in dw_plans],
                                     items=[pl.items for pl in dw_plans],
                                     against="float64")
    del plain_dx, plain_dw, lib_dx, lib_dw, dx_calls, dw_calls, layouts
    torch.cuda.empty_cache()

    # K7-BN in float32 on the 10 BatchNorms, one row dropped by the example mask
    em = torch.ones(B, device=dev)
    em[3] = 0.0
    bn_errs = {"y": [], "stats": [], "dx": [], "sums": []}
    items = []
    for bp, bs in zip(params["blocks"], state["blocks"]):
        for n in ("bn1", "bn2"):
            p, s = bp[n], bs[n]
            C = p["scale"].shape[0]
            x, g = act(C, 0.3), act(C)
            fwd = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"], s["var"],
                                                 lengths, em, BN_EPS, BN_MOMENTUM)
            y, mean, var, stats, counts = fwd
            bwd = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
            fwd2 = k7.masked_bn_relu_forward_cuda(x, p["scale"], p["bias"], s["mean"],
                                                  s["var"], lengths, em, BN_EPS, BN_MOMENTUM)
            bwd2 = k7.masked_bn_relu_backward_cuda(x, g, p["scale"], stats, counts, lengths, em)
            same = same and all(torch.equal(a, c) for a, c in zip(fwd + bwd, fwd2 + bwd2))
            y0, new0 = k7.masked_bn_relu_reference(x, p, s, lengths, em, BN_EPS, BN_MOMENTUM)
            dx0, ds0, db0 = k7.masked_bn_relu_backward_reference(x, g, p["scale"], stats, counts,
                                                                 lengths, em)
            bn_errs["y"].append(rel_max(y, y0))
            bn_errs["stats"] += [rel_max(mean, new0["mean"]), rel_max(var, new0["var"])]
            bn_errs["dx"].append(rel_max(bwd[0], dx0))
            bn_errs["sums"] += [rel_max(bwd[1], ds0), rel_max(bwd[2], db0)]
            same = same and not any(bool(padding_channels(t).any()) for t in (y, bwd[0]))
            items.append((p, s, x, g, stats, counts))
            del fwd, fwd2, bwd, bwd2, y0, dx0
    elems = sum(B * T * p["scale"].shape[0] for p, *_ in items)
    fwd_calls = lambda: [k7.masked_bn_relu_forward_cuda(  # noqa: E731
        x, p["scale"], p["bias"], s["mean"], s["var"], lengths, em, BN_EPS, BN_MOMENTUM)
        for p, s, x, *_ in items]
    bwd_calls = lambda: [k7.masked_bn_relu_backward_cuda(  # noqa: E731
        x, g, p["scale"], stats, counts, lengths, em) for p, s, x, g, stats, counts in items]
    for key, calls, plain, nbytes, names in (
            ("masked_bn_relu_fwd_f32", fwd_calls,
             lambda: [k7.masked_bn_relu_reference(x, p, s, lengths, em, BN_EPS, BN_MOMENTUM)
                      for p, s, x, *_ in items], 4.0 * 2 * elems, ("y", "stats")),
            ("masked_bn_relu_bwd_f32", bwd_calls,
             lambda: [k7.masked_bn_relu_backward_reference(x, g, p["scale"], stats, counts,
                                                           lengths, em)
                      for p, s, x, g, stats, counts in items], 4.0 * 3 * elems,
             ("dx", "sums"))):
        out[key] = {"max_abs_err": max(e for n in names for e, _ in bn_errs[n]),
                    "max_rel_err": max(r for n in names for _, r in bn_errs[n]),
                    "ms": cuda_time_ms(calls, 5), "plain_ms": cuda_time_ms(plain, 3),
                    **bound(nbytes=nbytes), "library_ms": None, "calls": len(items)}
        out[key]["device_ms"], out[key]["host_ms"] = device_and_host_ms(calls, 3)
        out[key]["share_of_bound"] = out[key]["bound_ms"] / out[key]["ms"]
    del items
    torch.cuda.empty_cache()

    # the pool's transpose in float32
    C = cfg.output_channels
    g = torch.randn(B, C, generator=gen, device=dev)
    got = k7.masked_mean_pool_backward_cuda(g, lengths, T, f32)
    again = k7.masked_mean_pool_backward_cuda(g, lengths, T, f32)
    want = k7.masked_mean_pool_backward_reference(g, lengths, T, f32)
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731
    pool_equal = torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
    pool_equal = pool_equal and not bool(padding_channels(got).any())
    kernel = lambda: k7.masked_mean_pool_backward_cuda(g, lengths, T, f32)  # noqa: E731
    out["masked_mean_pool_bwd_f32"] = {
        "max_abs_err": float((got - want).abs().max()), "ms": cuda_time_ms(kernel, 20),
        "plain_ms": cuda_time_ms(lambda: k7.masked_mean_pool_backward_reference(
            g, lengths, T, f32), 20),
        **bound(nbytes=4.0 * B * C + 4.0 * B + 4.0 * B * T * got.stride(1)),
        "library_ms": None, "bit_equal": pool_equal}
    for reps in (20, 100, 400):  # a profile that held no device event is taken again
        device_ms, host_ms = device_and_host_ms(kernel, reps)
        if device_ms is not None:
            break
    out["masked_mean_pool_bwd_f32"].update(device_ms=device_ms, host_ms=host_ms,
                                           device_reps=reps)
    ptxas = ptxas_by_kernel(load_kernel_library("masked_conv_f32").build_log, K7_F32_PTXAS)
    log("k7_f32_train", batch=B, bucket=T, lengths=[int(n) for n in lens], kernels=out,
        same_bits=same, ptxas=ptxas, wide_range=wide, rel_tol=K7_F32_REL_TOL, card=card)
    worst = {k: max(r for _, r in v) for k, v in {**errs, **bn_errs}.items()}
    worst.update({f"wide {k}": r for k, (_, r) in wide.items()})
    if any(v > K7_F32_REL_TOL for v in worst.values()) or not same or not dx_zero or \
            not pool_equal:
        raise AssertionError(f"K7's float32 training kernels disagree with their plain "
                             f"versions: {worst}, same bits {same}, dX zero past the lengths "
                             f"{dx_zero}, pool transpose equal {pool_equal}")
    return out


def phase_f32_encoder_training(card: str) -> dict:
    """Phase 37: training the encoder in float32 (MIXED_PRECISION False) at
    full width through ``Trainer.train``: ``train_sequence_encoder`` for
    F32_ENC_STEPS steps of 32 sequences at bucket 512 through the decomposed
    float32 scorer (step ms, seqs/s, peak memory, the launches against
    :func:`k7_f32_schedule` and no bf16 K7 kernel, the scorer's float32
    kernels against ``f32_train_schedule``), two profiled steps (idle share,
    kernel ms by name), the encoder's gradients and new running statistics
    on a 16-sequence batch with one row dropped by the example mask against
    the plain float32 chain under one fixed cotangent (1e-4 in L2 by leaf,
    statistics 1e-5); then ``cli/main.py --train-path-name`` with
    ``--override MIXED_PRECISION False TRAIN_SEQUENCE_ENCODER True`` on a
    128-sequence FASTA (one epoch, K7's float32 training kernels launched);
    then ``encoder_bn_train_mode`` alone for F32_ENC_BN_STEPS steps (the
    running statistics move, the weights do not, no backward kernel of K7).
    Returns the first run's launches of K7's float32 kernels."""
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.cli import main as train_cli
    from protnote_tpu_torch.core.config import (
        generate_label_embedding_path,
        load_config,
        resolve_paths,
    )
    from protnote_tpu_torch.data.batching import BucketBatcher
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache
    from protnote_tpu_torch.ops import masked_conv as k7
    from protnote_tpu_torch.ops import streaming_train as st
    from protnote_tpu_torch.train.losses import get_loss_fn
    from protnote_tpu_torch.train.optim import Optimizer, tree_leaves
    from protnote_tpu_torch.train.step import batch_to_device_dict, init_train_state
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, _ = train_datasets(tmp)
        pi_cfg, pn_cfg, ts = f32_models()

        def make(train_encoder: bool, bn_train: bool):
            opt = Optimizer(TRAIN_PARAMS)
            ts0 = init_train_state(ts["trainable"]["protnote"], ts["model_state"],
                                   ts["enc_params"], ts["enc_state"], opt,
                                   train_sequence_encoder=train_encoder)
            tcfg = TrainerConfig(num_epochs=1, decision_threshold=THRESHOLD, estimate_map=True,
                                 checkpoint_dir=tmp, run_name="f32_encoder")
            return Trainer(ts0, pi_cfg, pn_cfg, tcfg, device=dev,
                           loss_fn=get_loss_fn(TRAIN_PARAMS), optimizer=opt,
                           train_sequence_encoder=train_encoder, encoder_bn_train_mode=bn_train)

        def batcher(seed=42):
            return BucketBatcher(train_ds, TRAIN_B, buckets=(512,), shuffle=True,
                                 drop_last=True, seed=seed, device_label_gather=True)

        def run(name, trainer, steps_n):
            steps, step_fn = [], trainer._train_step

            def timed_step(ts_, batch, g):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ts_, m = step_fn(ts_, batch, g)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t, float(m["loss"]), float(m["grad_norm"])))
                return ts_, m

            trainer._train_step = timed_step
            reset_k7_launches()
            for k in st.LAUNCHES:
                st.LAUNCHES[k] = 0
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer.train(FirstBatches(batcher(), steps_n), None)
            torch.cuda.synchronize()
            trainer._train_step = step_fn
            losses = [x[1] for x in steps]
            med = statistics.median([x[0] for x in steps[1:]] or [steps[0][0]])
            fields = dict(steps=len(steps), sequences_per_step=TRAIN_B, bucket=512,
                          step_losses=losses, grad_norms=[x[2] for x in steps],
                          first_step_ms=steps[0][0] * 1e3, median_warm_step_ms=med * 1e3,
                          seqs_per_s=TRAIN_B / med,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                          k7_launches=dict(k7.LAUNCHES),
                          scorer_launches={k: v for k, v in st.LAUNCHES.items() if v})
            if len(steps) != steps_n or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"float32 encoder training {name}: {fields}")
            return fields

        # TRAIN_SEQUENCE_ENCODER in float32
        trainer = make(True, False)
        fields = run("train_sequence_encoder", trainer, F32_ENC_STEPS)
        want = k7_f32_schedule(F32_ENC_STEPS, pi_cfg)
        if fields["k7_launches"] != want or \
                fields["scorer_launches"] != f32_train_schedule(F32_ENC_STEPS, False):
            raise AssertionError(f"float32 encoder training's launches {fields['k7_launches']}"
                                 f" (schedule {want}), scorer {fields['scorer_launches']}")
        result = {k: fields["k7_launches"][k] for k in K7_F32 + K7_F32_TRAIN}
        placed = []
        matrix = trainer._label_matrix_for(train_ds)
        for b in batcher(seed=7):
            placed.append(trainer._place(batch_to_device_dict(b, dev), matrix))
            if len(placed) == F32_ENC_PROFILE_STEPS:
                break
        gen = torch.Generator(device=dev).manual_seed(1)
        it = iter(placed)
        step_fn = trainer._train_step

        def one_step():
            trainer.ts, _ = step_fn(trainer.ts, next(it), gen)

        wall, busy, top = device_profile(one_step, F32_ENC_PROFILE_STEPS)
        n = F32_ENC_PROFILE_STEPS
        fields.update(profile_wall_ms_per_step=wall * 1e3 / n,
                      profile_device_busy_ms_per_step=None if busy is None else busy * 1e3 / n,
                      idle_share=None if busy is None else 1.0 - busy / wall,
                      top_kernels_ms_per_step=top)
        grad_batch = {k: placed[0][k][:F32_ENC_GRAD_B].clone()
                      for k in ("aa_ids", "lengths", "example_mask")}
        grad_batch["example_mask"][3] = 0.0
        del placed, it
        torch.cuda.empty_cache()
        fields["grad_check"] = encoder_grad_check(trainer, grad_batch, pi_cfg, torch.float32,
                                                  F32_GRAD_L2_TOL, K7_F32_REL_TOL, F32_Z_NOISE)
        log("f32_encoder_train", run="train_sequence_encoder", **fields, card=card)
        summary["train_sequence_encoder"] = {
            k: fields[k] for k in ("median_warm_step_ms", "seqs_per_s", "peak_mem_gb",
                                   "idle_share")}
        summary["grad_check_worst"] = fields["grad_check"]["max_leaf_rel_l2"]
        summary["stats_rel_err"] = fields["grad_check"]["stats_rel_err"]
        del trainer, grad_batch
        torch.cuda.empty_cache()

        # ENCODER_BN_TRAIN_MODE alone: the encoder frozen, its BatchNorm on batch statistics
        trainer = make(False, True)
        fields = run("encoder_bn_train_mode", trainer, F32_ENC_BN_STEPS)
        launches = fields["k7_launches"]
        moved = max(float((x - y.to(dev)).abs().max())
                    for x, y in zip(tree_leaves(trainer.ts["enc_state"]),
                                    tree_leaves(ts["enc_state"])))
        frozen = all(torch.equal(x, y.to(dev)) for x, y in zip(
            tree_leaves(trainer.ts["enc_params"]), tree_leaves(ts["enc_params"])))
        bn_want = {k: F32_ENC_BN_STEPS * v for k, v in (
            ("masked_conv_fwd_f32", 1 + 2 * pi_cfg.num_resnet_blocks),
            ("masked_bn_relu_fwd_f32", 2 * pi_cfg.num_resnet_blocks),
            ("masked_mean_pool_f32", 1))}
        if launches != {k: bn_want.get(k, 0) for k in launches} or moved == 0.0 or not frozen:
            raise AssertionError(f"float32 ENCODER_BN_TRAIN_MODE: launches {launches}, running "
                                 f"statistics moved {moved}, weights frozen {frozen}")
        log("f32_encoder_train", run="encoder_bn_train_mode", **fields, stats_moved=moved,
            card=card)
        summary["bn_train_mode_step_ms"] = fields["median_warm_step_ms"]
        del trainer
        torch.cuda.empty_cache()

    # the CLI: cli/main.py training with the encoder in float32
    with tempfile.TemporaryDirectory() as tmp, protnote_env(tmp):
        config = resolve_paths(load_config())
        paths = config["paths_resolved"]
        emb_path = generate_label_embedding_path(config["params"],
                                                 paths["GO_BASE_LABEL_EMBEDDING_PATH"])
        _, _, cache = label_cache()
        LabelEmbeddingCache.save(emb_path, cache.embeddings, cache.ids, cache.description_types,
                                 cache.descriptions, cache.token_counts)
        del cache
        write_fasta(paths["TRAIN_DATA_PATH"], F32_ENC_CLI_SEQUENCES, 38, labeled=True)
        reset_k7_launches()
        t0 = time.perf_counter()
        metrics = train_cli.main(["--train-path-name", "TRAIN_DATA_PATH", "--override",
                                  "MIXED_PRECISION", "False", "TRAIN_SEQUENCE_ENCODER", "True",
                                  "NUM_EPOCHS", "1", "EXTRACT_VOCABULARIES_FROM", "null"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(k7.LAUNCHES)
        history = metrics["train_summary"]["history"]
        cli = {"seconds": cli_s, "sequences": F32_ENC_CLI_SEQUENCES, "epochs": len(history),
               "train_loss": history[-1].get("loss") if history else None,
               "launches": {k: v for k, v in launches.items() if v}}
        log("f32_encoder_train_cli", **cli, card=card)
        if len(history) != 1 or any(launches[k] <= 0 for k in K7_F32_TRAIN) or any(
                launches[k] for k in launches if k not in K7_F32 + K7_F32_TRAIN):
            raise AssertionError(f"cli/main.py float32 encoder training: {cli}")
        summary["cli_seconds"] = cli_s
    log("f32_encoder_training", **summary, card=card)
    torch.cuda.empty_cache()
    return result


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
    k7_f32 = phase_k7_f32(card)
    torch.cuda.empty_cache()
    phase_predict(card)
    torch.cuda.empty_cache()
    f32_launches = phase_test_proteinfer(card)["launches"]
    torch.cuda.empty_cache()
    f32_times = phase_f32_kernels(card, k2)
    torch.cuda.empty_cache()
    f32_paths = phase_f32_paths(card)
    torch.cuda.empty_cache()
    f32_train_times = phase_f32_train_kernels(card)
    torch.cuda.empty_cache()
    f32_train_launches = phase_f32_training(card)
    torch.cuda.empty_cache()
    f32_sd_times = phase_stream_dense_f32_kernels(card)
    torch.cuda.empty_cache()
    f32_sd_launches = phase_f32_streamed_training(card)
    torch.cuda.empty_cache()
    for counts in (phase_f32_dense_training(card), phase_f32_dense_eval(card)):
        for k, v in counts.items():
            f32_sd_launches[k] = f32_sd_launches.get(k, 0) + v
    torch.cuda.empty_cache()
    k7_f32_train_times = phase_k7_f32_train_kernels(card)
    torch.cuda.empty_cache()
    f32_enc_launches = phase_f32_encoder_training(card)
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
    del plain_rows
    torch.cuda.empty_cache()
    k8_bwd_times = phase_k8_bwd(card)
    bwd_launches = phase_tower_training(card)
    torch.cuda.empty_cache()
    k8_f32_times = phase_k8_f32(card)
    tower_f32_launches = phase_tower_f32(card, rows)
    del rows
    torch.cuda.empty_cache()
    tower_f32_bwd = phase_tower_training(card, f32=True)
    torch.cuda.empty_cache()
    k7_bwd = phase_k7_bwd(card)
    torch.cuda.empty_cache()
    encoder_launches, _ = phase_encoder_training(card)
    torch.cuda.empty_cache()
    k6_times = phase_k6(card)
    torch.cuda.empty_cache()
    phase_streamed_scorer(card)
    torch.cuda.empty_cache()
    stream_launches = phase_streamed_training(card)
    torch.cuda.empty_cache()
    dense_times = phase_dense_kernels(card)
    torch.cuda.empty_cache()
    dense_launches = phase_dense_training(card)
    torch.cuda.empty_cache()
    for counts in (phase_dense_eval(card), phase_dense_serving(card)):
        for k, v in counts.items():
            dense_launches[k] = dense_launches.get(k, 0) + v
    if "jax" in sys.modules or any(m == "protnote_tpu" or m.startswith("protnote_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port's serving, inference CLIs, evaluation, training or "
                             "tower path imported jax or the JAX package")
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
    } for k in ("update", "flush", "finalize")] + [{
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
        ("masked_mean_pool", "masked_pool", "protnote_tpu/models/proteinfer.py:147", k7_fwd,
         launches),
        ("masked_mean_pool_bwd", "masked_pool", "protnote_tpu/models/proteinfer.py:212", k7_bwd,
         encoder_launches),
        ("masked_conv_dx", "masked_conv_bwd", "protnote_tpu/models/proteinfer.py:127", k7_bwd,
         encoder_launches),
        ("masked_conv_dw", "masked_conv_bwd", "protnote_tpu/models/proteinfer.py:127", k7_bwd,
         encoder_launches),
        ("masked_bn_relu_fwd", "masked_bn", "protnote_tpu/models/layers.py:102", k7_bwd,
         encoder_launches),
        ("masked_bn_relu_bwd", "masked_bn", "protnote_tpu/models/layers.py:102", k7_bwd,
         encoder_launches),
        ("masked_conv_fwd_f32", "masked_conv_f32", "protnote_tpu/models/proteinfer.py:127",
         k7_f32, f32_launches),
        ("masked_mean_pool_f32", "masked_pool", "protnote_tpu/models/proteinfer.py:208", k7_f32,
         f32_launches))] + [{
        "name": k, "route": "cuda", "source": "protnote_tpu_torch/csrc/streamed_bn.cu",
        "replaces": "protnote_tpu/ops/streaming_train.py:270", "launches": stream_launches[k],
        **{f: k6_times[k][f] for f in KERNEL_FIELDS},
    } for k in K6_KERNELS] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": dense_launches.get(k, 0),
        **{f: dense_times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep in (
        ("pair_first_add", "pair_dense", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_train_prod", "pair_train", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_side_sums", "pair_dense", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_train_dw_prod", "pair_train_bwd", "protnote_tpu/ops/pair_scorer.py:108"),
        ("bn_relu_dropout_forward", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bn_relu_dropout_backward", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bias_relu_dropout_forward", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bias_relu_dropout_backward", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("pair_mlp_head", "pair_scorer", "protnote_tpu/ops/pair_scorer.py:197"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": f32_paths[k], **{f: f32_times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep in (
        ("pair_mlp_layer_f32", "pair_scorer_f32", "protnote_tpu/ops/pair_scorer.py:197"),
        ("pair_mlp_layer_f32_prod", "pair_scorer_f32", "protnote_tpu/ops/pair_scorer.py:226"),
        ("pair_mlp_head_f32", "pair_scorer", "protnote_tpu/ops/pair_scorer.py:233"),
        ("pair_int8_layer_f32", "pair_scorer_int8", "protnote_tpu/ops/pair_scorer.py:375"),
        ("pair_int8_layer_f32_dynamic", "pair_scorer_int8",
         "protnote_tpu/ops/pair_scorer.py:375"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": f32_train_launches[k],
        **{f: f32_train_times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep in (
        ("pair_train_hidden_f32", "pair_scorer_f32", "protnote_tpu/ops/streaming_train.py:238"),
        ("pair_train_dx_f32", "pair_train_bwd_f32", "protnote_tpu/ops/streaming_train.py:238"),
        ("pair_train_dw_f32", "pair_train_bwd_f32", "protnote_tpu/ops/streaming_train.py:238"),
        ("bn_relu_forward_f32", "bn_relu", "protnote_tpu/ops/streaming_train.py:98"),
        ("bn_relu_backward_f32", "bn_relu", "protnote_tpu/ops/streaming_train.py:115"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": f32_sd_launches.get(k, 0),
        **{f: f32_sd_times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep in [
        (k, "streamed_bn", "protnote_tpu/ops/streaming_train.py:270") for k in STREAM_F32_KERNELS
    ] + [
        ("pair_first_add_f32", "pair_dense", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_train_prod_f32", "pair_scorer_f32", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_side_sums_f32", "pair_dense", "protnote_tpu/ops/pair_scorer.py:108"),
        ("pair_train_dw_prod_f32", "pair_train_bwd_f32", "protnote_tpu/ops/pair_scorer.py:108"),
        ("bn_relu_dropout_forward_f32", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bn_relu_dropout_backward_f32", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bias_relu_dropout_forward_f32", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56"),
        ("bias_relu_dropout_backward_f32", "bn_relu", "protnote_tpu/ops/pair_scorer.py:56")]] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": f32_enc_launches[k],
        **{f: k7_f32_train_times[k][f] for f in KERNEL_FIELDS},
    } for k, src, rep in (
        ("masked_conv_dx_f32", "masked_conv_f32", "protnote_tpu/models/proteinfer.py:127"),
        ("masked_conv_dw_f32", "masked_conv_f32", "protnote_tpu/models/proteinfer.py:127"),
        ("masked_bn_relu_fwd_f32", "masked_bn", "protnote_tpu/models/layers.py:102"),
        ("masked_bn_relu_bwd_f32", "masked_bn", "protnote_tpu/models/layers.py:102"),
        ("masked_mean_pool_bwd_f32", "masked_pool", "protnote_tpu/models/proteinfer.py:208"))] + [{
        "name": k, "route": "cuda", "source": f"protnote_tpu_torch/csrc/{src}.cu",
        "replaces": rep, "launches": runs[k], **{f: k8_f32_times["a"][k][f] for f in KERNEL_FIELDS},
    } for k, src, rep, runs in (
        ("text_attention_f32", "text_attention_f32", "protnote_tpu/models/text_transformer.py:167",
         tower_f32_launches),
        ("text_attention_bwd_f32", "text_attention_f32",
         "protnote_tpu/models/text_transformer.py:182", tower_f32_bwd),
        ("add_layer_norm_f32", "layer_norm", "protnote_tpu/models/text_transformer.py:159",
         tower_f32_launches),
        ("add_layer_norm_bwd_f32", "layer_norm", "protnote_tpu/models/text_transformer.py:159",
         tower_f32_bwd))]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
