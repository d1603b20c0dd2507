#!/usr/bin/env python3
"""Kernel variants the port does not use, measured on one CUDA card (H100)
against the kept kernels, to find what bounds them.

    python3 chip_variants.py

1. K8a (``csrc/text_attention.cu``) at ``chip_smoke.py``'s three K8 shapes:
   the kept source with parts of its work taken out, each a copy with text
   replaced and built with the port's nvcc flags (timing only: their
   results are wrong; each one's error against the plain version is
   printed), and its two-pass form on mma.sync as before wgmma; SDPA with
   the same additive mask as the yardstick.  Each entry is timed twice, the
   list run forward and then backward.
2. K2's layer 1 with its A operand formed in registers
   (``csrc/variants/k2_register_a.cu``) against the kept code pass
   (``pair_int8_codes``) and smem-A GEMM (``pair_int8_layer``) on the first
   full chunk of the launch plan at full serving width, in turns; its codes
   are compared with the kept kernel's on the first and the last chunk.

Prints one JSON line a measurement (the builds' ptxas lines first), then
the card's name and power limit.  Times are CUDA events
(``chip_smoke.cuda_time_ms``).  Without a CUDA device it exits non-zero.

    python3 chip_variants.py --header-against DIR

instead times the kernels that include ``csrc/hopper.cuh`` and are not
otherwise changed by an edit of it (K1's whole call and K2's static call
at full serving width, K8a at the three K8 shapes) in the checkout at DIR
(another commit, unpacked with ``git archive``) and in this one, in turns
(DIR, this, this, DIR), one process a turn, and prints each turn, the
change's mean over DIR's, per kernel, and whether each library's
instructions (``cuobjdump -sass``) are the same in both.

    python3 chip_variants.py --k2-codes

times K2's code passes (``csrc/pair_scorer_int8.cu``: layer 1's static
codes, the dynamic form from a and c, the later form from the bf16 carry)
against their first design (``csrc/variants/k2_codes_v1.cu``: one warp a
pair row, through its own entry points and its wrapper's per-launch work)
in turns (kept, first, first, kept) on a batch's chunks at the full serving
width (32 x 64,204 rows, H 3072), by CUDA events and as device time beside
each pass's bytes bound, after checking that both give the same bits on the
first and the last chunk; the host's time a launch of each wrapper; the
kept source with parts taken out or one choice changed (timing only where
the results are wrong; ``K2CODES_SUBS``): without the loads, the stores or
the division, with div_rn's two corrections, without the scale kernel,
the scale kernel alone (whole, without its sums, empty), two sequences an
iteration, 40 registers, streaming stores; other
tilings of layer 1's codes kernel (``K2CODES_PLANS``); and K2's whole call,
static and dynamic, with the kept passes and with the first design's, in
turns, with the GEMM's (``pair_int8_layer``) device time beside.

    python3 chip_variants.py --k3

builds K3 (``csrc/eval_accumulator.cu``) with parts of its work taken out
(timing only): the update without its histogram adds, the finalize without
its micro-AP bin sums (their shared-memory turns and atomic flush); times
each beside the kept kernels at full width (32 rows x 32,102 labels x 512
bins, ~1% positives; the finalize on histograms with 0.5% positive counts),
the list run forward and then backward, calling the C entry points alone.

    python3 chip_variants.py --k4-bwd

times K4-bwd (``csrc/pair_train_bwd.cu``) against its first design
(``csrc/variants/pair_train_bwd_v1.cu``: 128 x 128 dX units with f32
atomics, a c2 box every dW step, whole dW tiles in 2.18 waves) in turns
(kept, first, first, kept) at B x L = 32 x 32,102 (the default step), 32 x
8,192 (label subsets), 32 x 2,048 and 128 x 2,048 (the streamed tile), 32 x
300 (in-batch labels),
width 3072; then builds the kept source with parts of its work taken out
or one design choice changed (timing only: the results are wrong): dX
with nothing after its gate (no dc2 or da2 sums), without dc2's
shared-memory sum, without da2's column sums, without the W box's loads,
with two stages; dW without forming its A fragments (the c2 fragments fed
as they are), without the dz boxes' loads, and with every tile whole (no
pieces); each timed
twice at 32 x 32,102 beside the kept kernels (the list run forward and
then backward), calling the C entry points alone.

    python3 chip_variants.py --k7

times each of K7's conv shapes alone at the training and serving path's
width (32 sequences at bucket 512, ``chip_smoke.k7_lengths``): the first
conv (one-hot 20 -> 1,100 channels), a block's dilated conv (1,100 -> 550,
9 taps) at dilations 1, 9 and 81, and its 1 x 1 conv (550 -> 1,100), each
as ``masked_conv_forward`` without and with the eval BN prologue and with
the residual, ``masked_conv_dx`` and ``masked_conv_dw``, beside cuDNN's
conv1d, its backward data and its backward filter on the same shape;
inputs at the chain's padded pitch and the weights re-laid once (the
kernels alone); with the TFLOP/s of the forward (with and without the
prologue), of dX and of dW on the products these lengths need, dW's
splits and the bytes of its float32 partials; and each wrapper's host
time a call.  Then dW (``csrc/masked_conv_bwd.cu``) built with parts of its
work taken out (timing only: the results are wrong): without the x boxes'
loads, without the dy boxes' loads, without forming A (constant fragments
instead of ``ldmatrix.trans``), without the position mask, and with every
step's count read as 64; each timed beside the kept kernel on the dilated
shapes, in turns, through the C entry point.

    python3 chip_variants.py --k7-bn

times K7-BN (``csrc/masked_bn.cu``: two launches a direction) against its
cooperative design (``csrc/variants/masked_bn_cooperative.cu``: one
cooperative launch a direction, the rows read for the sums kept in shared
memory across a grid barrier) and its first design
(``csrc/variants/masked_bn_v1.cu``: six launches a forward, three a
backward, contiguous rows) in turns on the 10 BatchNorms of an encoder
training step (1,100 and 550 channels, 32 sequences at bucket 512,
``chip_smoke.k7_lengths``, one row dropped by the example mask): the first
design on contiguous inputs, the others at the convs' padded pitch, each
with its scratch made once and called through its C entry points, by CUDA
events and as device time (the busy time of a ``torch.profiler`` pass, and
each kernel's); then the kept source with parts of its work taken out or
one choice changed (timing only where the results are wrong;
``K7BN_SUBS``: without the loads, the second kernel, dx's order, or on
128-channel slices), on 1 and 3 blocks an SM and on the
1,100- and 550-channel BatchNorms alone, each timed twice (the list
forward, then backward).  Where the host enqueues slower than the card
runs, the event times are the host's: read the device times.

    python3 chip_variants.py --k7-pool

times K7's masked mean pool (``csrc/masked_pool.cu``: one launch, a block
a sequence's valid rows over 128 channels, 64 rows at once with 4 loads in
flight a thread) against its first design
(``csrc/variants/masked_pool_v1.cu``: a block a 64-column group of one
sequence, 8 warps of 4-byte pairs) and its runs form
(``csrc/variants/masked_pool_runs.cu``: a block a run of 32 valid rows over
every channel, then a launch adding each sequence's runs) in turns at 32
sequences x 1,100 channels, buckets 512 and 1,024
(``chip_smoke.k7_lengths``), on the padded pitch and on a contiguous input,
by CUDA events and device time; then the kept source with parts taken out
or one choice changed (``K7POOL_SUBS``: without the loads, 2 or 8 loads in
flight, 256 or 512 threads, 256-channel groups, evict-first loads); the
pool's backward kernel against the plain
transpose (alone, and with the copy to the padded pitch the last conv's
backward used to make), with 64 rows a block and streaming stores; each
wrapper's host time a call.

    python3 chip_variants.py --k9-update

measures what bounds K9's update: the kept update (a batch's uint16 slot
codes into a ring; a flush of 8 batches' codes, a block's 128 columns
counted in shared-memory bytes over every row, then one add a distinct
(slot, column)) and its first design (``csrc/variants/threshold_sweep_v1.cu``:
one L2 atomic an element) in turns on phase 7a's spread batch and on a
batch whose logits lie below the least threshold, at 99 and 1,024
thresholds, after checking that both give the same histogram; the time a
batch (the codes and an eighth of the flush) and the aggregation alone (a
flush every batch); the first design without its adds and with each add
sent to its own address (coalesced, and scattered over the slots:
``K9V1_SUBS``); the kept kernels with parts taken out (``K9_SUBS``: the
flush without its L2 adds or its shared counts, the codes by a binary
search over all thresholds or with their loads and stores alone); each
batch's share of repeated (slot, column) keys; the host time a call.

    python3 chip_variants.py --encoder-train-against DIR

runs ``chip_smoke.py``'s encoder-training phase alone (TRAIN_SEQUENCE_ENCODER
at buckets 512 and 1,024, then ENCODER_BN_TRAIN_MODE) on DIR's package and
on this one, in the same turns, and prints each turn's median step,
seqs/s, peak memory at both buckets, idle share, ``aten::copy_`` calls a
step (all, and of (B, T, C) activations), the gradient check's worst leaf
and the ENCODER_BN_TRAIN_MODE step, and the change's mean over DIR's.

    python3 chip_variants.py --k8a-bwd

times K8a-bwd at ``chip_smoke.py``'s shapes (a) 128 x 128 and (c) causal
128 x 128: the one-pass kernel (the port's at T <= 128), the two-kernel
form on the same tensors (``two_kernel_backward_cuda``), SDPA's backward
with the same additive mask, and the one-pass kernel built with parts of
its work taken out (timing only: without its four TMA loads, without its
three TMA output stores, without expf and the divisions), in turns over 7
rounds (medians; SDPA's time is noisy from run to run), each against the
plain backward, with ptxas's registers and spills.

    python3 chip_variants.py --k8a-f32

times K8a f32 and K8a-bwd f32 (``csrc/text_attention_f32.cu``: 3xTF32 on
mma.sync, scores in registers at T <= 128, cp.async tiles) against their
first design (``csrc/variants/text_attention_f32_v1.cu``: the FMA pipe, the
score rows in shared memory, two backward kernels) in turns (kept, first,
first, kept; 5 rounds, medians) at ``chip_smoke.py``'s shapes (a) 128 x
128, (b) 32 x 512 and (c) causal 128 x 128, through their C entry points,
after holding both to the plain float32 version; then the kept source with
parts taken out (timing only: the results are wrong; ``K8AF32_SUBS``):
without the split's cross products (1xTF32), every product kept but the
split's instructions gone, the pieces rounded by ``cvt.rna.tf32`` instead
of integer operations, without the tile loads, without expf and the
divisions; each timed twice (the list forward, then
backward); float32 SDPA with a boolean mask and its backward, and the plain
versions, beside; the bytes bound and the operations' bound at the split's
165 TFLOP/s and at the FMA pipe's 67.

    python3 chip_variants.py --k7-f32

times K7's float32 convs (``csrc/masked_conv_f32.cu``: the bf16x3 split
on wgmma, the forward and dX at 128 x 112, dW at 128 x 128 over dy's
pieces) against their first design (``csrc/variants/masked_conv_f32_v1.cu``:
the FMA pipe, 128 x 128 tiles, its own float32 layouts and plans) and
cuDNN float32 (TF32 off: ``conv1d``, ``conv1d_input``, ``conv1d_weight``)
in turns (kept, first, cuDNN, cuDNN, first, kept; 6 rounds, medians; dW
also against ``csrc/variants/masked_conv_f32_dw_smem.cu``, dy's pieces made
in shared memory by the consumers in place of a split pass a call) at
the chain's shapes, 32 sequences at bucket 512 (``chip_smoke.k7_lengths``):
the stem (9 x 20 -> 1,100), the dilated convs (9 x 1,100 -> 550 with the
BN prologue) at dilations 1-81 and the 1 x 1 (550 -> 1,100 with the
prologue and the residual), the forward, dX (not the stem's) and dW with
dbias, through the C entry points, after holding both designs to the plain
float32 version (dW to float64); a step's sums (the forward's and dW's 11
calls, dX's 10); then at the stem, dilation 9 and the 1 x 1 the kept
source with parts taken out (timing only: the results are wrong;
``K7F32_SUBS``): without the split's cross products, without the stage
adds, every product kept but the split gone, the loads alone, without
the prologue, without dW's pass splitting dy; each timed twice (the list
forward, then backward); the operations' bound at the split's 165 TFLOP/s
and at the FMA pipe's 67.

    python3 chip_variants.py --qk-noise

finds where the bf16 noise of the tower's q and k gradients enters:
E5-large (24 layers, random weights) with LoRA (rank 4, alpha 8) on its
last 2 layers, 128 descriptions of 16-128 tokens padded to 128, one fixed
cotangent on the pooled embeddings, as ``chip_smoke.py``'s tower-gradient
check; the chain rebuilt in float32 arithmetic with a bf16 rounding (of
the value, and of its gradient on the way back) at each rounding point of
the bf16 chain (the embeddings stay float32), and each point raised to
float32 alone: the frozen weights, the q/k/v projections, the LoRA deltas,
P, dP, the attention output, the output projection, the residual adds, the
LayerNorm outputs and the FFN, then all of them, and all but one (that
point the only one rounded).  Prints
the q and k leaves' and the other leaves' L2 distance to the float32 chain
for each, beside the plain bf16 chain and the kernels' chain (with the
one-pass K8a-bwd and with the two-kernel form).

    python3 chip_variants.py --eval-against DIR

runs ``Trainer.evaluate`` on ``chip_smoke.py``'s 256-sequence FASTA (bf16,
K1 and K3 on the card; once to warm up, then timed) on DIR's package and on
this one, in the same turns, and prints seqs/s of each and the change's
mean over DIR's.

    python3 chip_variants.py --train-against DIR

runs ``chip_smoke.py``'s training phase alone (one epoch at full width,
32 sequences a step) on DIR's package and on this one, in the same turns,
and prints the median step, seqs/s, peak memory and idle share of each
and the change's mean over DIR's.

    python3 chip_variants.py --k5-dense

times K5's dense BatchNorm forms (``csrc/bn_relu.cu``: the forward's
moments in one read of z; the backward's sums pass at two blocks an SM)
against their first design (``csrc/variants/bn_relu_dense_v1.cu``: two
centred moment passes; the same backward arithmetic with no bound on the
sums blocks) in turns (3 rounds of the list forward and then backward,
medians) at phase 24's shape (bf16, 32 x 32,102 pair rows, H
3072) and phase 32's (float32, 16 x 32,102), dropout 0.1, through the C
entry points with their scratch made once, after checking that the two
backwards give the same bits (on the first design's statistics) and the
two forwards agree; by CUDA events and device time, with each kernel's
device time (the passes apart) beside the bytes bound and the standalone
floor.  Then each source with parts taken out or one choice changed
(timing only where the results are wrong; ``K5DENSE_SUBS``): the first
design without the hash (a kept bit from one xor) and with its backward's
loads alone (no gate, hash or arithmetic); the kept source without the
hash, with 4- and 16-row moment tiles, with the apply pass held at 8 blocks an SM, and its backward with 4 rows
in flight in the sums pass (not 2), 3 or 4 sums blocks an SM (not 2), 4
rows unrolled in the dz pass (not 2) and the dz pass at 8 blocks an SM.

    python3 chip_variants.py --dense-train-against DIR [SETTING]

runs ``chip_smoke.py``'s dense training phase alone for one setting of its
``DENSE_SETTINGS`` (``dense_dropout`` unless named, or ``prod``, ``no_bn``,
``remat``; ``PAIR_BACKEND dense``, ``OUTPUT_MLP_DROPOUT`` 0.1, 32 sequences
a step, 8 steps) on DIR's package and on this one, in the same turns, and
prints the median warm step, seqs/s, peak memory and idle share of each and
the change's mean over DIR's.  ``--dense-serve-against DIR`` does the same
for the dense serving phase's ``prod`` form (K1 with
``concatenation_prod``: a ``pair_train_prod`` launch a label chunk): its
batch ms and seqs/s.

    python3 chip_variants.py --dense-first

times the dense first layer's kernels against their first designs in turns
(``dense_first_variants``): ``pair_side_sums`` and ``pair_train_prod``, each
checked first (the same bits where the design keeps the order of work),
with parts taken out (``DENSE_FIRST_SUBS``), K4 and cuBLAS beside, and the
L2's read rate.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANT_DIR = os.path.join(ROOT, "protnote_tpu_torch", "csrc", "variants")

# text replaced in text_attention.cu: (old, new), each old found exactly once
SUBS = {
    # P.V's products: the probabilities summed into the output instead
    "pv_one_pass": ("        pv(kt, s[kt]);\n",
                    "        for (int j = 0; j < 8; ++j)\n"
                    "          for (int e = 0; e < 4; ++e) o[j][e] += s[kt][j][e];\n"),
    "pv_two_pass": ("          pv_wg(slot, s);\n",
                    "          for (int j = 0; j < 8; ++j)\n"
                    "            for (int e = 0; e < 4; ++e) o[j][e] += s[j][e];\n"),
    # the score products: a value made from Q in their place
    "score_one_pass": ("        ldsm_x4(bf, kbase + (key * LD + col) * 2);\n"
                       "        mma_bf16(s[2 * jp], qa[kk], bf[0], bf[1]);\n"
                       "        mma_bf16(s[2 * jp + 1], qa[kk], bf[2], bf[3]);\n",
                       "        (void)bf; (void)key; (void)col; (void)kbase;\n"
                       "        s[2 * jp][kk] += __uint_as_float(qa[kk][jp] & 0x3c7f0000u);\n"),
    "score_two_pass": ("      for (int kk = 0; kk < HD / 16; ++kk) wgmma_n64<0>(s, qa[kk], dk + 2 * kk, 1);\n",
                       "      (void)dk;\n"
                       "      for (int kk = 0; kk < HD / 16; ++kk)\n"
                       "        s[kk][kk] += __uint_as_float(qa[kk][kk] & 0x3c7f0000u);\n"),
    # expf and the division
    "exp_one_pass": ("            s[kt][j][e] = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));\n",
                     "            s[kt][j][e] = __fsub_rn(s[kt][j][e], m[e >> 1]);\n"),
    "div_one_pass": ("            s[kt][j][e] = div_rn(s[kt][j][e], l[e >> 1], r[e >> 1]);\n",
                     "            s[kt][j][e] = __fmul_rn(s[kt][j][e], r[e >> 1]);\n"),
    "exp_rescale": ("            l[rr] = __fmul_rn(l[rr], expf(__fsub_rn(m[rr], mn)));\n",
                    "            l[rr] = __fmul_rn(l[rr], __fsub_rn(m[rr], mn));\n"),
    "exp_sum": ("              lt[e >> 1] = __fadd_rn(lt[e >> 1], expf(__fsub_rn(s[j][e], m[e >> 1])));\n",
                "              lt[e >> 1] = __fadd_rn(lt[e >> 1], __fsub_rn(s[j][e], m[e >> 1]));\n"),
    "div_two_pass": ("              s[j][e] = div_rn(expf(__fsub_rn(s[j][e], m[e >> 1])), l[e >> 1], r[e >> 1]);\n",
                     "              s[j][e] = __fmul_rn(__fsub_rn(s[j][e], m[e >> 1]), r[e >> 1]);\n"),
    # the K and V copies
    "kv_one_pass": ("      cp_async16(dst + (row * LD + col) * 2, src + base + (size_t)(ok ? key : 0) * HD + col, ok);\n",
                    "      (void)dst; (void)src; (void)ok; (void)row; (void)col; (void)key;\n"),
    "kv_two_pass": ("        cp_async16(dst + row * 128 + ((ck ^ (row & 7)) << 4),\n"
                    "                   src + base + (size_t)(ok ? key : 0) * HD + ck * 8, ok);\n",
                    "        (void)dst; (void)src; (void)ok; (void)row; (void)ck; (void)key;\n"),
    # the key mask's read (every key kept: no tile is skipped)
    "mask": ("    const bool kept = j < T && __ldg(mask_row + j) > 0;\n",
             "    const bool kept = j < T;\n"),
    # Q's read
    "q": ("      qa[kk][e] = r < T ? __ldg(reinterpret_cast<const uint32_t*>(q + base + (size_t)r * HD + col))\n"
          "                        : 0u;\n",
          "      qa[kk][e] = (uint32_t)(r * 131 + col * 7 + kk) & 0x3c3f3c3fu;\n"),
    # 64-query blocks
    "warps4": ("constexpr int WARPS = 8;", "constexpr int WARPS = 4;"),
    # the two-pass form on mma.sync: padded K/V tiles, per-warp tile ranges
    "mma_sync_loads": ("      load_sw(slot, 0, kt);\n      if (second) load_sw(slot, 1, kt);\n",
                       "      load_tile(slot, 0, kt);\n      if (second) load_tile(slot, 1, kt);\n"),
    "mma_sync_range": ("      if (kt >= glo && kt < ghi) {\n", "      if (kt >= lo && kt < hi) {\n"),
    "mma_sync_scores": ("        scores_wg(slot, kt, s);\n", "        scores(slot, kt, s);\n"),
    "mma_sync_pv": ("          pv_wg(slot, s);\n", "          pv(slot, s);\n"),
}
PV = ["pv_one_pass", "pv_two_pass"]
SCORE = ["score_one_pass", "score_two_pass"]
EXP_DIV = ["exp_one_pass", "div_one_pass", "exp_rescale", "exp_sum", "div_two_pass"]
KV = ["kv_one_pass", "kv_two_pass"]
K8A_VARIANTS = {
    "kept": [],
    "two_pass_mma_sync": ["mma_sync_loads", "mma_sync_range", "mma_sync_scores", "mma_sync_pv"],
    "no_pv_products": PV,
    "no_score_products": SCORE,
    "no_exp_div": EXP_DIV,
    "no_kv_loads": KV,
    "no_mask_read": ["mask"],
    "loads_and_stores_only": PV + SCORE + EXP_DIV,
    "compute_only": KV + ["mask", "q"],
    "64_query_blocks": ["warps4"],
}


# text replaced in eval_accumulator.cu: (old, new), each old found exactly once
K3_SUBS = {
    "update_no_hist_adds": [(
        "      atomicAdd(hist + ((size_t)(t ? row : L + row) * nb + bin), 1);\n",
        "      if (bin < 0) atomicAdd(hist, 1);\n")],
    "finalize_no_bin_sums": [(
        "        s_micro[k * 32 + lane] += acc_pos[k];\n"
        "        s_micro[HALF + k * 32 + lane] += acc_neg[k];\n",
        "        (void)acc_pos[k]; (void)acc_neg[k];\n"), (
        "    if (bin >= 0 && s_micro[i]) atomicAdd(&micro[(i / HALF) * nb + bin], s_micro[i]);\n",
        "    (void)bin;\n")],
}


# text replaced in masked_conv_bwd.cu (dW): (old, new), each old found exactly once
K7_DW_SUBS = {
    "no_x_load": [(
        "          mbar_expect_tx(full_bar(s), DW_STAGE);\n"
        "          tma_load_3d(st, &tm_x, w.m0, t0 + w.s, b, full_bar(s));\n"
        "          tma_load_3d(st + DW_BOX, &tm_x, w.m0 + 64, t0 + w.s, b, full_bar(s));\n",
        "          mbar_expect_tx(full_bar(s), DW_STAGE - DW_X_BYTES);\n")],
    "no_dy_load": [(
        "          mbar_expect_tx(full_bar(s), DW_STAGE);\n",
        "          mbar_expect_tx(full_bar(s), DW_X_BYTES);\n"), (
        "            tma_load_3d(st + DW_X_BYTES + i * DW_BOX, &tm_dy, w.n0 + 64 * i, t0, b, full_bar(s));\n",
        "            (void)i;\n")],
    "no_a_formation": [(
        "        ldsm_x4_trans(c, box + kk * 16 * 128 + ld_off);\n",
        "        c[0] = c[1] = c[2] = c[3] = 0x3f803f80u + kk;\n")],
    "no_mask": [("          fa[P][kk][i] = c[i] & keep;\n",
                 "          fa[P][kk][i] = c[i];\n          (void)keep;\n")],
    "no_step_read": [("      const int rows = a.steps[2 * k + 1] >> 16;\n",
                      "      const int rows = 64;\n")],
}


def k7_dw_variants(build_dir: str, card: str) -> None:
    """dW kept and with parts taken out, on the dilated shapes at 32 x 512,
    in turns, through each library's C entry point."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import masked_conv as k7

    base = (kernels.CSRC_DIR / "masked_conv_bwd.cu").read_text()
    jobs = {}
    for name, subs in [("kept", [])] + list(K7_DW_SUBS.items()):
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K7 dW variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"masked_conv_bwd_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libmasked_conv_bwd_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    fns = {}
    for name, (_, out) in jobs.items():
        cs.log("k7_dw_variant_ptxas", variant=name, ptxas=logs[name])
        fn = ctypes.CDLL(out).masked_conv_dw
        fn.argtypes = k7._ARGS[("masked_conv_bwd", "masked_conv_dw")]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev, bf16, B, T = torch.device("cuda"), torch.bfloat16, cs.B, 512
    lengths = torch.from_numpy(cs.k7_lengths(np.random.default_rng(3), T)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    for d in (1, 9, 81):
        taps, cin, cout = 9, 1100, 550
        x = k7.pad_pitch(torch.randn(B, T, cin, generator=gen, device=dev).to(bf16))
        dy = k7.pad_pitch(torch.randn(B, T, cout, generator=gen, device=dev).to(bf16))
        plan = k7._dw_plan_on(lengths, T, taps, d, cin, cout, dev)
        bias_part = torch.empty(B, cout, device=dev)
        dw = torch.empty(taps, cin, cout, device=dev, dtype=bf16)
        db = torch.empty(cout, device=dev, dtype=bf16)

        def call(fn):
            def run():
                err = fn(x.data_ptr(), dy.data_ptr(), lengths.data_ptr(), plan.data_ptr(), None,
                         bias_part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T, cin, cout,
                         x.stride(1), dy.stride(1), taps, d, plan.splits, plan.items,
                         k7._num_sms(dev), stream)
                if err != 0:
                    raise RuntimeError(f"masked_conv_dw variant: CUDA error {err}")
            return run

        runs = {name: call(fn) for name, fn in fns.items()}
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                times[name].append(cs.cuda_time_ms(runs[name], 20))
        flop = 2.0 * cin * cout * cs.conv_rows(lengths.cpu().numpy(), T, taps, d)
        cs.log("k7_dw_variants", dilation=d, ms=times,
               tflops={n: flop / (sum(t) / len(t)) / 1e9 for n, t in times.items()}, card=card)
        del x, dy, dw
        torch.cuda.empty_cache()


# the sums kernel's pipelined loop, and the same loop without the next
# rows' loads in flight
OLD_SUMS_LOOP = """    constexpr int U = 4;
    uint4 vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_rows(x, x_pitch, dy, dy_pitch, c0, r0 + rl + u * ROW_LANES, r1, vx[u], vg[u]);
    for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
      uint4 nx[U], ng[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_rows(x, x_pitch, dy, dy_pitch, c0, r + (U + u) * ROW_LANES, r1, nx[u], ng[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {"""
PLAIN_SUMS_LOOP = """    constexpr int U = {U};
    for (int r = r0 + rl; r < r1; r += U * ROW_LANES) {
      uint4 vx[U], vg[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load_rows(x, x_pitch, dy, dy_pitch, c0, r + u * ROW_LANES, r1, vx[u], vg[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {"""
OLD_SUMS_TAIL = """#pragma unroll
      for (int u = 0; u < U; ++u) {
        vx[u] = nx[u];
        vg[u] = ng[u];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    G[i] = rows_of_warp(G[i]);"""
NEW_SUMS_TAIL = """    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    G[i] = rows_of_warp(G[i]);"""
# text replaced in masked_bn.cu: (old, new), each old found exactly once
K7BN_SUBS = {
    "fwd_no_stats_loads": [(
        "        vn[u] = pn[u] != nullptr ? load8(pn[u]) : make_uint4(0, 0, 0, 0);\n",
        "        vn[u] = make_uint4(j, c0, 0, 0);\n")],
    "fwd_no_apply_loads": [(
        "    if (active && row < r1) v[u] = load8(x + static_cast<size_t>(row) * x_pitch + c0);\n",
        "    if (active && row < r1) v[u] = make_uint4(row, c0, 0, 0);\n"), (
        "        v[u] = load8(x + static_cast<size_t>(r + u * ROW_LANES) * x_pitch + c0);\n",
        "        v[u] = make_uint4(r + u, c0, 0, 0);\n")],
    "fwd_no_apply": [("  bn_apply_kernel<<<", "  if (apply_rows < 0) bn_apply_kernel<<<")],
    "bwd_no_loads": [(
        "    vx = load8(x + static_cast<size_t>(row) * x_pitch + c0);\n"
        "    vg = load8(dy + static_cast<size_t>(row) * dy_pitch + c0);\n",
        "    vx = make_uint4(row, c0, 0, 0);\n"
        "    vg = make_uint4(c0, row, 0, 0);\n")],
    "bwd_no_dx": [("  bn_dx_kernel<<<", "  if (apply_rows < 0) bn_dx_kernel<<<")],
    "bwd_dx_rows_in_order": [(
        "  const int k = blockIdx.y % sum_chunks, run = blockIdx.y / sum_chunks;\n",
        "  const int runs_ = (sum_rows + rows_per_block - 1) / rows_per_block;\n"
        "  const int k = blockIdx.y / runs_, run = runs_ - 1 - blockIdx.y % runs_;\n")],
    # 128-channel slices: a row's 256 bytes a half-warp
    "slices_128": [("constexpr int LANES = 8; ", "constexpr int LANES = 16; "),
                   ("constexpr int TAIL = 8; ", "constexpr int TAIL = 16; ")],
    # 2 rows in flight a thread and 3 blocks an SM (72 registers)
    "fwd_stats_2_rows": [("    constexpr int U = 4;\n    const __nv_bfloat16* p[U];\n",
                          "    constexpr int U = 2;\n    const __nv_bfloat16* p[U];\n")],
    "fwd_apply_4_rows": [("  constexpr int U = 8;\n  uint4 v[U];\n",
                          "  constexpr int U = 4;\n  uint4 v[U];\n")],
    # loads that evict first; stores that do
    "ldcs": [("  return __ldg(reinterpret_cast<const uint4*>(p));",
              "  return __ldcs(reinterpret_cast<const uint4*>(p));")],
    "stcs": [("      *reinterpret_cast<uint4*>(y + static_cast<size_t>(r + u * ROW_LANES) * y_pitch + c0) =\n"
              "          pack8(f);",
              "      __stcs(reinterpret_cast<uint4*>(y + static_cast<size_t>(r + u * ROW_LANES) * y_pitch"
              " + c0),\n          pack8(f));"),
             ("        *reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * dx_pitch + c0) = pack8(f);",
              "        __stcs(reinterpret_cast<uint4*>(dx + static_cast<size_t>(row) * dx_pitch + c0),"
              " pack8(f));")],
    # the sums without the next rows' loads in flight: 8 rows a thread at
    # once, or 4 at three blocks an SM
    "bwd_sums_8_rows_at_once": [(OLD_SUMS_LOOP, PLAIN_SUMS_LOOP.replace("{U}", "8")),
                                (OLD_SUMS_TAIL, NEW_SUMS_TAIL)],
    "bwd_sums_3_blocks": [(OLD_SUMS_LOOP, PLAIN_SUMS_LOOP.replace("{U}", "4")),
                          (OLD_SUMS_TAIL, NEW_SUMS_TAIL),
                          ("__launch_bounds__(THREADS)\nbn_grad_sums_kernel(",
                           "__launch_bounds__(THREADS, 3)\nbn_grad_sums_kernel(")],
}
# the grids of the variants that change them: a slice's channels, the
# statistics' and sums' blocks an SM
K7BN_SLICE_WIDTH = {"slices_128": 128}
K7BN_PER_SM = {"fwd_stats_2_rows": 3, "bwd_sums_3_blocks": 3}


def k7_bn_variants(build_dir: str, card: str) -> None:
    """K7-BN: the kept kernels (two launches a direction), the cooperative
    design and the first design in turns on a step's 10 BatchNorms, then
    the kept source with parts taken out or one choice changed and on other
    grids; all through the libraries' C entry points."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.models.layers import tree_to
    from protnote_tpu_torch.models.proteinfer import (BN_EPS, BN_MOMENTUM, ProteInferConfig,
                                                      init_proteinfer)
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import masked_conv as k7

    base = (kernels.CSRC_DIR / "masked_bn.cu").read_text()
    jobs = {"first_design": (os.path.join(VARIANT_DIR, "masked_bn_v1.cu"),
                             os.path.join(build_dir, "libmasked_bn_v1.so")),
            "cooperative": (os.path.join(VARIANT_DIR, "masked_bn_cooperative.cu"),
                            os.path.join(build_dir, "libmasked_bn_cooperative.so")),
            "tails": (os.path.join(VARIANT_DIR, "masked_bn_tails.cu"),
                      os.path.join(build_dir, "libmasked_bn_tails.so"))}
    for name, subs in [("kept", [])] + list(K7BN_SUBS.items()):
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K7-BN variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"masked_bn_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libmasked_bn_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    libs = {}
    for name, (_, out) in jobs.items():
        cs.log("k7_bn_variant_ptxas", variant=name, ptxas=logs[name])
        lib = ctypes.CDLL(out)
        if name == "first_design":
            lib.masked_bn_relu_forward.argtypes = [P] * 7 + [F] * 3 + [P] * 6 + [I] * 4 + [LL, P]
            lib.masked_bn_relu_backward.argtypes = [P] * 14 + [I] * 4 + [LL, P]
        elif name == "cooperative":
            lib.masked_bn_relu_forward.argtypes = [P, I] + [P] * 6 + [F] * 3 + [P] * 8 + [I] * 4 + [P]
            lib.masked_bn_relu_backward.argtypes = [P, I, P, I] + [P] * 10 + [I] * 4 + [P]
        elif name == "tails":
            lib.masked_bn_relu_forward.argtypes = [P, I] + [P] * 6 + [F] * 3 + [P] * 8 + [I] * 5 + [P]
            lib.masked_bn_relu_backward.argtypes = [P, I, P, I] + [P] * 11 + [I] * 5 + [P]
        else:
            lib.masked_bn_relu_forward.argtypes = k7._ARGS[("masked_bn", "masked_bn_relu_forward")]
            lib.masked_bn_relu_backward.argtypes = k7._ARGS[("masked_bn",
                                                             "masked_bn_relu_backward")]
        libs[name] = lib
    dev, bf16, f32, B, T = torch.device("cuda"), torch.bfloat16, torch.float32, cs.B, 512
    sms = k7._num_sms(dev)
    cfg = ProteInferConfig(compute_dtype=bf16)
    params, state = init_proteinfer(torch.Generator().manual_seed(0), cfg)
    params, state = tree_to(params, dev), tree_to(state, dev)
    lengths = torch.from_numpy(cs.k7_lengths(np.random.default_rng(17), T)).to(dev)
    em = torch.ones(B, device=dev)
    em[3] = 0.0
    gen = torch.Generator(device=dev).manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    # each library's done counters (the cooperative design's barrier counters)
    counters = {name: torch.zeros(128, dtype=torch.int32, device=dev) for name in libs}
    bns = []
    for bp, bs in zip(params["blocks"], state["blocks"]):
        for n in ("bn1", "bn2"):
            p, s_ = bp[n], bs[n]
            C = p["scale"].shape[0]
            x = (torch.randn(B, T, C, generator=gen, device=dev) + 0.3).to(bf16)
            g = torch.randn(B, T, C, generator=gen, device=dev).to(bf16)
            plan = k7.bn_plan(B * T, C, sms)
            v1_per = max(256, -(-B * T // 128))
            bns.append({
                "C": C, "p": p, "s": s_, "plan": plan,
                "xp": k7.pad_pitch(x), "gp": k7.pad_pitch(g), "xc": x, "gc": g,
                "yp": k7.padded_empty(B, T, C, bf16, dev), "yc": torch.empty_like(x),
                "dxp": k7.padded_empty(B, T, C, bf16, dev), "dxc": torch.empty_like(x),
                # stats, running statistics, counts, chunk_n and part (32
                # chunks at most; the backward's part and coef after them)
                "scratch": torch.empty(7 * C + 2 + 32 * (plan.slices + 2 * C) + 4 * C
                                       + 64 * C, dtype=f32, device=dev),
                "v1": (-(-B * T // v1_per), v1_per),
                # stats, running statistics, counts, part and part2 (128
                # chunks at most each), coef, dscale, dbias
                "v1_scratch": torch.empty(7 * C + 2 + 2 * 128 * C + 4 * C, dtype=f32,
                                          device=dev)})

    def chunks_of(name, plan, C, per_sm):
        width = K7BN_SLICE_WIDTH.get(name, k7.BN_SLICE)
        per_sm = per_sm or K7BN_PER_SM.get(name)
        if per_sm is None and width == k7.BN_SLICE:
            return plan.stat_chunks
        return max(1, min(k7.BN_MAX_CHUNKS, (per_sm or 2) * sms // -(-C // width)))

    def fwd(name, per_sm=None, only=None):
        lib = libs[name]

        def run():
            for b in bns:
                if only is not None and b["C"] != only:
                    continue
                C, p, s_, plan, sc = b["C"], b["p"], b["s"], b["plan"], b["scratch"]
                chunks = chunks_of(name, plan, C, per_sm)
                common = (p["scale"].data_ptr(), p["bias"].data_ptr(), s_["mean"].data_ptr(),
                          s_["var"].data_ptr(), BN_MOMENTUM, 1.0 - BN_MOMENTUM, BN_EPS)
                if name == "first_design":
                    v1_chunks, per = b["v1"]
                    v = b["v1_scratch"]
                    err = lib.masked_bn_relu_forward(
                        b["xc"].data_ptr(), lengths.data_ptr(), em.data_ptr(), *common,
                        v[7 * C + 2:].data_ptr(), v[7 * C:].data_ptr(), v.data_ptr(),
                        v[5 * C:].data_ptr(), v[6 * C:].data_ptr(), b["yc"].data_ptr(), B, T, C,
                        v1_chunks, per, stream)
                else:
                    pre = (b["xp"].data_ptr(), b["xp"].stride(1), lengths.data_ptr(),
                           em.data_ptr(), *common, sc[7 * C + 2 + chunks * plan.slices:].data_ptr(),
                           sc[7 * C + 2:].data_ptr(), sc[7 * C:].data_ptr(), sc.data_ptr(),
                           sc[5 * C:].data_ptr(), sc[6 * C:].data_ptr())
                    y_args = (b["yp"].data_ptr(), B, T, C, chunks)
                    if name == "cooperative":
                        err = lib.masked_bn_relu_forward(*pre, counters[name].data_ptr(), *y_args,
                                                         stream)
                    elif name == "tails":
                        err = lib.masked_bn_relu_forward(*pre, counters[name].data_ptr(), *y_args,
                                                         plan.apply_rows, stream)
                    else:
                        err = lib.masked_bn_relu_forward(*pre, *y_args, plan.apply_rows, stream)
                if err != 0:
                    raise RuntimeError(f"masked_bn_relu_forward {name}: CUDA error {err}")
        return run

    def bwd(name, per_sm=None, only=None):
        lib = libs[name]

        def run():
            for b in bns:
                if only is not None and b["C"] != only:
                    continue
                C, p, plan, sc = b["C"], b["p"], b["plan"], b["scratch"]
                rows = -(-B * T // chunks_of(name, plan, C, per_sm))
                out = sc[7 * C + 2 + 32 * (plan.slices + 2 * C):]  # dscale, dbias, coef, part
                if name == "first_design":
                    chunks, per = b["v1"]
                    v = b["v1_scratch"]
                    part, tail = v[7 * C + 2:], v[7 * C + 2 + 256 * C:]
                    err = lib.masked_bn_relu_backward(
                        b["xc"].data_ptr(), b["yc"].data_ptr(), b["gc"].data_ptr(),
                        lengths.data_ptr(), em.data_ptr(), p["scale"].data_ptr(), v.data_ptr(),
                        v[7 * C:].data_ptr(), part.data_ptr(), part[chunks * C:].data_ptr(),
                        tail.data_ptr(), tail[2 * C:].data_ptr(), tail[3 * C:].data_ptr(),
                        b["dxc"].data_ptr(), B, T, C, chunks, per, stream)
                elif name == "cooperative":
                    err = lib.masked_bn_relu_backward(
                        b["xp"].data_ptr(), b["xp"].stride(1), b["gp"].data_ptr(),
                        b["gp"].stride(1), lengths.data_ptr(), em.data_ptr(),
                        p["scale"].data_ptr(), sc.data_ptr(), sc[7 * C:].data_ptr(),
                        out[4 * C:].data_ptr(), out.data_ptr(), out[C:].data_ptr(),
                        counters[name][64:].data_ptr(), b["dxp"].data_ptr(), B, T, C, rows,
                        stream)
                elif name == "tails":
                    err = lib.masked_bn_relu_backward(
                        b["xp"].data_ptr(), b["xp"].stride(1), b["gp"].data_ptr(),
                        b["gp"].stride(1), lengths.data_ptr(), em.data_ptr(),
                        p["scale"].data_ptr(), sc.data_ptr(), sc[7 * C:].data_ptr(),
                        out[4 * C:].data_ptr(), out[2 * C:].data_ptr(), out.data_ptr(),
                        out[C:].data_ptr(), counters[name][64:].data_ptr(),
                        b["dxp"].data_ptr(), B, T, C, rows, plan.apply_rows, stream)
                else:
                    err = lib.masked_bn_relu_backward(
                        b["xp"].data_ptr(), b["xp"].stride(1), b["gp"].data_ptr(),
                        b["gp"].stride(1), lengths.data_ptr(), em.data_ptr(),
                        p["scale"].data_ptr(), sc.data_ptr(), sc[7 * C:].data_ptr(),
                        out[4 * C:].data_ptr(), out.data_ptr(), out[C:].data_ptr(),
                        b["dxp"].data_ptr(), B, T, C, rows, plan.apply_rows, stream)
                if err != 0:
                    raise RuntimeError(f"masked_bn_relu_backward {name}: CUDA error {err}")
        return run

    # the statistics each backward reads: the kept forward's (the first
    # design's from its own forward, in its scratch)
    fwd("kept")()
    fwd("first_design")()
    torch.cuda.synchronize()
    elems = sum(B * T * b["C"] for b in bns)
    bounds = {"fwd": cs.bound(nbytes=2.0 * 2 * elems)["bound_ms"],
              "bwd": cs.bound(nbytes=2.0 * 3 * elems)["bound_ms"]}

    def turns(calls, reps):
        """Each call's CUDA-event time and device time (the busy time of a
        ``torch.profiler`` pass, and each kernel's), the list forward and
        then backward."""
        times = {(k, v): {"ms": [], "device_ms": []} for k, v, _ in calls}
        for order in (calls, calls[::-1]):
            for kernel, variant, fn in order:
                t = times[(kernel, variant)]
                t["ms"].append(cs.cuda_time_ms(fn, reps))
                _, busy, top = cs.device_profile(fn, reps)
                t["device_ms"].append(None if busy is None else busy * 1e3 / reps)
                t["kernels_ms"] = [(re.sub(r"^.*::|\(.*$", "", name.replace("(anonymous namespace)::", "")), ms)
                                   for name, ms in top]
        return times

    designs = [(d, n) for d in ("fwd", "bwd")
               for n in ("kept", "tails", "cooperative", "first_design")]
    first = [(d, n, (fwd if d == "fwd" else bwd)(n)) for d, n in designs]
    for (kernel, variant), t in turns(first, 20).items():
        cs.log("k7_bn_turns", kernel=kernel, variant=variant, **t, bound_ms=bounds[kernel],
               device_share_of_bound=[bounds[kernel] / x for x in t["device_ms"] if x],
               calls=len(bns), card=card)
    for kernel, variant, fn in first:
        device, host = cs.device_and_host_ms(fn, 10)
        cs.log("k7_bn_host", kernel=kernel, variant=variant, device_ms=device, host_ms=host,
               card=card)
    both = [n for n in K7BN_SUBS if not n.startswith(("fwd_", "bwd_"))]
    calls = [("fwd", "kept", fwd("kept"))]
    calls += [("fwd", n[4:], fwd(n)) for n in K7BN_SUBS if n.startswith("fwd_")]
    calls += [("fwd", n, fwd(n)) for n in both]
    calls += [("fwd", f"{k}_blocks_an_sm", fwd("kept", k)) for k in (1, 3)]
    calls += [("fwd", f"kept_{c}_channels", fwd("kept", only=c)) for c in (1100, 550)]
    calls += [("bwd", "kept", bwd("kept"))]
    calls += [("bwd", n[4:], bwd(n)) for n in K7BN_SUBS if n.startswith("bwd_")]
    calls += [("bwd", n, bwd(n)) for n in both]
    calls += [("bwd", f"{k}_blocks_an_sm", bwd("kept", k)) for k in (1, 3)]
    calls += [("bwd", f"kept_{c}_channels", bwd("kept", only=c)) for c in (1100, 550)]
    for (kernel, variant), t in turns(calls, 10).items():
        cs.log("k7_bn_variant", kernel=kernel, variant=variant, **t, bound_ms=bounds[kernel],
               card=card)


# text replaced in pair_train_bwd.cu: (old, new), each old found exactly once
K4BWD_SUBS = {
    # (the gate's wait and release stay: the helper warps wait for them)
    "dx_no_epilogue": [(
        "        // ---- dc2: the sum over the sequences, in a fixed order ---------------\n",
        "        if (b >= 0) continue;\n")],
    "dx_no_w_load": [(
        "            mbar_expect_tx(full_bar(s), Lay::STAGE);\n",
        "            mbar_expect_tx(full_bar(s), 2 * Lay::A_BYTES);\n"), (
        "            tma_load(st + 2 * Lay::A_BYTES, &tm_w, ns * BK, k0, full_bar(s));\n",
        "")],
    "dx_no_dc_sum": [(
        "          if (!write) {\n"
        "            const float2 o = slot;\n"
        "            v = make_float2(o.x + v.x, o.y + v.y);\n"
        "          }\n"
        "          if (!out) {\n"
        "            slot = v;\n"
        "          } else if",
        "          (void)slot;\n"
        "          (void)write;\n"
        "          if (!out) {\n"
        "          } else if")],
    "dx_no_column_sums": [(
        "        // ---- da2: the tile's column sums ------------------------------------\n",
        "        if (b >= 0) continue;\n")],
    "dx_2_stages": [("  static constexpr int STAGES = 3;\n", "  static constexpr int STAGES = 2;\n")],
    "dw_no_a_formation": [(
        "          fa[kk][i] = pack_bf16x2(fmaxf(a + v.x, 0.f), fmaxf(a + v.y, 0.f));\n",
        "          fa[kk][i] = cf[kk][i];\n          (void)a;\n          (void)v;\n")],
    "dw_no_dz_load": [(
        "            mbar_expect_tx(full_bar(s), Lay::D_BYTES);\n"
        "#pragma unroll\n"
        "            for (int i = 0; i < BN / 64; ++i)\n"
        "              tma_load_3d(st + i * BOX, &tm_dz, it.n0 + 64 * i, lb * 64, b, full_bar(s));\n",
        "            mbar_arrive(full_bar(s));\n"
        "            (void)st;\n")],
}
# (B, L) at which the kept kernels and the first design's are timed in turns
K4BWD_SHAPES = [(32, 32102), (32, 8192), (32, 2048), (128, 2048), (32, 300)]


def k4_bwd_variants(build_dir: str, card: str) -> None:
    """K4-bwd's dX and dW: the kept kernels and the first design's
    (``csrc/variants/pair_train_bwd_v1.cu``) in turns (kept, first, first,
    kept) at each of ``K4BWD_SHAPES``; then, at 32 x 32,102, the kept
    kernels with parts taken out or one design choice changed, and dW with
    every tile whole (no pieces), each timed twice (the list forward, then
    backward); all through the libraries' C entry points."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import streaming_train as st

    base = (kernels.CSRC_DIR / "pair_train_bwd.cu").read_text()
    jobs = {"first_design": (os.path.join(VARIANT_DIR, "pair_train_bwd_v1.cu"),
                             os.path.join(build_dir, "libpair_train_bwd_v1.so"))}
    for name, subs in [("kept", [])] + list(K4BWD_SUBS.items()):
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K4-bwd variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"pair_train_bwd_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libpair_train_bwd_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (_, out) in jobs.items():
        cs.log("k4_bwd_variant_ptxas", variant=name, ptxas=logs[name])
        lib = ctypes.CDLL(out)
        if name == "first_design":
            lib.pair_train_dx.argtypes = [P] * 6 + [I] * 5 + [P]
            lib.pair_train_dw.argtypes = [P] * 5 + [I] * 7 + [P]
        else:
            lib.pair_train_dx.argtypes = [P] * 8 + [I] * 6 + [P]
            lib.pair_train_dw.argtypes = [P] * 5 + [I] * 8 + [P]
        libs[name] = lib
    H = cs.H
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn(H, H, device=dev, generator=gen) * 0.02).to(bf16)
    dw = torch.empty(H, H, device=dev, dtype=bf16)

    def shape_calls(B, L):
        a2 = torch.randn(B, H, device=dev, generator=gen).to(bf16)
        c2 = torch.randn(L, H, device=dev, generator=gen).to(bf16)
        dz = (torch.randn(B * L, H, device=dev, generator=gen) * 1e-3).to(bf16)
        dxp, dwp = st.pair_dx_plan(B, L, H, H, sms), st.pair_dw_plan(B, L, H, H, sms)
        f32 = dict(device=dev, dtype=torch.float32)
        da2_part = torch.empty(dxp.ranges, B, H, **f32)
        dc2_part = torch.empty(dxp.groups, L, H, **f32) if dxp.groups > 1 else None
        da2, dc2 = torch.empty(B, H, device=dev, dtype=bf16), torch.empty(L, H, device=dev,
                                                                           dtype=bf16)
        slots = torch.empty(max(1, dwp.tail * dwp.pieces), 128, dwp.block_n, **f32)
        da2_f32, part_v1 = torch.zeros(B, H, **f32), torch.empty(1, H, H, **f32)
        v1_dx_grid = min(sms, -(-L // 128) * (H // 128))

        def dx(lib):
            def run():
                if lib is libs["first_design"]:
                    da2_f32.zero_()
                    err = lib.pair_train_dx(dz.data_ptr(), w.data_ptr(), a2.data_ptr(),
                                            c2.data_ptr(), da2_f32.data_ptr(), dc2.data_ptr(), B,
                                            L, H, H, v1_dx_grid, stream)
                else:
                    err = lib.pair_train_dx(dz.data_ptr(), w.data_ptr(), a2.data_ptr(),
                                            c2.data_ptr(), da2_part.data_ptr(),
                                            None if dc2_part is None else dc2_part.data_ptr(),
                                            da2.data_ptr(), dc2.data_ptr(), B, L, H, H,
                                            dxp.ranges, dxp.groups, stream)
                if err != 0:
                    raise RuntimeError(f"pair_train_dx variant: CUDA error {err}")
            return run

        def dw_call(lib, pieces=None):
            def run():
                if lib is libs["first_design"]:
                    err = lib.pair_train_dw(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(),
                                            part_v1.data_ptr(), dw.data_ptr(), B, L, H, H, 256,
                                            1, min(sms, 288), stream)
                else:
                    err = lib.pair_train_dw(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(),
                                            slots.data_ptr(), dw.data_ptr(), B, L, H, H,
                                            dwp.block_n, dwp.full,
                                            dwp.pieces if pieces is None else pieces, dwp.grid,
                                            stream)
                if err != 0:
                    raise RuntimeError(f"pair_train_dw variant: CUDA error {err}")
            return run

        return dx, dw_call

    def turns(calls, reps):
        times = {(k, v): [] for k, v, _ in calls}
        for order in (calls, calls[::-1]):
            for kernel, variant, fn in order:
                times[(kernel, variant)].append(cs.cuda_time_ms(fn, reps))
        return times

    for B, L in K4BWD_SHAPES:
        dx, dw_call = shape_calls(B, L)
        reps = max(3, int(3 * 32 * 32102 / (B * L)))
        times = turns([("dx", "kept", dx(libs["kept"])),
                       ("dx", "first_design", dx(libs["first_design"])),
                       ("dw", "kept", dw_call(libs["kept"])),
                       ("dw", "first_design", dw_call(libs["first_design"]))], reps)
        ops = 2.0 * B * L * H * H
        for (kernel, variant), t in times.items():
            cs.log("k4_bwd_turns", batch=B, labels=L, kernel=kernel, variant=variant, ms=t,
                   tflops=[ops / x / 1e9 for x in t], card=card)
        del dx, dw_call
        torch.cuda.empty_cache()
    B, L = cs.TRAIN_B, cs.NUM_LABELS
    dx, dw_call = shape_calls(B, L)
    calls = [("dx", "kept", dx(libs["kept"]))]
    calls += [("dx", name[3:], dx(libs[name])) for name in K4BWD_SUBS if name.startswith("dx_")]
    calls += [("dw", "kept", dw_call(libs["kept"])),
              ("dw", "tiles_whole", dw_call(libs["kept"], pieces=1))]
    calls += [("dw", name[3:], dw_call(libs[name])) for name in K4BWD_SUBS
              if name.startswith("dw_")]
    ops = 2.0 * B * L * H * H
    for (kernel, variant), t in turns(calls, 3).items():
        cs.log("k4_bwd_variant", kernel=kernel, variant=variant, ms=t,
               tflops=[ops / x / 1e9 for x in t], card=card)


# text replaced in pair_scorer_int8.cu's code passes: (old, new), each old
# found exactly once (timing only: the results are wrong)
K2CODES_SUBS = {
    # layer 1's codes kernel: a's slice and c made from indices, not loaded
    "first_no_loads": [(
        "        __ldg(reinterpret_cast<const float4*>(a + (size_t)(b0 + b) * K + k0) + j);\n",
        "        make_float4(f * 1e-3f, j * 1e-2f, b0 * 1e-3f, k0 * 1e-4f);\n"), (
        "    cv[k] = l < nl ? __ldg(reinterpret_cast<const float4*>(c + (size_t)(l0 + l) * K + col) + k)\n"
        "                   : make_float4(0.f, 0.f, 0.f, 0.f);\n",
        "    cv[k] = make_float4(l * 1e-3f, k * 1e-2f, col * 1e-4f, nl * 1e-5f);\n")],
    # ... its 16-byte stores (a store that never happens in their place)
    "first_no_stores": [(
        "    *reinterpret_cast<uint4*>(codes + r * K + col) = make_uint4(w[0], w[1], w[2], w[3]);\n",
        "    if ((w[0] & w[1] & w[2] & w[3]) == 0x12345678u)\n"
        "      *reinterpret_cast<uint4*>(codes + r * K + col) = make_uint4(w[0], w[1], w[2], w[3]);\n")],
    # ... a multiply by the row's reciprocal for the division (dynamic)
    "first_no_division": [(
        "        auto q = [&](float x) { return DYN ? div_bf16(x, s, rs) : __fmul_rn(x, s); };\n",
        "        auto q = [&](float x) { return __fmul_rn(x, DYN ? rs : s); };\n")],
    # ... the division with div_rn's two corrections (the first design's)
    "first_two_corrections": [(
        "        auto q = [&](float x) { return DYN ? div_bf16(x, s, rs) : __fmul_rn(x, s); };\n",
        "        auto q = [&](float x) { return DYN ? div_rn(x, s, rs) : __fmul_rn(x, s); };\n")],
    # layer 1's dynamic form without its scale kernel (the max sweep)
    "first_no_max_sweep": [(
        "    pair_int8_first_scale_kernel<<<grid, 256, smem, s>>>(\n",
        "    if (grid < 0) pair_int8_first_scale_kernel<<<grid, 256, smem, s>>>(\n")],
    # layer 1's dynamic form: its scale kernel alone (no codes kernel)
    "first_scale_only": [(
        "  return first_codes<true, true>(a, c, row_scale, codes, p, B, nl, nl_pad, l0, K, 0.f, s);\n",
        "  return 0;\n")],
    # ... its scale kernel alone without its sums, and empty (the floor)
    "first_scale_only_no_compute": [(
        "  return first_codes<true, true>(a, c, row_scale, codes, p, B, nl, nl_pad, l0, K, 0.f, s);\n",
        "  return 0;\n"), (
        "      if (mine) {\n        for (int i4 = q; i4 < n4; i4 += parts) {\n",
        "      if (mine && n4 < 0) {\n        for (int i4 = q; i4 < n4; i4 += parts) {\n")],
    "first_scale_only_empty": [(
        "  return first_codes<true, true>(a, c, row_scale, codes, p, B, nl, nl_pad, l0, K, 0.f, s);\n",
        "  return 0;\n"), (
        "  extern __shared__ float4 samples[];\n  __shared__ float part_max[256];\n",
        "  extern __shared__ float4 samples[];\n  __shared__ float part_max[256];\n"
        "  if (K > 0) {\n    if (threadIdx.x == 0 && B < 0) scales[blockIdx.x] = margin;\n"
        "    return;\n  }\n")],
    # ... its scale kernel without c's loads, or without a's
    "first_scale_no_c_loads": [(
        "          cp_async4(smem_u32(reinterpret_cast<float*>(c_s + lf * SCALE_PITCH4) + i),\n"
        "                    c + (valid ? (size_t)(label0 + lg + lf) * K + (size_t)(r0 + i) * stride : 0),\n"
        "                    valid);\n",
        "          reinterpret_cast<float*>(c_s + lf * SCALE_PITCH4)[i] = valid ? lf * 1e-3f + i * 1e-4f : 0.f;\n")],
    "first_scale_no_a_loads": [(
        "            cp_async16(smem_u32(a_s + bf * SCALE_PITCH4 + i4),\n"
        "                       reinterpret_cast<const float4*>(a_sub + (size_t)(b0 + bf) * ns + r0) + i4);\n",
        "            a_s[bf * SCALE_PITCH4 + i4] = make_float4(bf * 1e-3f, i4 * 1e-4f, b0 * 1e-2f, r0 * 1e-5f);\n")],
    # layer 1's codes kernel two sequences an iteration
    "first_unroll_2": [("  __syncthreads();\n  for (int b = sg; b < bt; b += p.seq_groups) {\n",
                        "  __syncthreads();\n#pragma unroll 2\n"
                        "  for (int b = sg; b < bt; b += p.seq_groups) {\n")],
    # the later layers' division with div_rn's two corrections
    "later_two_corrections": [(
        "  auto q = [&](float x) { return DIV ? div_bf16(x, s, r) : __fmul_rn(x, s); };\n",
        "  auto q = [&](float x) { return DIV ? div_rn(x, s, r) : __fmul_rn(x, s); };\n")],
    # layer 1's codes kernel held to 40 registers (6 blocks an SM)
    "first_6_blocks": [(
        "template <bool DYN, bool POS>\n__global__ void __launch_bounds__(CODE_THREADS)\n",
        "template <bool DYN, bool POS>\n__global__ void __launch_bounds__(CODE_THREADS, 6)\n")],
    # ... the codes' stores streaming (evict-first) in the codes kernel
    "first_streaming_stores": [(
        "    *reinterpret_cast<uint4*>(codes + r * K + col) = make_uint4(w[0], w[1], w[2], w[3]);\n",
        "    __stcs(reinterpret_cast<uint4*>(codes + r * K + col), make_uint4(w[0], w[1], w[2], w[3]));\n")],
    # the later layers' kernel: the row made from indices, not loaded
    "later_no_loads": [(
        "      v[k] = i < nv ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);\n",
        "      v[k] = make_uint4(i * 0x10001u + r, i ^ r, 0x3f803f80u + i, (r << 4) + k);\n")],
    # ... its stores
    "later_no_stores": [(
        "      if (i < nv)\n"
        "        out[i] = make_uint2(",
        "      if (i < nv) {\n"
        "        const uint2 o = make_uint2("), (
        "                            codes4<true>(lo(v[k].z), hi(v[k].z), lo(v[k].w), hi(v[k].w), s, rs));\n",
        "                            codes4<true>(lo(v[k].z), hi(v[k].z), lo(v[k].w), hi(v[k].w), s, rs));\n"
        "        if ((o.x & o.y) == 0x12345678u) out[i] = o;\n"
        "      }\n")],
    # ... its maximum (a scale from the row index in its place)
    "later_no_max_sweep": [(
        "  mb = __reduce_max_sync(0xffffffffu, mb);\n",
        "  mb = 0x3f80u + (r & 7);\n")],
}


# other tilings of layer 1's codes kernel timed by --k2-codes: (units,
# labels, sequence groups), units * labels * groups = 256
K2CODES_PLANS = ((2, 64, 2), (1, 64, 4), (4, 16, 4), (8, 16, 2))


def k2_codes_variants(build_dir: str, card: str) -> None:
    """K2's code passes: the kept kernels against the first design
    (``csrc/variants/k2_codes_v1.cu``, through its own entry points and its
    wrapper's per-launch work, copied here) in turns on a batch's chunks at
    the full serving width, each by CUDA events and as device time, with
    the host's time a launch of each wrapper; the kept source with parts
    taken out (``K2CODES_SUBS``); and K2 whole, static and dynamic, with
    the kept passes and with the first design's, in turns (kept, first,
    first, kept), with the GEMM's device time in each."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import pair_scorer as ps

    base = (kernels.CSRC_DIR / "pair_scorer_int8.cu").read_text()
    jobs = {"first_design": (os.path.join(VARIANT_DIR, "k2_codes_v1.cu"),
                             os.path.join(build_dir, "libk2_codes_v1.so"))}
    for name, subs in K2CODES_SUBS.items():
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K2 code-pass variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"pair_scorer_int8_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libpair_scorer_int8_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, (_, out) in jobs.items():
        cs.log("k2_codes_variant_ptxas", variant=name, ptxas=logs[name])
        lib = ctypes.CDLL(out)
        if name == "first_design":
            lib.pair_int8_codes.argtypes = [P] * 3 + [I] * 5 + [F, P]
            lib.pair_int8_row_scale.argtypes = [P] * 5 + [I] * 6 + [F, I, P]
        else:
            lib.pair_int8_codes.argtypes = [P] * 3 + [I] * 5 + [F] + [I] * 4 + [P]
            lib.pair_int8_row_scale.argtypes = [P] * 6 + [I] * 6 + [F] + [I] * 7 + [P]
        lib.pair_int8_codes.restype = lib.pair_int8_row_scale.restype = ctypes.c_int
        libs[name] = lib
    first = libs["first_design"]
    kept = kernels.load_kernel_library("pair_scorer_int8").lib

    def first_design_quantize(k):
        """The first design's wrapper as it was: its scale's reciprocal
        made on the CPU, the stride and margin, and the arguments, every
        launch."""
        def quantize(ch, i):
            M, H = k.B * ch.nl_pad, k.H
            if k.static is not None:
                err = first.pair_int8_codes(
                    ps._ptr(k.a), ps._ptr(k.c), ps._ptr(k.codes[0]), ch.nl, ch.nl_pad, ch.l0,
                    M, H, float(ps._inv(k.static[0], "cpu")), k.stream)
            else:
                stride = 8 if H >= 1024 else 1
                err = first.pair_int8_row_scale(
                    ps._ptr(k.a), ps._ptr(k.c), ps._ptr(None if i == 0 else k.h),
                    k.scale_ptrs[ch][i > 0], ps._ptr(k.codes[0]), ch.nl, ch.nl_pad, ch.l0, M, H,
                    stride, 1.3 if stride > 1 else 1.0, int(i == 0), k.stream)
            if err != 0:
                raise RuntimeError(f"first design's code pass: CUDA error {err}")
        return quantize

    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    folded = cs.random_folded(gen, cs.D_LATENT, cs.H, 2, dev)
    P_e = torch.randn(cs.B, cs.D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(cs.NUM_LABELS * cs.K_DESCRIPTIONS, cs.D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode(), torch.cuda.device(dev):
        scales = ps.calibrate_act_scales(folded, P_e, L_e, cs.LABEL_TILE)
        qs = {"static": ps.quantize_folded(folded, act_scales=scales),
              "dynamic": ps.quantize_folded(folded)}
        ks = {m: ps._Int8Kernel(q, P_e, L_e, torch.bfloat16) for m, q in qs.items()}
        olds = {m: first_design_quantize(k) for m, k in ks.items()}
        chunks = ks["static"].plan.chunks
        rows = cs.B * L_e.shape[0]
        out_bytes = 1.0 * rows * cs.H + 4.0 * rows
        bounds = {"codes": cs.bound(nbytes=4.0 * (cs.B + L_e.shape[0]) * cs.H + 1.0 * rows * cs.H),
                  "first": cs.bound(nbytes=4.0 * (cs.B + L_e.shape[0]) * cs.H + out_bytes),
                  "later": cs.bound(nbytes=2.0 * rows * cs.H + out_bytes)}
        # the bf16 carry the later form reads: the kept layer 1's, chunk 0
        kd = ks["dynamic"]
        kd.quantize(chunks[0], 0)
        kd.layer(chunks[0], 0, None)
        # the same bits from both designs on the first and the last chunk
        differ = {}
        for mode, i, form in (("static", 0, "codes"), ("dynamic", 0, "first"),
                              ("dynamic", 1, "later")):
            k, n = ks[mode], 0
            for ch in (chunks[0], chunks[-1]) if i == 0 else (chunks[0],):
                r = cs.B * ch.nl_pad
                k.quantize(ch, i)
                scales = k.scales_of(ch, i)
                mine = k.codes[0][:r].clone(), None if scales is None else scales.clone()
                olds[mode](ch, i)  # into the same places
                n += int((mine[0] != k.codes[0][:r]).sum())
                if mine[1] is not None:
                    n += int((mine[1] != scales).sum())
            differ[form] = n
        cs.log("k2_codes_same_bits", differ=differ, card=card)
        if any(differ.values()):
            raise AssertionError(f"the kept code passes and the first design differ: {differ}")

        def batch(quantize, i):
            def run():
                for ch in chunks:
                    quantize(ch, i)
            return run

        def variant(name, mode, first_layer, plan=None):
            lib = libs[name] if name != "kept" else kept
            fn = getattr(lib, "pair_int8_codes" if mode == "static" else "pair_int8_row_scale")
            args = [ks[mode]._quantize[ch, first_layer][2] for ch in chunks]
            if plan is not None:  # units, labels, sequence groups (then seq_tile, ...)
                at = 9 if mode == "static" else 14
                args = [a[:at] + tuple(plan) + a[at + 3:] for a in args]

            def run():
                for a in args:
                    if fn(*a) != 0:
                        raise RuntimeError(f"K2 code-pass variant {name} failed")
            return run

        passes = (("codes", "static", 0), ("first", "dynamic", 0), ("later", "dynamic", 1))
        calls = []
        for form, mode, i in passes:
            calls += [(form, "kept", batch(ks[mode].quantize, i)),
                      (form, "first_design", batch(olds[mode], i))]
        times = {(f, v): {"ms": [], "device_ms": []} for f, v, _ in calls}
        for order in (calls, calls[::-1]):
            for form, name, fn in order:
                times[(form, name)]["ms"].append(cs.cuda_time_ms(fn, 3))
                _, busy, _ = cs.device_profile(fn, 2)
                times[(form, name)]["device_ms"].append(None if busy is None else busy * 1e3 / 2)
        for (form, name), t in times.items():
            cs.log("k2_codes_turns", form=form, variant=name, **t, launches=len(chunks),
                   **bounds[form], card=card)
        # the host's time a launch of each wrapper (layer 1's dynamic form on
        # the second chunk: the first chunk's launch also makes every chunk's
        # scales)
        for form, mode, i in passes:
            ch = chunks[1] if form == "first" else chunks[0]
            for name, quantize in (("kept", ks[mode].quantize), ("first_design", olds[mode])):
                device, host = cs.device_and_host_ms(lambda: quantize(ch, i), 20)
                cs.log("k2_codes_host", form=form, variant=name, device_ms_a_launch=device,
                       host_ms_a_launch=host, card=card)
        # the kept source with parts taken out, on a batch's chunks
        calls = [(form, "kept", batch(ks[mode].quantize, i)) for form, mode, i in passes]
        for name in K2CODES_SUBS:
            for form, mode, i in passes:
                if (name.startswith("first") and form == "later") or \
                        (name.startswith("later") and form != "later") or \
                        (name.startswith(("first_no_division", "first_no_max_sweep",
                                          "first_scale")) and form != "first"):
                    continue
                calls.append((form, name, variant(name, mode, i == 0)))
        # other tilings of layer 1's codes kernel (units, labels, sequence
        # groups)
        for units, labels, groups in K2CODES_PLANS:
            for form, mode, i in passes[:2]:
                calls.append((form, f"plan_{units}_{labels}_{groups}",
                              variant("kept", mode, True, (units, labels, groups))))
        times = {(f, v): [] for f, v, _ in calls}
        for order in (calls, calls[::-1]):
            for form, name, fn in order:
                _, busy, _ = cs.device_profile(fn, 2)
                times[(form, name)].append(None if busy is None else busy * 1e3 / 2)
        for (form, name), t in times.items():
            cs.log("k2_codes_variant", form=form, variant=name, device_ms=t, card=card)
        # K2 whole with the kept passes and with the first design's
        calls = []
        for mode, k in ks.items():
            with_first = ps._Int8Kernel(qs[mode], P_e, L_e, torch.bfloat16)
            with_first.quantize = first_design_quantize(with_first)
            calls += [(mode, "kept", k.run), (mode, "first_design", with_first.run)]
        whole = {(m, v): {"ms": [], "device_ms": [], "layer_device_ms": [], "passes_device_ms": []}
                 for m, v, _ in calls}
        for order in (calls, calls[::-1]):
            for mode, name, fn in order:
                t = whole[(mode, name)]
                t["ms"].append(cs.cuda_time_ms(fn, 3))
                _, busy, top = cs.device_profile(fn, 1)
                t["device_ms"].append(None if busy is None else busy * 1e3)
                t["layer_device_ms"].append(sum(ms for n, ms in top if "pair_int8_layer" in n))
                t["passes_device_ms"].append(sum(ms for n, ms in top if "quantize" in n or
                                                 "first_" in n or "later_" in n))
        for (mode, name), t in whole.items():
            cs.log("k2_whole_turns", mode=mode, variant=name, **t, card=card)


def k3_variants(build_dir: str, card: str) -> None:
    """K3's update and finalize, kept and with parts taken out, timed by
    calling each library's C entry points at full width."""
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import kernels

    base = (kernels.CSRC_DIR / "eval_accumulator.cu").read_text()
    libs = {}
    for name, subs in [("kept", [])] + list(K3_SUBS.items()):
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K3 variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"eval_accumulator_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(build_dir, f"libeval_accumulator_{name}.so")
        cs.log("k3_variant_ptxas", variant=name, ptxas=nvcc(src, out))
        libs[name] = ctypes.CDLL(out)
        libs[name].eval_acc_update.argtypes = k3._UPDATE_ARGS
        libs[name].eval_acc_finalize.argtypes = k3._FINALIZE_ARGS
    L, nb, B = cs.NUM_LABELS, cs.NUM_BINS, cs.B
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    logits = (torch.randn(B, L, generator=gen) * 2).to(dev)
    targets = (torch.rand(B, L, generator=gen) < 0.01).float().to(dev)
    em, lm = torch.ones(B, device=dev), torch.ones(L, device=dev)
    state = k3.init_state(L, nb, dev)
    scratch = k3.scratch_for(None, B, dev)
    hist = torch.randint(0, 3, (2 * L * nb,), generator=gen, dtype=torch.int32)
    hist[: L * nb][torch.rand(L * nb, generator=gen) < 0.995] = 0
    hist = hist.to(dev)
    f32 = lambda n: torch.empty(n, device=dev)  # noqa: E731
    ap, npos, out, block_ap = f32(L), f32(L), f32(2), f32(k3.FINALIZE_BLOCK_CAP)
    micro = torch.empty(2 * nb, dtype=torch.int64, device=dev)
    block_n = torch.empty(k3.FINALIZE_BLOCK_CAP, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    names = ("tp", "fp", "fn", "hist", "precision_sum", "precision_count", "recall_sum",
             "recall_count", "covered")

    def update(lib):
        return lambda: lib.eval_acc_update(
            logits.data_ptr(), targets.data_ptr(), em.data_ptr(), lm.data_ptr(), None, B, L,
            L, nb, 0.5, *(state[n].data_ptr() for n in names), scratch.data_ptr(),
            scratch.numel(), stream)

    def finalize(lib):
        return lambda: lib.eval_acc_finalize(
            hist.data_ptr(), L, nb, ap.data_ptr(), npos.data_ptr(), micro.data_ptr(),
            block_ap.data_ptr(), block_n.data_ptr(), k3.FINALIZE_BLOCK_CAP, out.data_ptr(),
            stream)

    calls = [("update", "kept", update(libs["kept"])),
             ("update", "no_hist_adds", update(libs["update_no_hist_adds"])),
             ("finalize", "kept", finalize(libs["kept"])),
             ("finalize", "no_bin_sums", finalize(libs["finalize_no_bin_sums"]))]
    times = {(e, v): [] for e, v, _ in calls}
    for order in (calls, calls[::-1]):
        for entry, variant, fn in order:
            times[(entry, variant)].append(cs.cuda_time_ms(fn, 50))
    for (entry, variant), t in times.items():
        cs.log("k3_variant", entry=entry, variant=variant, ms=t, card=card)

# text replaced in masked_pool.cu: (old, new), each old found exactly once
K7POOL_SUBS = {
    "no_loads": [(
        "        if (r < L) v[u] = n == LANE_CHANNELS ? load8<A>(p + static_cast<size_t>(r) * pitch)\n"
        "                                             : load_tail(p + static_cast<size_t>(r) * pitch, n);\n",
        "        if (r < L) v[u] = make_uint4(r, c0, 0, 0);\n")],
    "in_flight_2": [("constexpr int IN_FLIGHT = 4; ", "constexpr int IN_FLIGHT = 2; ")],
    "in_flight_8": [("constexpr int IN_FLIGHT = 4; ", "constexpr int IN_FLIGHT = 8; ")],
    # 16 or 32 row slots a block
    "threads_256": [("constexpr int POOL_THREADS = 1024; ", "constexpr int POOL_THREADS = 256; "),
                    ("__launch_bounds__(POOL_THREADS, 1)", "__launch_bounds__(POOL_THREADS, 6)")],
    "threads_512": [("constexpr int POOL_THREADS = 1024; ", "constexpr int POOL_THREADS = 512; "),
                    ("__launch_bounds__(POOL_THREADS, 1)", "__launch_bounds__(POOL_THREADS, 3)")],
    # 256-channel groups: 5 blocks a sequence, 16 row slots
    "group_256": [("constexpr int GROUP_CHANNELS = 128; ", "constexpr int GROUP_CHANNELS = 256; ")],
    "ldcs": [("    return __ldg(reinterpret_cast<const uint4*>(p));",
              "    return __ldcs(reinterpret_cast<const uint4*>(p));")],
    "bwd_rows_64": [("constexpr int BWD_ROWS = 32; ", "constexpr int BWD_ROWS = 64; ")],
    "bwd_stcs": [("    if (r0 + u < T) o[static_cast<size_t>(u) * step] = r0 + u < L ? val : zero;",
                  "    if (r0 + u < T) __stcs(o + static_cast<size_t>(u) * step, r0 + u < L ? val : zero);")],
}
K7POOL_RUN = 32  # rows of a run of the runs form (csrc/variants/masked_pool_runs.cu RUN)


# text replaced in bn_relu.cu ("kept_*") or csrc/variants/bn_relu_dense_v1.cu
# ("first_*"): (old, new), each old found exactly once
_HASH = ("  return (fmix32(rh ^ ck) >> 8) < d.threshold;\n",
         "  return ((rh ^ ck) >> 8) < d.threshold;\n")
_SUM_BLOCKS = "constexpr int DENSE_SUM_BLOCKS = {};"
_DZ_LOOP = ("#pragma unroll {}\n  for (long long r = blockIdx.x; r < N; r += gridDim.x) {{\n"
            "    const long long v = (r * vpr + cv) * VEC;\n    const float mn")
K5DENSE_SUBS = {
    "first_no_hash": [_HASH],
    "first_loads_only": [
        ("    dropped_dy<T, DROP>(dk, i, ck, df);\n", ""),
        ("      const float ge = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;\n"
         "      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);\n"
         "      g[0][e] = __fadd_rn(g[0][e], ge);\n"
         "      g[1][e] = __fadd_rn(g[1][e], __fmul_rn(ge, xhat));\n",
         "      g[0][e] = __fadd_rn(g[0][e], zf[e]);\n"
         "      g[1][e] = __fadd_rn(g[1][e], df[e]);\n"),
        ("    dropped_dy<T, DROP>(dk, r, ck, df);\n", ""),
        ("      const float g = affine(zf[e], iv[e], sh[e]) > 0.f ? df[e] : 0.f;\n"
         "      const float xhat = __fmul_rn(__fsub_rn(zf[e], mu[e]), is[e]);\n"
         "      const float inner = __fadd_rn(g1[e], __fmul_rn(g2[e], xhat));\n"
         "      out[e] = __fmul_rn(coef[e], __fsub_rn(g, __fmul_rn(mn, inner)));\n",
         "      out[e] = __fadd_rn(zf[e], df[e]);\n")],
    "kept_no_hash": [_HASH],
    "kept_mom_rows_4": [("constexpr int MOM_ROWS = 8;", "constexpr int MOM_ROWS = 4;")],
    "kept_mom_rows_16": [("constexpr int MOM_ROWS = 8;", "constexpr int MOM_ROWS = 16;")],
    "kept_sums_unroll_4": [("#pragma unroll(DROP ? 2 : 4)\n", "#pragma unroll 4\n")],
    "kept_sums_3_blocks": [(_SUM_BLOCKS.format(2), _SUM_BLOCKS.format(3))],
    "kept_sums_4_blocks": [(_SUM_BLOCKS.format(2), _SUM_BLOCKS.format(4))],
    "kept_dz_8_blocks": [("__launch_bounds__(EW_THREADS)\nbn_relu_dz_kernel(",
                          "__launch_bounds__(EW_THREADS, 8)\nbn_relu_dz_kernel(")],
    "kept_act_8_blocks": [("__launch_bounds__(EW_THREADS)\nact_dropout_kernel(",
                           "__launch_bounds__(EW_THREADS, 8)\nact_dropout_kernel(")],
    "kept_dz_unroll_4": [(_DZ_LOOP.format(2), _DZ_LOOP.format(4))],
}


def k5_dense_variants(build_dir: str, card: str) -> None:
    """``--k5-dense``: K5's dense BN forms against their first design in
    turns at phases 24's and 32's shapes, then with parts taken out."""
    from concurrent.futures import ThreadPoolExecutor
    import statistics

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops.streaming_train import _chunks

    texts = {"kept": (kernels.CSRC_DIR / "bn_relu.cu").read_text(),
             "first": open(os.path.join(VARIANT_DIR, "bn_relu_dense_v1.cu")).read()}
    jobs = {}
    for name, subs in [("kept", []), ("first", [])] + list(K5DENSE_SUBS.items()):
        text = texts[name.split("_")[0]]
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K5 dense variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"bn_relu_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libbn_relu_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    P = ctypes.c_void_p
    tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, P]
    libs = {}
    for name, (_, out) in jobs.items():
        cs.log("k5_dense_variant_ptxas", variant=name, ptxas=logs[name])
        lib = ctypes.CDLL(out)
        first = name.startswith("first")
        for sfx in ("", "_f32"):
            getattr(lib, f"bn_relu_dropout_forward{sfx}").argtypes = [P] * (15 if first else 13) \
                + tail
            getattr(lib, f"bn_relu_dropout_backward{sfx}").argtypes = [P] * 15 + tail
        libs[name] = lib
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    layer, rate = 0, cs.DENSE_RATE
    for dtype, seqs in ((torch.bfloat16, cs.TRAIN_B), (torch.float32, cs.DENSE_F32_B)):
        N, H = seqs * cs.NUM_LABELS, cs.H
        gen = torch.Generator(device=dev).manual_seed(5)
        z = (torch.randn(N, H, device=dev, generator=gen) + 0.3).to(dtype)
        dy = torch.randn(N, H, device=dev, generator=gen).to(dtype)
        em = torch.ones(seqs, device=dev)
        em[-1] = 0
        lm = (torch.rand(cs.NUM_LABELS, device=dev, generator=gen) < 0.98).float()
        rows = (em[:, None] * lm[None, :]).reshape(N, 1).contiguous()
        n = rows.sum().reshape(1)
        scale = 0.5 + torch.rand(H, device=dev, generator=gen)
        bias = 0.2 * torch.randn(H, device=dev, generator=gen)
        seed = torch.tensor([1234567, 7654321], dtype=torch.int64, device=dev)
        thr, keep = ds.keep_threshold(rate), ds.keep_scale(rate, dtype)
        chunks, per = _chunks(N)
        f32 = dict(dtype=torch.float32, device=dev)
        sfx = "_f32" if dtype == torch.float32 else ""
        part = torch.empty(3 * chunks * H + chunks, **f32)
        part1, part2 = torch.empty(chunks, H, **f32), torch.empty(chunks, H, **f32)
        zeros = torch.zeros(H, **f32)
        y, dz = torch.empty_like(z), torch.empty_like(z)
        outs = {k: [torch.empty(H, **f32) for _ in range(5)] for k in ("kept", "first")}
        grads = {k: [torch.empty(H, **f32) for _ in range(2)] for k in ("kept", "first")}
        ptr = lambda ts: [t.data_ptr() for t in ts]  # noqa: E731

        def fwd(name):
            lib = libs[name]
            stats = outs["first" if name.startswith("first") else "kept"]
            if name.startswith("first"):
                args = ptr((z, rows, n, zeros, scale, bias, seed, part1, part2, *stats, y))
            else:
                args = ptr((z, rows, n, scale, bias, seed, part, *stats, y))
            fn = getattr(lib, f"bn_relu_dropout_forward{sfx}")
            return lambda: cs_raise(fn(*args, N, H, chunks, per, layer, thr, keep, stream))

        def bwd(name):
            lib = libs[name]
            mean, _, istd, inv, shift = outs["first"]  # the first design's statistics
            G = grads["first" if name.startswith("first") else "kept"]
            args = ptr((z, dy, rows, n, scale, mean, istd, inv, shift, seed, part1, part2, *G,
                        dz))
            fn = getattr(lib, f"bn_relu_dropout_backward{sfx}")
            return lambda: cs_raise(fn(*args, N, H, chunks, per, layer, thr, keep, stream))

        def rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())

        # the forwards agree, the backwards give the same bits
        fwd("first")()
        y_first = y.clone()
        fwd("kept")()
        bwd("first")()
        dz_first, g_first = dz.clone(), [t.clone() for t in grads["first"]]
        bwd("kept")()
        torch.cuda.synchronize()
        same = torch.equal(dz, dz_first) and all(torch.equal(a, b) for a, b in
                                                 zip(grads["kept"], g_first))
        agree = {"y": rel(y, y_first), "mean": rel(outs["kept"][0], outs["first"][0]),
                 "var": rel(outs["kept"][1], outs["first"][1])}
        del y_first, dz_first
        cs.log("k5_dense_check", dtype=str(dtype), rows=N, width=H, backward_same_bits=same,
               forward_rel_errs=agree, card=card)
        if not same or agree["y"] > (cs.F32_REL_TOL if sfx else cs.K45_REL_TOL):
            raise AssertionError(f"K5 dense: backward same bits {same}, forward {agree}")
        nb = N * H * z.element_size()
        bounds = {"fwd": {"bound_ms": cs.bound(nbytes=2 * nb)["bound_ms"],
                          "floor_ms": cs.bound(nbytes=3 * nb)["bound_ms"]},
                  "bwd": {"bound_ms": cs.bound(nbytes=3 * nb)["bound_ms"],
                          "floor_ms": cs.bound(nbytes=5 * nb)["bound_ms"]}}
        calls = [(f"fwd:{k}", fwd(k)) for k in ("kept", "first")] + \
            [(f"bwd:{k}", bwd(k)) for k in ("kept", "first")]
        rounds = [timed_turns(calls, 5) for _ in range(3)]
        for label, _ in calls:
            kind, variant = label.split(":")
            ms = [x for r in rounds for x in r[label]["ms"]]
            dev_ms = [x for r in rounds for x in r[label]["device_ms"] if x is not None]
            cs.log("k5_dense_turns", kind=kind, variant=variant, dtype=str(dtype), rows=N,
                   ms=ms, median_ms=statistics.median(ms), device_ms=dev_ms,
                   median_device_ms=statistics.median(dev_ms) if dev_ms else None,
                   kernels_ms=rounds[-1][label]["kernels_ms"], **bounds[kind],
                   share_of_floor=bounds[kind]["floor_ms"] / statistics.median(ms), card=card)
        parts = [(f"fwd:{k}", fwd(k)) for k in ("kept", "first", "first_no_hash", "kept_no_hash",
                                                "kept_mom_rows_4", "kept_mom_rows_16",
                                                "kept_act_8_blocks")]
        parts += [(f"bwd:{k}", bwd(k)) for k in ("kept", "first", "first_no_hash",
                                                 "first_loads_only", "kept_sums_unroll_4",
                                                 "kept_sums_3_blocks", "kept_sums_4_blocks",
                                                 "kept_dz_unroll_4", "kept_dz_8_blocks")]
        for label, t in timed_turns(parts, 5).items():
            kind, variant = label.split(":")
            cs.log("k5_dense_variant", kind=kind, variant=variant, dtype=str(dtype), **t,
                   **bounds[kind], card=card)
        del z, dy, y, dz, part, part1, part2
        torch.cuda.empty_cache()


# text replaced in csrc/pair_dense.cu ("side_*") or csrc/pair_train.cu
# ("prod_*"): (old, new), each old found exactly once
DENSE_FIRST_SUBS = {
    # x by plain 16-byte loads from global memory, 8 labels' rows a warp in
    # flight (the ring brings only u); x's pointer passed down to the kernel
    "side_direct": [
        ("                 const T* __restrict__ u, const T* __restrict__ v, float* __restrict__ part,\n",
         "                 const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ v,\n"
         "                 float* __restrict__ part,\n"),
        ("cudaError_t launch_side_sums(const CUtensorMap (&maps)[2], const T* u,",
         "cudaError_t launch_side_sums(const CUtensorMap (&maps)[2], const T* x, const T* u,"),
        ("(maps[0], maps[1], u, v, part, sl,", "(maps[0], maps[1], x, u, v, part, sl,"),
        ("launch_side_sums<T>(maps, static_cast<const T*>(u),",
         "launch_side_sums<T>(maps, static_cast<const T*>(x), static_cast<const T*>(u),"),
        ("      const uint32_t tx = weighted_l ? Lay::STAGE : Lay::X_BYTES;\n",
         "      const uint32_t tx = weighted_l ? Lay::U_BYTES : 0;\n"),
        ("          tma_load_3d(st, &tm_x, c0, chunk * Lay::M, b, full_bar(s));\n", ""),
        ("          xr.load(xs + (warp + WARPS * i) * COLS, lane);\n",
         "          xr.load(x + ((size_t)b * L + l0 + WARPS * i) * K + c0, lane);\n")],
    # the loads alone: the ring's stages waited for and released, x not read
    "side_loads_only": [("        if (l0 + WARPS * i < L) {  // the same for every lane of the warp\n",
                         "        if (false) {\n")],
    # z not stored (the producer's TMA stores taken out)
    "prod_no_stores": [
        ("            tma_store_3d(&tm_z, base + Lay::C_OFF + (w * (BN / 64) + part) * EPI_BOX,\n"
         "                         it.n0 + 64 * part, it.l0, 2 * it.p + w);\n", "            {}\n")],
    # the epilogue's c from global memory (no c tile by TMA); c's pointer and
    # L passed down to the kernel
    "prod_global_c": [
        ("const float* __restrict__ ea, int B,\n",
         "const float* __restrict__ ea, const float* __restrict__ ec, int L, int B,\n"),
        ("cudaError_t launch_prod(const CUtensorMap (&maps)[5], const float* a, int B,",
         "cudaError_t launch_prod(const CUtensorMap (&maps)[5], const float* a, const float* ec,\n"
         "                        int L, int B,"),
        ("maps[3], maps[4], a, B, K,", "maps[3], maps[4], a, ec, L, B, K,"),
        ("launch_prod<256>(maps, a_, B,", "launch_prod<256>(maps, a_, static_cast<const float*>(c), L, B,"),
        ("launch_prod<128>(maps, a_, B,", "launch_prod<128>(maps, a_, static_cast<const float*>(c), L, B,"),
        ("        mbar_expect_tx(c_full, Lay::C_BYTES);\n#pragma unroll\n"
         "        for (int j = 0; j < BN / C_BOX_COLS; ++j)\n"
         "          tma_load(base + Lay::C_OFF + j * PM * 128, &tm_c, it.n0 + j * C_BOX_COLS, "
         "it.l0,\n                   c_full);\n",
         "        mbar_expect_tx(c_full, 0);\n        (void)it;\n"),
        ("        const float2 cv = *reinterpret_cast<const float2*>(\n"
         "            smem + Lay::C_OFF + (j / 4) * PM * 128 + r * 128 + ((chunk ^ (r & 7)) << 4) +\n"
         "            8 * (q & 1));\n",
         "        const float2 cv = it.l0 + r < L ? *reinterpret_cast<const float2*>(\n"
         "            ec + (size_t)(it.l0 + r) * N + it.n0 + 8 * j + 2 * q) : make_float2(0.f, 0.f);\n"
         "        (void)chunk;\n")],
}


def dense_first_variants(build_dir: str, card: str) -> None:
    """``--dense-first``: the dense first layer's kernels against their first
    designs in turns, then with parts taken out: ``pair_side_sums`` (bf16 at
    32 sequences, float32 at 16; dz's sums at K 3072 and dJ's weighted sums
    at K 1024) against ``csrc/variants/pair_dense_v1.cu``, by plain 16-byte
    loads and with its loads alone; ``pair_train_prod`` (32 x 32,102, d
    1024, H 3072, and a serving chunk with ReLU into K1's padded rows)
    against ``csrc/variants/pair_train_prod_v1.cu``, without its stores and
    with the epilogue's c from global memory, with K4 (``pair_train_hidden``) against its parent form and
    cuBLAS on the materialised prod rows beside; the L2's read rate
    (``csrc/variants/l2_read.cu``)."""
    import statistics

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import dense_scorer as ds
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops.streaming_train import _chunks, pair_train_plan

    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    side = build_subs(build_dir, "pair_dense", (kernels.CSRC_DIR / "pair_dense.cu").read_text(),
                      {k: v for k, v in DENSE_FIRST_SUBS.items() if k.startswith("side")},
                      {"first": os.path.join(VARIANT_DIR, "pair_dense_v1.cu"),
                       "l2": os.path.join(VARIANT_DIR, "l2_read.cu")})
    prod = build_subs(build_dir, "pair_train", (kernels.CSRC_DIR / "pair_train.cu").read_text(),
                      {k: v for k, v in DENSE_FIRST_SUBS.items() if k.startswith("prod")},
                      {"first": os.path.join(VARIANT_DIR, "pair_train_prod_v1.cu")})
    l2 = side.pop("l2")
    l2.l2_read.argtypes = [P, LL, I, I, I, I, P, P]
    for lib in side.values():
        for sym in ("pair_side_sums", "pair_side_sums_f32"):
            getattr(lib, sym).argtypes = [P] * 6 + [I] * 4 + [LL, P]
    for lib in prod.values():
        lib.pair_train_prod.argtypes = [P] * 6 + [I] * 8 + [P]
        lib.pair_train_hidden.argtypes = [P] * 4 + [I] * 6 + [P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    L = cs.NUM_LABELS

    failed = []  # checks that failed, raised once every part has run

    def median(r, label):
        ms = r[label]["ms"]
        dv = [x for x in r[label]["device_ms"] if x is not None]
        return {"ms": ms, "median_ms": statistics.median(ms), "device_ms": dv,
                "median_device_ms": statistics.median(dv) if dv else None,
                "kernels_ms": r[label]["kernels_ms"]}

    # ---- pair_side_sums ---------------------------------------------------
    for dtype, Bq in ((torch.bfloat16, cs.TRAIN_B), (torch.float32, cs.DENSE_F32_B)):
        sfx = "_f32" if dtype == torch.float32 else ""
        for K, weighted in ((cs.H, False), (cs.D_LATENT, True)):
            gen = torch.Generator(device=dev).manual_seed(K)
            x = torch.randn(Bq * L, K, device=dev, generator=gen).to(dtype)
            u = torch.randn(Bq, K, device=dev, generator=gen).to(dtype) if weighted else None
            v = torch.randn(L, K, device=dev, generator=gen).to(dtype) if weighted else None
            outs, scratch = {}, []

            def call(name, per=64):
                lib = side[name]
                chunks = -(-L // per)
                part = torch.empty(chunks, Bq * K, **f32)
                sb, sl = torch.empty(Bq, K, **f32), torch.empty(L, K, **f32)
                outs[name] = (sb, sl)
                scratch.append(part)  # the launches below keep its pointer
                args = (x.data_ptr(), None if u is None else u.data_ptr(),
                        None if v is None else v.data_ptr(), part.data_ptr(), sb.data_ptr(),
                        sl.data_ptr(), Bq, L, K, chunks, per, stream)
                fn = getattr(lib, f"pair_side_sums{sfx}")
                return lambda: cs_raise(fn(*args))

            calls = [("kept", call("kept")), ("first", call("first", _chunks(L)[1]))]
            for _, fn in calls:
                fn()
            sb1, sl1 = outs["first"]
            sb_k, sl_k = outs["kept"]
            runs = []
            for _ in range(3):
                runs.append((sb_k.clone(), sl_k.clone()))
                calls[0][1]()
            torch.cuda.synchronize()
            x3 = x.view(Bq, L, K)
            want_b = torch.stack([(x3[b].float() * (1.0 if v is None else v.float())).sum(0)
                                  for b in range(Bq)])
            check = {"same_bits_twice": all(torch.equal(sb_k, a) and torch.equal(sl_k, b)
                                            for a, b in runs)}
            if not check["same_bits_twice"]:
                check["runs_differ"] = [
                    {"sb": int((sb_k != a).sum()), "sl": int((sl_k != b).sum()),
                     "sl_rows": sorted({int(i) for i in (sl_k != b).any(1).nonzero()[:, 0]})[:12],
                     "sb_cols": sorted({int(i) for i in (sb_k != a).any(0).nonzero()[:, 0]})[:12],
                     "sl_vs_first": int((b != sl1).sum())} for a, b in runs]
            check["sl_first_bits"] = bool(torch.equal(sl_k, sl1))
            check["sb_rel_first"] = cs.rel_err(sb_k, sb1)
            check["sb_rel_plain"] = cs.rel_err(sb_k, want_b)
            del want_b
            tol = cs.depth_tol(L) if sfx else cs.K7_SUMS_REL_TOL
            cs.log("dense_first_side_check", dtype=str(dtype), sequences=Bq, width=K,
                   weighted=weighted, rel_tol=tol, **check, card=card)
            if not check["same_bits_twice"] or not check["sl_first_bits"] or \
                    check["sb_rel_plain"] > tol:
                failed.append(f"pair_side_sums{sfx}: {check}")
            calls += [("direct", call("side_direct")), ("loads_only", call("side_loads_only"))]
            nbytes = x.numel() * x.element_size() + L * K * 4 + (
                0 if u is None else (u.numel() + v.numel()) * x.element_size())
            rounds = [timed_turns(calls, 5) for _ in range(2)]
            for label, _ in calls:
                merged = {k: [y for r in rounds for y in r[label][k]] for k in ("ms", "device_ms")}
                merged["kernels_ms"] = rounds[-1][label]["kernels_ms"]
                per = _chunks(L)[1] if label == "first" else 64
                part_bytes = 2 * (-(-L // per)) * Bq * K * 4
                cs.log("dense_first_side_turns", variant=label, dtype=str(dtype), sequences=Bq,
                       width=K, weighted=weighted, **median({label: merged}, label),
                       **cs.bound(nbytes=nbytes), partial_bytes=part_bytes,
                       floor_ms=cs.bound(nbytes=nbytes + part_bytes)["bound_ms"], card=card)
            del x, u, v, outs, scratch, calls
            torch.cuda.empty_cache()

    # ---- pair_train_prod and K4 ---------------------------------------------
    Bq, d, Hh = cs.TRAIN_B, cs.D_LATENT, cs.H
    gen = torch.Generator(device=dev).manual_seed(71)
    a = torch.randn(Bq, Hh, device=dev, generator=gen)
    c = torch.randn(L, Hh, device=dev, generator=gen)
    P_e = torch.randn(Bq, d, device=dev, generator=gen).to(torch.bfloat16)
    L_e = torch.randn(L, d, device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn(d, Hh, device=dev, generator=gen) * (2.0 / d) ** 0.5).to(torch.bfloat16)
    wt = w.t().contiguous()
    plan = ds.prod_plan(Bq, L, d, Hh, sms)
    z = {k: torch.empty(Bq * L, Hh, dtype=torch.bfloat16, device=dev) for k in ("kept", "other")}

    def prod_call(name, out, a_=a, c_=c, le=L_e, Lrows=L, Lz=L, relu=0):
        fn = prod[name].pair_train_prod
        args = (P_e.data_ptr(), le.data_ptr(), wt.data_ptr(), a_.data_ptr(), c_.data_ptr(),
                out.data_ptr(), Bq, Lrows, Lz, d, Hh, relu, plan.block_n, plan.grid, stream)
        return lambda: cs_raise(fn(*args))

    same = {}
    for name in ("first", "prod_global_c"):
        prod_call("kept", z["kept"])()
        prod_call(name, z["other"])()
        torch.cuda.synchronize()
        same[name] = bool(torch.equal(z["kept"], z["other"]))
    # the serving form: ReLU into K1's padded rows, a chunk of each plan
    kplan = ps.launch_plan(Bq, L * cs.K_DESCRIPTIONS, Hh, 2)
    crow = torch.randn(L * cs.K_DESCRIPTIONS, Hh, device=dev, generator=gen)
    lrow = torch.randn(L * cs.K_DESCRIPTIONS, d, device=dev, generator=gen).to(torch.bfloat16)
    serve = {}
    for ch in (kplan.chunks[0], kplan.chunks[-1]):
        outs = []
        for name in ("kept", "first"):
            o = torch.full((Bq * ch.nl_pad, Hh), float("nan"), dtype=torch.bfloat16, device=dev)
            cl, ll = crow[ch.l0:ch.l0 + ch.nl], lrow[ch.l0:ch.l0 + ch.nl]
            fn = prod[name].pair_train_prod
            cs_raise(fn(P_e.data_ptr(), ll.data_ptr(), wt.data_ptr(), a.data_ptr(), cl.data_ptr(),
                        o.data_ptr(), Bq, ch.nl, ch.nl_pad, d, Hh, 1, plan.block_n, plan.grid,
                        stream))
            outs.append(o)
        torch.cuda.synchronize()
        serve[f"chunk_{ch.l0}_{ch.nl}_{ch.nl_pad}"] = bool(
            ((outs[0] == outs[1]) | (outs[0].isnan() & outs[1].isnan())).all())
        del outs
    ch = kplan.chunks[0]
    srv = {n: torch.empty(Bq * ch.nl_pad, Hh, dtype=torch.bfloat16, device=dev)
           for n in ("kept", "first")}
    cl, ll = crow[:ch.nl].contiguous(), lrow[:ch.nl].contiguous()
    # K4 on the same frame at its own depth (K 3072), kept and parent forms
    a2 = torch.randn(Bq, Hh, device=dev, generator=gen).to(torch.bfloat16)
    c2 = torch.randn(L, Hh, device=dev, generator=gen).to(torch.bfloat16)
    w2t = (torch.randn(Hh, Hh, device=dev, generator=gen) * Hh ** -0.5).to(torch.bfloat16)
    k4plan = pair_train_plan(Bq, L, Hh, Hh, sms)

    def k4_call(name, out):
        fn = prod[name].pair_train_hidden
        args = (a2.data_ptr(), c2.data_ptr(), w2t.data_ptr(), out.data_ptr(), Bq, L, Hh, Hh,
                k4plan.block_n, k4plan.grid, stream)
        return lambda: cs_raise(fn(*args))

    k4_call("kept", z["kept"])()
    k4_call("first", z["other"])()
    torch.cuda.synchronize()
    same["k4_parent"] = bool(torch.equal(z["kept"], z["other"]))
    cs.log("dense_first_prod_check", same_bits_as_kept=same, serving_same_bits=serve,
           plan={"grid": plan.grid, "items": plan.items, "block_n": plan.block_n}, card=card)
    if not all(same.values()) or not all(serve.values()):
        failed.append(f"pair_train_prod / K4 bits: {same}, serving {serve}")
    rows_p = (P_e[:, None] * L_e[None]).reshape(Bq * L, d)
    calls = [("kept", prod_call("kept", z["kept"])),
             ("first", prod_call("first", z["other"])),
             ("global_c", prod_call("prod_global_c", z["other"])),
             ("no_stores", prod_call("prod_no_stores", z["other"])),
             ("serving_kept", prod_call("kept", srv["kept"], c_=cl, le=ll, Lrows=ch.nl,
                                        Lz=ch.nl_pad, relu=1)),
             ("serving_first", prod_call("first", srv["first"], c_=cl, le=ll, Lrows=ch.nl,
                                         Lz=ch.nl_pad, relu=1)),
             ("k4_kept", k4_call("kept", z["kept"])),
             ("k4_first", k4_call("first", z["other"])),
             ("cublas", lambda: rows_p @ w)]
    flop = 2.0 * Bq * L * d * Hh
    rounds = [timed_turns(calls, 5) for _ in range(2)]
    for label, _ in calls:
        merged = {k: [y for r in rounds for y in r[label][k]] for k in ("ms", "device_ms")}
        merged["kernels_ms"] = rounds[-1][label]["kernels_ms"]
        m = median({label: merged}, label)
        if label.startswith("serving"):
            extra = cs.bound(ops=2.0 * Bq * ch.nl_pad * d * Hh)
        elif label.startswith("k4"):
            extra = cs.bound(ops=2.0 * Bq * L * Hh * Hh)
        else:
            extra = {**cs.bound(nbytes=Bq * L * Hh * 2, ops=flop),
                     "tflops": flop / m["median_ms"] / 1e9}
        cs.log("dense_first_prod_turns", variant=label, **m, **extra, card=card)
    del z, srv, rows_p, a2, c2, w2t
    torch.cuda.empty_cache()

    # ---- the L2's read rate -------------------------------------------------
    buf = torch.randn(6 * 2**20 // 4, device=dev)  # W_prod^T's 6 MB
    out = torch.empty(4 * 2048, dtype=torch.int32, device=dev)
    for region_kb in (512, 64):
        n16 = region_kb * 1024 // 16
        regions = 6 * 1024 // region_kb
        for grid, threads in ((sms, 512), (2 * sms, 512), (4 * sms, 256)):
            iters = 20

            def go(n16=n16, regions=regions, grid=grid, threads=threads, iters=iters):
                cs_raise(l2.l2_read(buf.data_ptr(), n16, regions, iters, grid, threads,
                                    out.data_ptr(), stream))

            ms = cs.cuda_time_ms(go, 3)
            cs.log("dense_first_l2_rate", region_kb=region_kb, blocks=grid, threads=threads,
                   ms=ms, tb_per_s=grid * iters * region_kb * 1024 / ms / 1e9, card=card)
    if failed:
        raise AssertionError("; ".join(failed))


def cs_raise(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"a K5 dense entry point returned CUDA error {rc}")


def build_subs(build_dir: str, stem: str, base: str, subs: dict, extra: dict) -> dict:
    """The kept source ``base`` as ``kept`` and with each entry of ``subs``
    (exact text, found once) replaced, plus ``extra`` {name: source path},
    one nvcc each, all at once: {name: CDLL}, ptxas lines logged."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs

    jobs = {name: (path, os.path.join(build_dir, f"lib{stem}_{name}.so"))
            for name, path in extra.items()}
    for name, pairs in [("kept", [])] + list(subs.items()):
        text = base
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{stem} variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"{stem}_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"lib{stem}_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    for name in jobs:
        cs.log(f"{stem}_variant_ptxas", variant=name, ptxas=logs[name])
    return {name: ctypes.CDLL(out) for name, (_, out) in jobs.items()}


def timed_turns(calls, reps: int) -> dict:
    """Each call's CUDA-event ms and device ms (the busy time of a
    ``torch.profiler`` pass) over ``reps`` calls, in turns: the list
    forward, then backward; with each call's per-kernel device ms."""
    import chip_smoke as cs

    out = {name: {"ms": [], "device_ms": []} for name, _ in calls}
    for order in (calls, calls[::-1]):
        for name, fn in order:
            out[name]["ms"].append(cs.cuda_time_ms(fn, reps))
            _, busy, top = cs.device_profile(fn, reps)
            out[name]["device_ms"].append(None if busy is None else busy * 1e3 / reps)
            out[name]["kernels_ms"] = [(re.sub(r"^.*::|\(.*$", "", n.replace(
                "(anonymous namespace)::", "")), ms) for n, ms in top]
    return out


def k7_pool_variants(build_dir: str, card: str) -> None:
    """``--k7-pool``: K7's masked mean pool (one launch, a block a
    sequence's 128 channels) against its first design
    (``csrc/variants/masked_pool_v1.cu``) and its runs form
    (``csrc/variants/masked_pool_runs.cu``: a block a run of 32 rows, then
    a launch adding the runs) in turns at 32 sequences
    x 1,100 channels, buckets 512 and 1,024 (``chip_smoke.k7_lengths``),
    the input at the padded pitch and contiguous; then the kept source with
    parts taken out or one choice changed; the pool's backward against the
    plain transpose (with and without its copy to the padded pitch); the
    host time a call of each wrapper."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import masked_conv as k7

    libs = build_subs(build_dir, "masked_pool", (kernels.CSRC_DIR / "masked_pool.cu").read_text(),
                      K7POOL_SUBS, {"first_design": os.path.join(VARIANT_DIR, "masked_pool_v1.cu"),
                                    "runs": os.path.join(VARIANT_DIR, "masked_pool_runs.cu")})
    for name, lib in libs.items():
        lib.masked_mean_pool.argtypes = k7._ARGS[("masked_pool", "masked_mean_pool")]
        if name == "runs":  # the scratch before the output
            lib.masked_mean_pool.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
        elif name != "first_design":
            lib.masked_mean_pool_backward.argtypes = k7._ARGS[("masked_pool",
                                                               "masked_mean_pool_backward")]
    dev, B, C = torch.device("cuda"), cs.B, 1100
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(19)
    for T in (512, 1024):
        lengths = torch.from_numpy(cs.k7_lengths(np.random.default_rng(17), T)).to(dev)
        padded = k7.pad_pitch(torch.randn(B, T, C, generator=gen, device=dev).to(torch.bfloat16))
        flat = padded.contiguous()
        want = k7.masked_mean_pool_reference(padded, lengths)
        out = torch.empty(B, C, device=dev)
        part = torch.empty(B * -(-T // K7POOL_RUN) * k7.row_pitch(C), device=dev)

        def pool(name, x):
            lib = libs[name]
            if name == "runs":
                return lambda: lib.masked_mean_pool(x.data_ptr(), lengths.data_ptr(), part.data_ptr(),
                                                    out.data_ptr(), B, T, C, x.stride(1), stream)
            return lambda: lib.masked_mean_pool(x.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                                                B, T, C, x.stride(1), stream)

        errs = {}
        for name in ("kept", "first_design", "runs", "in_flight_2", "in_flight_8",
                     "threads_256", "threads_512", "group_256", "ldcs"):
            for form, x in (("padded", padded), ("contiguous", flat)):
                if pool(name, x)() != 0:
                    raise RuntimeError(f"masked_mean_pool {name}: launch failed")
                torch.cuda.synchronize()
                errs[f"{name}_{form}"] = cs.rel_max(out, want)[1]
        if max(errs.values()) > cs.K7_F32_REL_TOL:
            raise AssertionError(f"K7 pool variants disagree with the plain pool: {errs}")
        valid = int(lengths.clamp(max=T).sum())
        bound = cs.bound(nbytes=2.0 * valid * C + 4.0 * B + 4.0 * B * C)["bound_ms"]
        first = [("kept", pool("kept", padded)), ("first_design", pool("first_design", padded)),
                 ("runs", pool("runs", padded)),
                 ("kept_contiguous", pool("kept", flat)),
                 ("first_design_contiguous", pool("first_design", flat))]
        for name, t in timed_turns(first, 20).items():
            cs.log("k7_pool_turns", bucket=T, variant=name, **t, bound_ms=bound,
                   device_share_of_bound=[bound / x for x in t["device_ms"] if x],
                   rel_err=errs.get(name if "contiguous" in name else f"{name}_padded"), card=card)
        parts = [("kept", pool("kept", padded))] + [
            (n, pool(n, padded)) for n in K7POOL_SUBS if not n.startswith("bwd_")]
        for name, t in timed_turns(parts, 20).items():
            cs.log("k7_pool_variant", bucket=T, variant=name, **t, bound_ms=bound, card=card)
        host = {"kept_wrapper": host_time_us(lambda: k7.masked_mean_pool_cuda(padded, lengths)),
                "kept_c_call": host_time_us(pool("kept", padded)),
                "output_alloc": host_time_us(lambda: padded.new_empty((B, C),
                                                                      dtype=torch.float32)),
                "first_design_c_call": host_time_us(pool("first_design", padded))}
        cs.log("k7_pool_host_us", bucket=T, **host, card=card)
        # the backward: the kept kernel and its variants against the plain transpose
        g = torch.randn(B, C, generator=gen, device=dev)
        dx = k7.padded_empty(B, T, C, torch.bfloat16, dev)
        ref = k7.masked_mean_pool_backward_reference(g, lengths, T, torch.bfloat16)

        def bwd(name):
            lib = libs[name]
            return lambda: lib.masked_mean_pool_backward(g.data_ptr(), lengths.data_ptr(),
                                                         dx.data_ptr(), B, T, C, dx.stride(1),
                                                         stream)

        for name in ("kept", "bwd_rows_64", "bwd_stcs"):
            if bwd(name)() != 0:
                raise RuntimeError(f"masked_mean_pool_backward {name}: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(dx.contiguous().view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"the pool's backward ({name}) differs from the plain one")
        plain = lambda: k7.masked_mean_pool_backward_reference(  # noqa: E731
            g, lengths, T, torch.bfloat16)
        bwd_bound = cs.bound(nbytes=4.0 * B * C + 4.0 * B + 2.0 * B * T * dx.stride(1))["bound_ms"]
        calls = [("kept", bwd("kept")), ("plain", plain),
                 ("plain_with_copy", lambda: k7.pad_pitch(plain())),
                 ("bwd_rows_64", bwd("bwd_rows_64")), ("bwd_stcs", bwd("bwd_stcs"))]
        for name, t in timed_turns(calls, 20).items():
            cs.log("k7_pool_bwd", bucket=T, variant=name, **t, bound_ms=bwd_bound, card=card)
        cs.log("k7_pool_bwd_host_us", bucket=T, kept_wrapper=host_time_us(
            lambda: k7.masked_mean_pool_backward_cuda(g, lengths, T)), card=card)


# text replaced in csrc/variants/threshold_sweep_v1.cu (the first update)
# and in threshold_sweep.cu (the kept one): (old, new), each found once
K9V1_ADD = "    atomicAdd(hist + ((size_t)slot * L + c), 1);\n"
K9V1_SUBS = {
    # k is still computed (the add is kept behind a test it never passes)
    "v1_no_adds": [(K9V1_ADD, "    if (slot < 0) atomicAdd(hist + ((size_t)slot * L + c), 1);\n")],
    # every element's add to its own word: row b's slot row, a warp's 32
    # columns on one 128-byte line
    "v1_distinct_coalesced": [(K9V1_ADD, "    atomicAdd(hist + ((size_t)((b0 + r) % (2 * (T + 1))) "
                                         "* L + c), slot | 1);\n")],
    # every element's add to its own word, a warp's 32 columns on 32 slot
    # rows (37 b + c mod 2 (T + 1): distinct for b < 2 (T + 1))
    "v1_distinct_scattered": [(K9V1_ADD, "    atomicAdd(hist + ((size_t)(((b0 + r) * 37 + c) % "
                                         "(2 * (T + 1))) * L + c), slot | 1);\n")],
}
K9_RING = 8  # batches of 32 rows a ring flush counts (ops/threshold_sweep.py RING_ROWS)
K9_SUBS = {
    # the flush without its L2 adds (the counts in shared memory still made)
    "flush_no_adds": [("        if (n != 0 && blockIdx.x * COLS + 32 * j + lane < L) "
                       "atomicAdd(row + 32 * j, n);",
                       "        if (n == 999) atomicAdd(row + 32 * j, n);")],
    # the flush without its shared-memory counts (nothing left to add)
    "flush_no_counts": [("      if (slot >= 0 && slot < slots) atomicAdd(s_cnt + slot * 32 + lane, one);",
                         "      if (slot == -7) atomicAdd(s_cnt + slot * 32 + lane, one);")],
    # k by a binary search over all T thresholds, without the bucket table
    "codes_binary_search": [("threshold_count(s_th, s_tab, prob_of(x[j]))",
                             "count_at_or_below(s_th, T, prob_of(x[j]))")],
    # the codes kernel with the loads and stores alone (no sigmoid, no search)
    "codes_loads_only": [("(y[j] > 0.0f ? 0 : T + 1) + threshold_count(s_th, s_tab, prob_of(x[j]));",
                          "(y[j] > 0.0f ? 0 : T + 1) + (x[j] > 7.0f);")],
}


def k9_update_variants(build_dir: str, card: str) -> None:
    """``--k9-update``: K9's update (a batch's slot codes into the ring, and
    a flush of the ring's 8 batches into the histogram) against its first
    design (``csrc/variants/threshold_sweep_v1.cu``: one L2 atomic an
    element) in turns on phase 7a's synthetic batch (32 x 32,256, logits
    N(0, 4)) and on a batch whose logits lie mostly below the least
    threshold (N(-8, 4), as a trained model's negatives), at 99 and 1,024
    thresholds, after checking that both give the same histogram; the
    aggregation alone (the codes and a flush every batch); the first design
    without its adds and with every add sent to a distinct address; the
    kept kernels with parts taken out; the share of repeated (slot, column)
    keys of each batch; the host time a call."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import threshold_sweep as k9

    v1_base = open(os.path.join(VARIANT_DIR, "threshold_sweep_v1.cu")).read()
    v1_libs = build_subs(build_dir, "threshold_sweep_v1", v1_base, K9V1_SUBS, {})
    libs = build_subs(build_dir, "threshold_sweep",
                      (kernels.CSRC_DIR / "threshold_sweep.cu").read_text(), K9_SUBS, {})
    for lib in v1_libs.values():
        lib.threshold_sweep_update.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p] * 2
    for lib in libs.values():
        lib.threshold_sweep_codes.argtypes = k9._CODES_ARGS
        lib.threshold_sweep_flush.argtypes = k9._FLUSH_ARGS
    dev, B, L = torch.device("cuda"), cs.B, cs.NUM_LABELS
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(9)
    spread = cs.k9_batches(gen, dev)[0]
    low = [t.clone() for t in spread]
    low[0] = (torch.randn(B, cs.K9_WIDTH, generator=gen) * 2.0 - 8.0).to(dev)
    pitch = k9.code_pitch(L)
    codes = torch.empty(K9_RING * B, pitch, dtype=torch.int16, device=dev)
    for T, thresholds in ((99, cs.sweep_thresholds()),
                          (1024, np.sort(np.random.default_rng(3).uniform(0, 1, 1024))
                           .astype(np.float32))):
        sweep = k9.SweepCounter(thresholds, L, dev)
        srt, size = sweep.sorted, k9.flush_plan(T)[0]
        hist = torch.zeros_like(sweep.hist)

        def first(lib, batch):
            logits, labels, mask = batch
            return lambda: lib.threshold_sweep_update(
                logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), srt.data_ptr(), B,
                logits.shape[1], L, T, hist.data_ptr(), stream)

        def codes_of(lib, batch, row=0):
            logits, labels, mask = batch
            return lambda: lib.threshold_sweep_codes(
                logits.data_ptr(), labels.data_ptr(), mask.data_ptr(), srt.data_ptr(), B,
                logits.shape[1], L, T, pitch, codes[row * B].data_ptr(), stream)

        def flush_of(lib, rows):
            return lambda: lib.threshold_sweep_flush(codes.data_ptr(), rows, L, pitch, T, size,
                                                     hist.data_ptr(), stream)

        for bname, batch in (("spread", spread), ("low", low)):
            hist.zero_()
            if first(v1_libs["kept"], batch)() != 0:
                raise RuntimeError("the first update: launch failed")
            torch.cuda.synchronize()
            want = hist.clone()
            hist.zero_()
            for i in range(K9_RING):
                if codes_of(libs["kept"], batch, i)() != 0:
                    raise RuntimeError("threshold_sweep_codes: launch failed")
            if flush_of(libs["kept"], K9_RING * B)() != 0:
                raise RuntimeError("threshold_sweep_flush: launch failed")
            torch.cuda.synchronize()
            if not torch.equal(hist, want * K9_RING):
                raise AssertionError(f"K9 ({bname}, T {T}): the ring's histogram differs from "
                                     f"the first design's")
            logits, labels, mask = batch
            n_valid = float((mask > 0).sum()) * L
            bound = cs.bound(nbytes=8.0 * logits.numel() + 4 * B + 4 * T + 8 * n_valid)["bound_ms"]
            kept = [("codes", codes_of(libs["kept"], batch)),
                    (f"flush_{K9_RING}_batches", flush_of(libs["kept"], K9_RING * B)),
                    ("flush_1_batch", flush_of(libs["kept"], B)),
                    ("first_design", first(v1_libs["kept"], batch))]
            t = timed_turns(kept, 50)
            dev_ms = {k: min(x for x in v["device_ms"] if x) for k, v in t.items()}
            a_batch = dev_ms["codes"] + dev_ms[f"flush_{K9_RING}_batches"] / K9_RING
            cs.log("k9_update_turns", batch=bname, thresholds=T, **t, bound_ms=bound,
                   device_ms_a_batch=a_batch, device_share_of_bound=bound / a_batch,
                   aggregation_alone_device_ms=dev_ms["codes"] + dev_ms["flush_1_batch"],
                   keys=cs.sweep_keys(sweep, logits, labels, mask), same_histogram=True,
                   card=card)
            if T != 99:  # the parts at the CLI's 99 thresholds only
                continue
            parts = [("codes", codes_of(libs["kept"], batch)),
                     ("codes_binary_search", codes_of(libs["codes_binary_search"], batch)),
                     ("codes_loads_only", codes_of(libs["codes_loads_only"], batch)),
                     (f"flush_{K9_RING}_batches", flush_of(libs["kept"], K9_RING * B)),
                     ("flush_no_adds", flush_of(libs["flush_no_adds"], K9_RING * B)),
                     ("flush_no_counts", flush_of(libs["flush_no_counts"], K9_RING * B)),
                     ("first_design", first(v1_libs["kept"], batch))] + \
                [(n, first(v1_libs[n], batch)) for n in K9V1_SUBS]
            for name, tt in timed_turns(parts, 50).items():
                cs.log("k9_update_variant", batch=bname, thresholds=T, variant=name, **tt,
                       bound_ms=bound, card=card)
        logits, labels, mask = spread
        cs.log("k9_update_host_us", thresholds=T,
               kept_counter=host_time_us(lambda: sweep.update(logits, labels, mask)),
               kept_codes_c_call=host_time_us(codes_of(libs["kept"], spread)),
               kept_update_cuda=host_time_us(lambda: k9.update_cuda(
                   sweep.hist, sweep.sorted, logits, labels, mask, L)),
               first_design_c_call=host_time_us(first(v1_libs["kept"], spread)), card=card)


def nvcc(src: str, out: str) -> str:
    """Build ``src`` into ``out`` with the port's flags; returns ptxas's
    lines naming each kernel and giving its registers and spills."""
    from protnote_tpu_torch.ops import kernels

    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
                           "-o", out, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    keep = ("registers", "spill", "Compiling entry function")
    return "\n".join(x.strip() for x in log.splitlines() if any(k in x for k in keep))


def build(build_dir: str):
    """Every variant, one nvcc each, all at once: {name: (CDLL, ptxas)}."""
    from concurrent.futures import ThreadPoolExecutor

    from protnote_tpu_torch.ops import kernels

    base = (kernels.CSRC_DIR / "text_attention.cu").read_text()
    jobs = {}
    for name, subs in K8A_VARIANTS.items():
        text = base
        for s in subs:
            old, new = SUBS[s]
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: '{s}' matches {text.count(old)} times")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"text_attention_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libtext_attention_{name}.so"))
    jobs["k2_register_a"] = (os.path.join(VARIANT_DIR, "k2_register_a.cu"),
                             os.path.join(build_dir, "libk2_register_a.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(lambda j: nvcc(*j), jobs.values())))
    return {n: (ctypes.CDLL(j[1]), logs[n]) for n, j in jobs.items()}


def k8a_variants(libs, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.ops import text_attention as k8a

    fns = {}
    for name in K8A_VARIANTS:
        fn = libs[name][0].masked_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    nh, hd = 16, 64
    gen = torch.Generator().manual_seed(30)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    out = {}
    with torch.inference_mode():
        for shape, Bq, T, lo, hi, causal in cs.K8_SHAPES:
            _, mask = cs.token_batch(gen, Bq, T, lo, hi, 100, 1)
            q, k, v = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev, bf16) for _ in range(3))
            ctx = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), ctx.data_ptr(),
                         Bq, nh, T, hd, int(causal), k8a.scale_for(hd), stream)
                if err != 0:
                    raise RuntimeError(f"masked_attention launch failed: CUDA error {err}")

            keep = (mask > 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
            add_mask = torch.where(keep, 0.0, k8a.MASKED).to(bf16)
            want = k8a.masked_attention_reference(q, k, v, mask, causal).float()
            rel = {}
            for name, fn in fns.items():
                ctx.zero_()
                call(fn)
                rel[name] = float((ctx.float() - want).abs().max() / want.abs().max())
            run = {name: (lambda f: lambda: call(f))(fn) for name, fn in fns.items()}
            run["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=add_mask)
            order = list(run)
            times = {name: [] for name in order}
            for sweep in (order, order[::-1]):
                for name in sweep:
                    times[name].append(cs.cuda_time_ms(run[name], 20))
            out[shape] = {"batch": Bq, "tokens": T, "causal": causal, "rel_err": rel,
                          "ms": {n: sum(t) / len(t) for n, t in times.items()},
                          "readings": times}
            cs.log("k8a_variants", shape=shape, **out[shape], card=card)
            del q, k, v, ctx, want, add_mask
    for name in ("kept", "two_pass_mma_sync"):
        if max(out[s]["rel_err"][name] for s in out) > cs.K8_REL_TOL:
            raise AssertionError(f"K8a variant {name} disagrees with the plain version")
    return out


def k2_register_a(libs, card: str) -> dict:
    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import pair_scorer as ps

    lib = libs["k2_register_a"][0]
    fn = lib.pair_int8_layer1_rega
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 6 + [f] * 3 + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    lib.pair_int8_layer1_rega_smem_bytes.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")
    folded = cs.random_folded(gen, cs.D_LATENT, cs.H, 2, dev)
    P_e = torch.randn(cs.B, cs.D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(cs.NUM_LABELS * cs.K_DESCRIPTIONS, cs.D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    out = {"smem_bytes": lib.pair_int8_layer1_rega_smem_bytes(), "chunks": {}}
    with torch.inference_mode(), torch.cuda.device(dev):
        q = ps.quantize_folded(folded, act_scales=ps.calibrate_act_scales(
            folded, P_e, L_e, cs.LABEL_TILE))
        k = ps._Int8Kernel(q, P_e, L_e, torch.bfloat16)
        s0 = float(q.act_scales[0])
        inv_in = float(ps._inv(q.act_scales[0], "cpu"))
        inv_next = float(ps._inv(q.act_scales[1], "cpu"))
        for which, ch in (("first", k.plan.chunks[0]), ("last", k.plan.chunks[-1])):
            rows = cs.B * ch.nl_pad
            codes = torch.zeros(rows, cs.H, dtype=torch.int8, device=dev)

            def register_a():
                err = fn(k.a.data_ptr(), k.c.data_ptr(), k.wt[0].data_ptr(), k.s_w[0].data_ptr(),
                         k.bias[0].data_ptr(), codes.data_ptr(), s0, inv_in, inv_next, cs.B,
                         ch.nl_pad, ch.l0, k.L, cs.H, cs.H, ch.grid, k.stream)
                if err != 0:
                    raise RuntimeError(f"pair_int8_layer1_rega launch failed: CUDA error {err}")

            k.quantize(ch, 0)
            k.layer(ch, 0, None)  # the next layer's codes into k.codes[1]
            register_a()
            differ = int((codes != k.codes[1][:rows]).sum())
            entry = {"rows": rows, "codes": rows * cs.H, "codes_differ": differ}
            if which == "first":
                run = {"kept_code_pass_and_gemm": lambda: (k.quantize(ch, 0), k.layer(ch, 0, None)),
                       "register_a": register_a,
                       "kept_code_pass": lambda: k.quantize(ch, 0),
                       "kept_gemm": lambda: k.layer(ch, 0, None)}
                order = list(run)
                times = {name: [] for name in order}
                for sweep in (order, order[::-1]):
                    for name in sweep:
                        times[name].append(cs.cuda_time_ms(run[name], 20))
                ms = {n: sum(t) / len(t) for n, t in times.items()}
                ops = 2.0 * rows * cs.H * cs.H
                entry.update(ms=ms, readings=times,
                             tops={n: ops / ms[n] / 1e9 for n in ("register_a", "kept_gemm")})
            out["chunks"][which] = entry
            cs.log("k2_register_a", chunk=which, **entry, card=card)
            if differ:
                raise AssertionError(f"K2's register-A layer 1: {differ} codes differ")
    return out


def time_header_users(tree: str) -> None:
    """One turn of ``--header-against``: K1, K2 (static) and K8a built and
    timed from the package in ``tree``, with this checkout's
    ``chip_smoke.py`` helpers; prints one JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import protnote_tpu_torch
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.ops import text_attention as k8a
    from protnote_tpu_torch.ops.kernels import load_kernel_library, nvcc_path

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    names = ("pair_scorer", "pair_scorer_int8", "text_attention")
    with ThreadPoolExecutor(3) as pool:
        libs = dict(zip(names, pool.map(load_kernel_library, names)))
    out = {"tree": tree, "sass": {}}
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    for name, lib in libs.items():
        # each library's instructions (offset, instruction, encoding) in
        # order, without the kernels' names, which carry a hash of the
        # translation unit for symbols of an anonymous namespace
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", str(lib.path)], capture_output=True,
                                  text=True, check=True).stdout
            lines = [x.strip() for x in sass.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", x)]
            path = os.path.join(os.path.dirname(str(lib.path)), f"{name}.sass")
            with open(path, "w") as f:
                f.write("\n".join(lines))
            out["sass"][name] = path
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    folded = cs.random_folded(gen, cs.D_LATENT, cs.H, 2, dev)
    P_e = torch.randn(cs.B, cs.D_LATENT, generator=gen).to(dev, torch.bfloat16)
    L_e = torch.randn(cs.NUM_LABELS * cs.K_DESCRIPTIONS, cs.D_LATENT,
                      generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        out["k1_ms"] = cs.cuda_time_ms(
            lambda: ps.pair_logits_tiled_cuda(folded, P_e, L_e, cs.LABEL_TILE), 5)
        q = ps.quantize_folded(folded, act_scales=ps.calibrate_act_scales(
            folded, P_e, L_e, cs.LABEL_TILE))
        out["k2_static_ms"] = cs.cuda_time_ms(
            lambda: ps.pair_logits_tiled_int8_cuda(q, P_e, L_e, cs.LABEL_TILE), 5)
        del q, folded, P_e, L_e
        torch.cuda.empty_cache()
        for shape, Bq, T, lo, hi, causal in cs.K8_SHAPES:
            _, mask = cs.token_batch(gen, Bq, T, lo, hi, 100, 1)
            qkv = [torch.randn(Bq, 16, T, 64, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3)]
            out[f"k8a_{shape}_ms"] = cs.cuda_time_ms(
                lambda: k8a.masked_attention_cuda(*qkv, mask, causal), 100)
    print(json.dumps(out), flush=True)


def train_turn(tree: str) -> None:
    """One turn of ``--train-against``: ``chip_smoke.py``'s training phase
    (one epoch at full width, 32 sequences a step) alone in a fresh process,
    on the package in ``tree``; prints its lines, then one JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import protnote_tpu_torch
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    names = ("pair_scorer", "eval_accumulator", "pair_train", "bn_relu")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_kernel_library, names))
    cs.phase_training(cs.card_line())


def dense_train_turn(tree: str, setting: str = "dense_dropout") -> None:
    """One turn of ``--dense-train-against``: ``chip_smoke.py``'s dense
    training phase for one setting of its ``DENSE_SETTINGS`` alone (8 steps)
    in a fresh process, on the package in ``tree``; prints its lines."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import protnote_tpu_torch
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    names = ("pair_scorer", "eval_accumulator", "bn_relu", "pair_dense", "masked_conv",
             "masked_pool", "streamed_bn", "pair_train", "pair_train_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_kernel_library, names))
    cs.DENSE_SETTINGS = tuple(s for s in cs.DENSE_SETTINGS if s[0] == setting)
    if not cs.DENSE_SETTINGS:
        raise ValueError(f"no dense training setting {setting}")
    cs.DENSE_STEPS = 8
    cs.phase_dense_training(cs.card_line())


def dense_serve_turn(tree: str) -> None:
    """One turn of ``--dense-serve-against``: ``chip_smoke.py``'s dense
    serving phase for its ``prod`` form alone (parity, then three full
    batches) in a fresh process, on the package in ``tree``."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import protnote_tpu_torch
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    names = ("pair_scorer", "pair_train", "masked_conv", "masked_pool")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_kernel_library, names))
    cs.DENSE_SERVING = tuple(f for f in cs.DENSE_SERVING if f[0] == "prod")
    cs.phase_dense_serving(cs.card_line())


def encoder_train_turn(tree: str) -> None:
    """One turn of ``--encoder-train-against``: ``chip_smoke.py``'s
    encoder-training phase alone in a fresh process, on the package in
    ``tree``; prints its lines, then one JSON line (phase ``encoder_turn``)."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import protnote_tpu_torch
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    names = ("pair_scorer", "eval_accumulator", "pair_train", "pair_train_bwd", "bn_relu",
             "masked_conv", "masked_conv_bwd", "masked_bn")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_kernel_library, names))
    _, summary = cs.phase_encoder_training(cs.card_line())
    copies = summary.pop("copies_per_step")
    cs.log("encoder_turn", **summary, copies_all=copies["all"],
           copies_activations=copies["activations"])


def eval_turn(tree: str) -> None:
    """One turn of ``--eval-against``: ``Trainer.evaluate`` on
    ``chip_smoke.py``'s 256-sequence FASTA (bf16, ``ESTIMATE_MAP``: K1 and
    K3) in a fresh process on the package in ``tree``, once to warm up and
    then timed; prints one JSON line."""
    import tempfile

    import torch

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import protnote_tpu_torch
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    if not protnote_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {protnote_tpu_torch.__file__}, not the package in {tree}")
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.eval_dataset(tmp)
    pi_cfg, pn_cfg, ts = cs.random_models()
    trainer = Trainer(ts, pi_cfg, pn_cfg, TrainerConfig(decision_threshold=cs.THRESHOLD,
                                                        estimate_map=True), device="cuda")
    trainer.evaluate(cs.eval_batcher(ds))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = trainer.evaluate(cs.eval_batcher(ds))["metrics"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    cs.log("eval_turn", seconds=sec, seqs_per_s=len(ds) / sec, map_micro=m["map_micro"])


def turns(parent: str, flag: str, card: str, *extra: str) -> list:
    """``chip_variants.py FLAG TREE [EXTRA]`` in DIR, this checkout, this,
    DIR, one process a turn; the JSON lines each printed, by phase (the last
    line under "turn")."""
    import chip_smoke as cs

    out = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, tree, *extra],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"the turn in {tree} failed:\n{proc.stdout}{proc.stderr}")
        lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        out.append({**{x.get("phase", "turn"): x for x in lines}, "tree": tree})
        cs.log("turn", flag=flag, tree=tree, lines=lines, card=card)
    return out


def mean_over_turns(results: list, parent: str, keys) -> dict:
    """Each key's mean over DIR's turns and over this checkout's, and the
    change's mean over DIR's less 1."""
    mean = {side: {k: sum(r[k] for r in results if (r["tree"] == parent) == (side == "parent"))
                   / 2 for k in keys} for side in ("parent", "change")}
    return {"mean": mean,
            "change_over_parent": {k: mean["change"][k] / mean["parent"][k] - 1 for k in keys}}


def header_against(parent: str, card: str) -> None:
    """``--header-against``: K1, K2 and K8a timed in turns, and each
    library's instructions compared between DIR and this checkout."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = [r["turn"] for r in turns(parent, "--time-header-users", card)]
    sass = {}
    for name, path in results[0]["sass"].items():
        with open(path) as a, open(results[1]["sass"][name]) as b:
            pa, pb = a.read().splitlines(), b.read().splitlines()
        first = next((i for i, (x, y) in enumerate(zip(pa, pb)) if x != y), None)
        sass[name] = {"instructions": [len(pa), len(pb)], "identical": pa == pb,
                      "first_difference": None if first is None else [pa[first], pb[first]]}
    cs.log("header_users", parent=parent, sass=sass, card=card,
           **mean_over_turns(results, parent, [k for k in results[0] if k.endswith("_ms")]))


def train_against(parent: str, card: str) -> None:
    """``--train-against``: the training phase alone in DIR and in this
    checkout, in turns: step ms, seqs/s, peak memory, idle share."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = []
    for r in turns(parent, "--train-turn", card):
        train, prof = r["train"], r["train_profile"]
        results.append({"tree": r["tree"], "median_warm_step_ms": train["median_warm_step_ms"],
                        "seqs_per_s": train["seqs_per_s"], "peak_mem_gb": train["peak_mem_gb"],
                        "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
                        "idle_share": prof["idle_share"]})
    cs.log("train_against", parent=parent, turns=results, card=card,
           **mean_over_turns(results, parent, [k for k in results[0] if k != "tree"]))


def dense_train_against(parent: str, card: str, setting: str = "dense_dropout") -> None:
    """``--dense-train-against DIR [SETTING]``: one dense training setting
    (``dense_dropout`` unless named: ``prod``, ``no_bn``, ``remat``) alone
    in DIR and in this checkout, in turns."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = []
    for r in turns(parent, "--dense-train-turn", card, setting):
        t = r[f"dense_train_{setting}"]
        results.append({"tree": r["tree"], "median_warm_step_ms": t["median_warm_step_ms"],
                        "seqs_per_s": t["seqs_per_s"], "peak_mem_gb": t["peak_mem_gb"],
                        "profiled_wall_ms_per_step": t["profiled_wall_ms_per_step"],
                        "idle_share": t["idle_share"]})
    cs.log("dense_train_against", parent=parent, setting=setting, turns=results, card=card,
           **mean_over_turns(results, parent, [k for k in results[0] if k != "tree"]))


def dense_serve_against(parent: str, card: str) -> None:
    """``--dense-serve-against DIR``: the prod serving batch (K1's prod form,
    32 sequences against 64,204 label rows) alone in DIR and in this
    checkout, in turns."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = []
    for r in turns(parent, "--dense-serve-turn", card):
        t = r["dense_serving_prod"]
        results.append({"tree": r["tree"], "batch_ms": t["batch_ms"],
                        "seqs_per_s": t["seqs_per_s"]})
    cs.log("dense_serve_against", parent=parent, turns=results, card=card,
           **mean_over_turns(results, parent, ["batch_ms", "seqs_per_s"]))


def encoder_train_against(parent: str, card: str) -> None:
    """``--encoder-train-against``: the encoder-training phase alone in DIR
    and in this checkout, in turns."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = [{"tree": r["tree"], **{k: v for k, v in r["encoder_turn"].items()
                                      if k not in ("phase", "card")}}
               for r in turns(parent, "--encoder-train-turn", card)]
    cs.log("encoder_train_against", parent=parent, turns=results, card=card,
           **mean_over_turns(results, parent, [k for k in results[0] if k != "tree"]))


def eval_against(parent: str, card: str) -> None:
    """``--eval-against``: the evaluation alone in DIR and in this checkout,
    in turns: seqs/s."""
    import chip_smoke as cs

    parent = os.path.abspath(parent)
    results = [{"tree": r["tree"], "seqs_per_s": r["eval_turn"]["seqs_per_s"]}
               for r in turns(parent, "--eval-turn", card)]
    cs.log("eval_against", parent=parent, turns=results, card=card,
           **mean_over_turns(results, parent, ["seqs_per_s"]))


def host_time_us(fn, reps: int = 20) -> float:
    """The host's time a call of ``fn`` (microseconds), the card's queue
    drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def k7_shapes(card: str) -> None:
    """``--k7``: each K7 conv shape alone, the kept kernels' entry points."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.ops import masked_conv as k7

    dev, bf16, B, T = torch.device("cuda"), torch.bfloat16, cs.B, 512
    lens = cs.k7_lengths(np.random.default_rng(3), T)
    lengths = torch.from_numpy(lens).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf16)

    for name, cin, cout, taps, d in (("conv1", 20, 1100, 9, 1), ("dilated_1", 1100, 550, 9, 1),
                                     ("dilated_9", 1100, 550, 9, 9),
                                     ("dilated_81", 1100, 550, 9, 81), ("1x1", 550, 1100, 1, 1)):
        x, w, b, res, dy = (k7.pad_pitch(rnd(B, T, cin)), rnd(taps, cin, cout, scale=0.05),
                            rnd(cout), k7.pad_pitch(rnd(B, T, cout)), k7.pad_pitch(rnd(B, T, cout)))
        fwd, bwd = k7.conv_weight_layout(w, dx=False), k7.conv_weight_layout(w, dx=True)
        bn = (torch.rand(cin, device=dev) + 0.5, 0.1 * torch.randn(cin, device=dev))
        x_t, w_t = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        dy_t, pad = dy.transpose(1, 2).contiguous(), d * (taps - 1) // 2
        ms = {
            "fwd": cs.cuda_time_ms(lambda: k7.masked_conv_cuda(x, w, b, lengths, d,
                                                               layout=fwd), 20),
            "fwd_bn": cs.cuda_time_ms(lambda: k7.masked_conv_cuda(x, w, b, lengths, d, bn,
                                                                  layout=fwd), 20),
            "fwd_residual": cs.cuda_time_ms(
                lambda: k7.masked_conv_cuda(x, w, b, lengths, d, None, res, layout=fwd), 20),
            "dx": cs.cuda_time_ms(lambda: k7.masked_conv_dx_cuda(dy, w, lengths, d,
                                                                 layout=bwd), 20),
            "dw": cs.cuda_time_ms(lambda: k7.masked_conv_dw_cuda(x, dy, lengths, taps, d), 20),
            "cudnn_conv1d": cs.cuda_time_ms(lambda: F.conv1d(x_t, w_t, padding=pad,
                                                             dilation=d), 20),
            "cudnn_backward_data": cs.cuda_time_ms(lambda: torch.nn.grad.conv1d_input(
                x_t.shape, w_t, dy_t, padding=pad, dilation=d), 20),
            "cudnn_backward_filter": cs.cuda_time_ms(lambda: torch.nn.grad.conv1d_weight(
                x_t, w_t.shape, dy_t, padding=pad, dilation=d), 20)}
        # the wrappers' host time a call (no synchronisation between calls):
        # with the cached layout as evaluation runs it, and re-laying W (and
        # copying a contiguous dy to the pitch) at every call as training does
        dy_flat = dy.contiguous()
        host_us = {k: host_time_us(f) for k, f in (
            ("fwd_bn", lambda: k7.masked_conv_cuda(x, w, b, lengths, d, bn, layout=fwd)),
            ("fwd_relaid", lambda: k7.masked_conv_cuda(x, w, b, lengths, d)),
            ("dx_relaid_dy_copied", lambda: k7.masked_conv_dx_cuda(dy_flat, w, lengths, d)))}
        flop = 2.0 * cin * cout * cs.conv_rows(lens, T, taps, d)
        plan = k7._dw_plan_on(lengths, T, taps, d, cin, cout, dev)
        cs.log("k7_shape", shape=name, cin=cin, cout=cout, taps=taps, dilation=d, ms=ms,
               fwd_tflops=flop / ms["fwd"] / 1e9, fwd_bn_tflops=flop / ms["fwd_bn"] / 1e9,
               dx_tflops=flop / ms["dx"] / 1e9, dw_tflops=flop / ms["dw"] / 1e9,
               dw_splits=plan.splits, dw_items=plan.items,
               dw_partial_bytes=4 * plan.splits * taps * cin * cout if plan.splits > 1 else 0,
               host_us=host_us, card=card)
    cs.log("k7_ptxas", forward=cs.k7_ptxas("masked_conv"),
           backward=cs.k7_ptxas("masked_conv_bwd"), card=card)


# text replaced in text_attention_bwd.cu (the one-pass kernel): (old, new),
# each old found exactly once
K8A_BWD_SUBS = {
    "no_loads": [(
        "    mbar_expect_tx(bar, 4 * OP_TILE);\n"
        "    tma_load_3d(base + OP_Q, &tm_q, 0, 0, bh, bar);\n"
        "    tma_load_3d(base + OP_K, &tm_k, 0, 0, bh, bar);\n"
        "    tma_load_3d(base + OP_V, &tm_v, 0, 0, bh, bar);\n"
        "    tma_load_3d(base + OP_G, &tm_g, 0, 0, bh, bar);\n",
        "    mbar_expect_tx(bar, 0);\n")],
    "no_stores": [(
        "    tma_store_3d(&tm_dq, out_q, 0, wg * 64, bh);\n"
        "    tma_store_3d(&tm_dv, out_v, 0, wg * 64, bh);\n"
        "    tma_store_3d(&tm_dk, out_k, 0, wg * 64, bh);\n",
        "    (void)out_k;\n")],
    "no_exp_div": [(
        "    s[i] = expf(__fsub_rn(s[i], m[(i >> 1) & 1]));  // y\n",
        "    s[i] = __fsub_rn(s[i], m[(i >> 1) & 1]);  // y\n"), (
        "                pack_bf16x2(div_rn(s[i], z[h], rz[h]), div_rn(s[i + 1], z[h], rz[h])));\n",
        "                pack_bf16x2(__fmul_rn(s[i], rz[h]), __fmul_rn(s[i + 1], rz[h])));\n"), (
        "__fadd_rn(div_rn(dp[i + e], z[h], rz[h]), -D[h])",
        "__fadd_rn(__fmul_rn(dp[i + e], rz[h]), -D[h])")],
}


def k8a_bwd_turns(build_dir: str, card: str) -> None:
    """``--k8a-bwd``: the one-pass kernel, the two-kernel form, SDPA's
    backward and the one-pass kernel with parts taken out, in turns at (a)
    and (c)."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import text_attention as k8a

    lib = kernels.load_kernel_library("text_attention_bwd")
    ptxas = [x.strip() for x in lib.build_log.splitlines() if "registers" in x or "spill" in x]
    base = (kernels.CSRC_DIR / "text_attention_bwd.cu").read_text()
    jobs = {}
    for name, subs in K8A_BWD_SUBS.items():
        text = base
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"K8a-bwd variant {name}: {text.count(old)} matches")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"text_attention_bwd_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(build_dir, f"libtext_attention_bwd_{name}.so"))
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: nvcc(*j), jobs.values()))
    variants = {}
    for name, (_, out) in jobs.items():
        fn = ctypes.CDLL(out).masked_attention_backward
        fn.argtypes = k8a._BWD_ARGS
        fn.restype = ctypes.c_int
        variants[name] = fn
    nh, hd, rounds = 16, 64, 7
    gen = torch.Generator().manual_seed(40)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    for shape, Bq, T, lo, hi, causal in cs.K8_SHAPES:
        if T > k8a.ONE_PASS_T:
            continue
        _, mask = cs.token_batch(gen, Bq, T, lo, hi, 100, 1)
        q, k, v, g = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev, bf16) for _ in range(4))
        keep = (mask > 0)[:, None, None, :]
        if causal:
            keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        add_mask = torch.where(keep, 0.0, k8a.MASKED).to(bf16)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        ctx = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=add_mask)
        want = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
        outs = [torch.empty_like(q) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream

        def variant(fn):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), mask.data_ptr(),
                         *(o.data_ptr() for o in outs), None, Bq, nh, T, hd, int(causal),
                         k8a.scale_for(hd), stream)
                if err != 0:
                    raise RuntimeError(f"K8a-bwd variant: CUDA error {err}")
                return outs
            return call

        run = {"one_pass": lambda: k8a.masked_attention_backward_cuda(q, k, v, mask, causal, g),
               "two_kernels": lambda: k8a.two_kernel_backward_cuda(q, k, v, mask, causal, g),
               "sdpa_backward": lambda: torch.autograd.grad(ctx, (ql, kl, vl), g,
                                                            retain_graph=True),
               **{f"one_pass_{n}": variant(fn) for n, fn in variants.items()}}
        rel = {}
        for name in ("one_pass", "two_kernels", "sdpa_backward"):
            got = run[name]()
            rel[name] = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                            for a, b in zip(got, want))
        readings = {name: [] for name in run}
        for _ in range(rounds):
            for name, fn in run.items():
                readings[name].append(cs.cuda_time_ms(fn, 20))
        med = {n: statistics.median(r) for n, r in readings.items()}
        cs.log("k8a_bwd_turns", shape=shape, batch=Bq, tokens=T, causal=causal, rel_err=rel,
               median_ms=med, readings=readings,
               one_pass_over_sdpa=med["one_pass"] / med["sdpa_backward"],
               bound_ms=cs.bound(nbytes=7.0 * q.numel() * 2 + 4.0 * mask.numel(),
                                 ops=10.0 * Bq * nh * T * T * hd * (0.5 if causal else 1.0)),
               ptxas=ptxas, card=card)
        del q, k, v, g, ql, kl, vl, ctx, want, add_mask
        torch.cuda.empty_cache()


# text replaced in text_attention_f32.cu: (old, new), each old found exactly
# once (timing only: the results are wrong)
K8AF32_SUBS = {
    # 1xTF32: the hi products alone (the split's cross products and lo pieces gone)
    "no_cross_products": [(
        "    mma_tf32(d, a.l[ks], bh[ks][0], bh[ks][1]);\n"
        "    mma_tf32(d, a.h[ks], bl[ks][0], bl[ks][1]);\n", "    (void)ks;\n")],
    # every product kept, the split's instructions gone (hi = lo = x)
    "no_split_instructions": [(
        "  hi = tf32_rna(x);\n  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));\n",
        "  hi = lo = __float_as_uint(x);\n")],
    # the pieces rounded by cvt.rna.tf32.f32 instead of integer operations
    "cvt_split": [(
        "  hi = tf32_rna(x);\n  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));\n",
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(__fsub_rn(x, __uint_as_float(hi))));\n')],
    # no tile reaches shared memory
    "no_loads": [(
        '  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(dst), "l"(src),\n'
        '               "r"(valid ? 16 : 0));  // 0: fill the 16 bytes with zeros\n',
        "  (void)dst; (void)src; (void)valid;\n")],
    # expf and the divisions (of p and of dS) out: a subtraction, a multiply
    "no_softmax": [(
        "s[kt][j][e] = expf(__fsub_rn(s[kt][j][e], m[e >> 1]));",
        "s[kt][j][e] = __fsub_rn(s[kt][j][e], m[e >> 1]);"), (
        "s[kt][j][e] = div_rn(s[kt][j][e], z[e >> 1], r[e >> 1]);",
        "s[kt][j][e] = __fmul_rn(s[kt][j][e], r[e >> 1]);"), (
        "s[j][e] = div_rn(expf(__fsub_rn(s[j][e], m[e >> 1])), l[e >> 1], r[e >> 1]);",
        "s[j][e] = __fmul_rn(__fsub_rn(s[j][e], m[e >> 1]), r[e >> 1]);"), (
        "y[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));",
        "y[j][e] = __fsub_rn(s[j][e], m[e >> 1]);"), (
        "s[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));  // y\n",
        "s[j][e] = __fsub_rn(s[j][e], m[e >> 1]);  // y\n"), (
        "s[j][e] = expf(__fsub_rn(s[j][e], m[e >> 1]));  // y of the final m\n",
        "s[j][e] = __fsub_rn(s[j][e], m[e >> 1]);\n"), (
        "make_float2(div_rn(s[j][2 * r], z[r], rz[r]), div_rn(s[j][2 * r + 1], z[r], rz[r]));",
        "make_float2(__fmul_rn(s[j][2 * r], rz[r]), __fmul_rn(s[j][2 * r + 1], rz[r]));"), (
        "__fadd_rn(div_rn(dp[j][2 * r], z[r], rz[r]), -D[r])",
        "__fadd_rn(__fmul_rn(dp[j][2 * r], rz[r]), -D[r])"), (
        "__fadd_rn(div_rn(dp[j][2 * r + 1], z[r], rz[r]), -D[r])",
        "__fadd_rn(__fmul_rn(dp[j][2 * r + 1], rz[r]), -D[r])"), (
        "__fadd_rn(div_rn(dp[j][e], z[e >> 1], rz[e >> 1]),",
        "__fadd_rn(__fmul_rn(dp[j][e], rz[e >> 1]),")],
}


def k8a_f32_turns(build_dir: str, card: str) -> None:
    """``--k8a-f32``: K8a f32 and K8a-bwd f32 against their first design in
    turns (kept, first, first, kept) at the three K8 shapes, with the kept
    source's parts taken out, float32 SDPA and its backward beside."""
    import statistics

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import text_attention as k8a

    base = (kernels.CSRC_DIR / "text_attention_f32.cu").read_text()
    libs = build_subs(build_dir, "text_attention_f32", base, K8AF32_SUBS,
                      {"first": os.path.join(VARIANT_DIR, "text_attention_f32_v1.cu")})
    fns = {}
    for name, lib in libs.items():
        fwd_fn, bwd_fn = lib.masked_attention_f32, lib.masked_attention_backward_f32
        fwd_fn.argtypes, fwd_fn.restype = k8a._FWD_ARGS, ctypes.c_int
        bwd_fn.argtypes, bwd_fn.restype = k8a._BWD_ARGS, ctypes.c_int
        fns[name] = (fwd_fn, bwd_fn)
    nh, hd, rounds = 16, 64, 5
    gen = torch.Generator().manual_seed(50)
    dev = torch.device("cuda")
    gemm_precision(torch.float32)
    scale = k8a.scale_for(hd)

    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    for shape, Bq, T, lo, hi, causal in cs.K8_SHAPES:
        _, mask = cs.token_batch(gen, Bq, T, lo, hi, 100, 1)
        q, k, v, g = (torch.randn(Bq, nh, T, hd, generator=gen).to(dev) for _ in range(4))
        ctx = torch.empty_like(q)
        grads = [torch.empty_like(q) for _ in range(3)]
        stats = torch.empty(3, Bq * nh * T, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def forward(fn):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                         ctx.data_ptr(), Bq, nh, T, hd, int(causal), scale, stream)
                if err != 0:
                    raise RuntimeError(f"masked_attention_f32 variant: CUDA error {err}")
                return ctx
            return call

        def backward(fn):
            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                         mask.data_ptr(), *(x.data_ptr() for x in grads), stats.data_ptr(),
                         Bq, nh, T, hd, int(causal), scale, stream)
                if err != 0:
                    raise RuntimeError(f"masked_attention_backward_f32 variant: CUDA error {err}")
                return grads
            return call

        want = k8a.masked_attention_reference(q, k, v, mask, causal)
        want_g = k8a.masked_attention_backward_reference(q, k, v, mask, causal, g)
        errs = {}
        for name, (fwd_fn, bwd_fn) in fns.items():
            errs[name] = {"ctx": rel(forward(fwd_fn)(), want),
                          **{n: rel(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                             backward(bwd_fn)(), want_g)}}
        keep = (mask > 0)[:, None, None, :]
        if causal:
            keep = keep & torch.ones(T, T, dtype=torch.bool, device=dev).tril()
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=keep)
        turns = {"forward": {"kept": [], "first": []}, "backward": {"kept": [], "first": []}}
        for _ in range(rounds):
            for name in ("kept", "first", "first", "kept"):
                turns["forward"][name].append(cs.cuda_time_ms(forward(fns[name][0]), 10))
                turns["backward"][name].append(cs.cuda_time_ms(backward(fns[name][1]), 5))
        parts = {"forward": {}, "backward": {}}
        names = ["kept"] + list(K8AF32_SUBS)
        for order in (names, names[::-1]):
            for name in order:
                parts["forward"].setdefault(name, []).append(
                    cs.cuda_time_ms(forward(fns[name][0]), 10))
                parts["backward"].setdefault(name, []).append(
                    cs.cuda_time_ms(backward(fns[name][1]), 5))
        library = {"forward": cs.cuda_time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=keep), 10),
                   "backward": cs.cuda_time_ms(lambda: torch.autograd.grad(
                       out, (ql, kl, vl), g, retain_graph=True), 5)}
        plain = {"forward": cs.cuda_time_ms(lambda: k8a.masked_attention_reference(
                     q, k, v, mask, causal), 3),
                 "backward": cs.cuda_time_ms(lambda: k8a.masked_attention_backward_reference(
                     q, k, v, mask, causal, g), 2)}
        frac = 0.5 if causal else 1.0  # the products a causal row needs
        ops = {"forward": 4.0 * Bq * nh * T * T * hd * frac,
               "backward": 10.0 * Bq * nh * T * T * hd * frac}
        nbytes = {"forward": 4.0 * q.numel() * 4 + 4.0 * mask.numel(),
                  "backward": 7.0 * q.numel() * 4 + 4.0 * mask.numel()}
        for direction in ("forward", "backward"):
            med = {n: statistics.median(r) for n, r in turns[direction].items()}
            cs.log("k8a_f32_turns", shape=shape, direction=direction, batch=Bq, tokens=T,
                   causal=causal, median_ms=med, readings=turns[direction],
                   kept_over_first=med["kept"] / med["first"],
                   parts_ms={n: statistics.mean(r) for n, r in parts[direction].items()},
                   library_ms=library[direction], plain_ms=plain[direction],
                   kept_over_library=med["kept"] / library[direction],
                   split_bound=cs.bound(nbytes=nbytes[direction], ops=ops[direction],
                                        peak=cs.TF32X3_FLOPS),
                   fma_bound=cs.bound(nbytes=nbytes[direction], ops=ops[direction],
                                      peak=cs.F32_FLOPS),
                   rel_err={n: {k_: v_ for k_, v_ in e.items()
                                if (k_ == "ctx") == (direction == "forward")}
                            for n, e in errs.items()}, card=card)
        del q, k, v, g, ql, kl, vl, out, ctx, grads, stats, want, want_g, keep
        torch.cuda.empty_cache()


# text replaced in masked_conv_f32.cu: (old, new), each old found exactly once
K7F32_SUBS = {
    # one product a k-step (x0 w0, from zero): the split's five cross
    # products gone (their pieces are still formed: split_products keeps
    # every fragment register live)
    "no_cross_products": [(
        "  for (int kk = 0; kk < 4; ++kk) {\n"
        "    const uint64_t o = kstep * kk;\n"
        "    MMA::rs(acc, fa[0][kk], d[1] + o, kk > 0);\n"
        "    MMA::rs(acc, fa[1][kk], d[0] + o, 1);\n"
        "    MMA::rs(acc, fa[0][kk], d[2] + o, 1);\n"
        "    MMA::rs(acc, fa[1][kk], d[1] + o, 1);\n"
        "    MMA::rs(acc, fa[2][kk], d[0] + o, 1);\n"
        "  }\n"
        "#pragma unroll\n"
        "  for (int kk = 0; kk < 4; ++kk) MMA::rs(acc, fa[0][kk], d[0] + kstep * kk, 1);\n",
        "  for (int kk = 0; kk < 4; ++kk) MMA::rs(acc, fa[0][kk], d[0] + kstep * kk, kk > 0);\n")],
    # each stage's sums moved, not added into the float32 sums
    "no_stage_adds": [
        ("(int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);",
         "(int i = 0; i < BN / 2; ++i) sum[i] = acc[i];"),
        ("(int i = 0; i < DW_BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);",
         "(int i = 0; i < DW_BN / 2; ++i) sum[i] = acc[i];")],
    # every product kept, the split's instructions gone (one xor a pair)
    "no_split": [
        ("split3(x, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);",
         "fa[0][kk][e] = fa[1][kk][e] = fa[2][kk][e] = __float_as_uint(x.x) ^ "
         "__float_as_uint(x.y);"),
        ("split3(xt, fa[0][kk][e], fa[1][kk][e], fa[2][kk][e]);",
         "fa[0][kk][e] = fa[1][kk][e] = fa[2][kk][e] = __float_as_uint(xt.x) ^ "
         "__float_as_uint(xt.y);")],
    # the loads alone: no products, so A is neither read nor split
    "loads_only": [
        ("        split_products<Mma<BN>>(acc, fa, d, 2);\n", "        (void)d;\n"),
        ("        split_products<MmaRsT<DW_BN>>(acc, fa, d, 128);  "
         "// a k-step: 16 rows of 128 bytes\n", "        (void)d;\n")],
    # the forward without the BN prologue's arithmetic
    "no_prologue": [(
        "              if (PRO)\n"
        "                x = make_float2(fmaxf(__fadd_rn(__fmul_rn(x.x, iv.x), sh.x), 0.f),\n"
        "                                fmaxf(__fadd_rn(__fmul_rn(x.y, iv.y), sh.y), 0.f));\n",
        "              (void)iv; (void)sh;\n")],
    # dW without its pass splitting dy (the pieces left from the last call)
    "no_split_pass": [(
        "  split_rows_kernel<<<static_cast<unsigned>(split_blocks), 256, 0, s>>>(\n"
        "      dy_, dy_pitch, static_cast<__nv_bfloat16*>(pieces), ppitch, rows, cout);\n",
        "  (void)split_blocks;\n")],
}
K7F32_ROUNDS = 6  # turns (kept, first, cuDNN, cuDNN, first, kept) a shape


def first_f32_layout(w, dx: bool):
    """The first design's float32 B operand (csrc/variants/masked_conv_f32_v1
    .cu): (taps, K up to 16, N up to 128), N contiguous; W[j] for the
    forward, W[taps - 1 - j]^T for dX."""
    import torch.nn.functional as F

    w = w.flip(0).transpose(1, 2) if dx else w
    _, k, n = w.shape
    return F.pad(w, (0, -(-n // 128) * 128 - n, 0, -(-k // 16) * 16 - k)).contiguous()


def k7_f32_turns(build_dir: str, card: str) -> None:
    """``--k7-f32``: K7's float32 forward, dX and dW against their first
    design and cuDNN float32 in turns at the chain's three shapes, then the
    kept source with parts taken out."""
    import statistics

    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from protnote_tpu_torch.models.layers import gemm_precision
    from protnote_tpu_torch.models.proteinfer import one_hot_sequences
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import masked_conv as k7

    base = (kernels.CSRC_DIR / "masked_conv_f32.cu").read_text()
    libs = build_subs(build_dir, "masked_conv_f32", base, K7F32_SUBS,
                      {"first": os.path.join(VARIANT_DIR, "masked_conv_f32_v1.cu"),
                       "dw_smem": os.path.join(VARIANT_DIR, "masked_conv_f32_dw_smem.cu")})
    P, I = ctypes.c_void_p, ctypes.c_int
    first_args = {"masked_conv_forward_f32": [P] * 9 + [I] * 13 + [P],
                  "masked_conv_dx_f32": [P] * 5 + [I] * 12 + [P],
                  "masked_conv_dw_f32": [P] * 8 + [I] * 10 + [P]}
    fns = {}
    for name, lib in libs.items():
        fns[name] = {}
        for sym, args in first_args.items():
            fn = getattr(lib, sym)
            fn.argtypes = args if name == "first" else k7._ARGS[("masked_conv_f32", sym)]
            fn.restype = ctypes.c_int
            fns[name][sym] = fn
    smem_dw = libs["dw_smem"].masked_conv_dw_f32_smem
    smem_dw.argtypes = k7._ARGS[("masked_conv_f32", "masked_conv_dw_f32")]
    smem_dw.restype = ctypes.c_int
    dev, f32, T, B = torch.device("cuda"), torch.float32, 512, cs.B
    gemm_precision(f32)
    rng = np.random.default_rng(29)
    lens = cs.k7_lengths(rng, T)
    lengths = torch.from_numpy(lens).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(29)
    stream = torch.cuda.current_stream().cuda_stream

    def bind(fn, *args):
        def run():
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError(f"a K7 f32 entry point returned CUDA error {err}")
        return run

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def rel(got, want) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def fill(n: int) -> int:  # the first design's blocks for the rows its plan skips
        return min(132, -(-k7.skipped_rows(lens, T, 128) * -(-n // 4) // 256))

    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    shapes = [("stem", 9, 20, 1100, 1, False)] + [
        (f"dilated_{d}", 9, 1100, 550, d, True) for d in (1, 3, 9, 27, 81)] + [
        ("1x1", 1, 550, 1100, 1, True)]
    medians = {}
    for shape, taps, cin, cout, d, pro in shapes:
        if shape == "stem":
            ids = torch.from_numpy(rng.integers(0, 21, (B, T))).to(dev)
            x = k7.pad_pitch(one_hot_sequences(ids, cin, f32))
        else:
            x = k7.pad_pitch(torch.relu(torch.randn(B, T, cin, generator=gen, device=dev)))
        w = torch.randn(taps, cin, cout, generator=gen, device=dev) / float(np.sqrt(cin * taps))
        bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
        inv, shift = ((0.5 + torch.rand(cin, generator=gen, device=dev),
                       0.5 * torch.randn(cin, generator=gen, device=dev)) if pro else (None, None))
        res = (k7.pad_pitch(torch.randn(B, T, cout, generator=gen, device=dev)) if taps == 1
               else None)
        dy = k7.pad_pitch(torch.randn(B, T, cout, generator=gen, device=dev))
        xp, rp = x.stride(1), 0 if res is None else res.stride(1)
        y, y1 = (k7.padded_empty(B, T, cout, f32, dev) for _ in range(2))
        dx, dx1 = (k7.padded_empty(B, T, cin, f32, dev) for _ in range(2))
        # the kept design: pieces, 128 x 112 plans, persistent blocks
        pf, pd = k7.conv_weight_layout_f32(w), k7.conv_weight_layout_f32(w, dx=True)
        plan_f = on_dev(k7.conv_tile_plan(lens, T, taps, d, cout, False, 128, 112))
        plan_d = on_dev(k7.conv_tile_plan(lens, T, taps, d, cin, True, 128, 112))
        dwp, splits, items = k7.dw_step_plan(lens, T, taps, d, cin, cout, sms, 128, 128,
                                               k7.F32_DW_STEP)
        dwp = on_dev(dwp)
        pieces = torch.empty(3 * B * T * k7.row_pitch(cout), dtype=torch.bfloat16, device=dev)
        partial = torch.empty(max(splits, 1), taps, cin, cout, device=dev)
        bias_part = torch.empty(B, cout, device=dev)
        dw, db = torch.empty(taps, cin, cout, device=dev), torch.empty(cout, device=dev)
        dw_s, db_s = torch.empty(taps, cin, cout, device=dev), torch.empty(cout, device=dev)
        dw_smem = bind(smem_dw, x.data_ptr(), dy.data_ptr(), pieces.data_ptr(),
                       lengths.data_ptr(), dwp.data_ptr(), partial.data_ptr(),
                       bias_part.data_ptr(), dw_s.data_ptr(), db_s.data_ptr(), B, T, cin, cout,
                       xp, dy.stride(1), taps, d, splits, items, sms)
        # the first design: float32 layouts, 128 x 128 plans, a block a tile
        lf, ld = first_f32_layout(w, False), first_f32_layout(w, True)
        plan_f1 = on_dev(k7.conv_tile_plan(lens, T, taps, d, cout, False, 128, 128))
        plan_d1 = on_dev(k7.conv_tile_plan(lens, T, taps, d, cin, True, 128, 128))
        dwp1, splits1, items1 = k7.dw_step_plan(lens, T, taps, d, cin, cout, 2 * sms, 128, 128,
                                                16)
        dwp1 = on_dev(dwp1)
        partial1 = torch.empty(max(splits1, 1), taps, cin, cout, device=dev)
        dw1, db1 = torch.empty(taps, cin, cout, device=dev), torch.empty(cout, device=dev)

        def kept(name, kind):
            f = fns[name]
            if kind == "fwd":
                return bind(f["masked_conv_forward_f32"], x.data_ptr(), pf.data_ptr(),
                            bias.data_ptr(), ptr(inv), ptr(shift), ptr(res), lengths.data_ptr(),
                            plan_f.data_ptr(), y.data_ptr(), B, T, cin, cout, xp, y.stride(1), rp,
                            pf.shape[3], pf.shape[2], taps, d, len(plan_f), sms)
            if kind == "dx":
                return bind(f["masked_conv_dx_f32"], dy.data_ptr(), pd.data_ptr(),
                            lengths.data_ptr(), plan_d.data_ptr(), dx.data_ptr(), B, T, cin, cout,
                            dy.stride(1), dx.stride(1), pd.shape[3], pd.shape[2], taps, d,
                            len(plan_d), sms)
            return bind(f["masked_conv_dw_f32"], x.data_ptr(), dy.data_ptr(), pieces.data_ptr(),
                        lengths.data_ptr(), dwp.data_ptr(), partial.data_ptr(),
                        bias_part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, T, cin, cout, xp,
                        dy.stride(1), taps, d, splits, items, sms)

        f1 = fns["first"]
        first = {
            "fwd": bind(f1["masked_conv_forward_f32"], x.data_ptr(), lf.data_ptr(),
                        bias.data_ptr(), ptr(inv), ptr(shift), ptr(res), lengths.data_ptr(),
                        plan_f1.data_ptr(), y1.data_ptr(), B, T, cin, cout, xp, y1.stride(1), rp,
                        lf.shape[1], lf.shape[2], taps, d, len(plan_f1), fill(cout)),
            "dx": bind(f1["masked_conv_dx_f32"], dy.data_ptr(), ld.data_ptr(), lengths.data_ptr(),
                       plan_d1.data_ptr(), dx1.data_ptr(), B, T, cin, cout, dy.stride(1),
                       dx1.stride(1), ld.shape[1], ld.shape[2], taps, d, len(plan_d1), fill(cin)),
            "dw": bind(f1["masked_conv_dw_f32"], x.data_ptr(), dy.data_ptr(), lengths.data_ptr(),
                       dwp1.data_ptr(), partial1.data_ptr(), bias_part.data_ptr(),
                       dw1.data_ptr(), db1.data_ptr(), B, T, cin, cout, xp, dy.stride(1), taps, d,
                       splits1, items1)}
        pad = d * (taps - 1) // 2
        x_t, dy_t = (t.contiguous().transpose(1, 2).contiguous() for t in (x, dy))
        w_t = w.permute(2, 1, 0).contiguous()
        cudnn = {"fwd": lambda: F.conv1d(x_t, w_t, padding=pad, dilation=d),
                 "dx": lambda: torch.nn.grad.conv1d_input(x_t.shape, w_t, dy_t, padding=pad,
                                                          dilation=d),
                 "dw": lambda: torch.nn.grad.conv1d_weight(x_t, w_t.shape, dy_t, padding=pad,
                                                           dilation=d)}
        # both designs against the plain float32 version (dW against float64)
        kinds = ("fwd", "dw") if shape == "stem" else ("fwd", "dx", "dw")
        errs = {}
        for kind in kinds:
            kept("kept", kind)()
            first[kind]()
        dw_smem()
        want_y = k7.masked_conv_reference(x, w, bias, lengths, d,
                                          None if inv is None else (inv, shift), res)
        errs["fwd"] = {"kept": rel(y, want_y), "first": rel(y1, want_y)}
        if "dx" in kinds:
            want_dx = k7.masked_conv_backward_reference(x, w, bias, dy, lengths, d)[0]
            errs["dx"] = {"kept": rel(dx, want_dx), "first": rel(dx1, want_dx)}
        truth_w, truth_b = cs.dw_float64(x, dy, lengths, taps, d)
        errs["dw"] = {"kept": max(rel(dw, truth_w), rel(db, truth_b)),
                      "first": max(rel(dw1, truth_w), rel(db1, truth_b)),
                      "dw_smem": max(rel(dw_s, truth_w), rel(db_s, truth_b))}
        torch.cuda.synchronize()
        del want_y, truth_w, truth_b
        flop = 2.0 * cin * cout * cs.conv_rows(lens, T, taps, d)
        for kind in kinds:
            entries = {"kept": kept("kept", kind), "first": first[kind], "cudnn": cudnn[kind]}
            if kind == "dw":
                entries["dw_smem"] = dw_smem
            readings = {n: [] for n in entries}
            for _ in range(K7F32_ROUNDS):
                for name in list(entries) + list(entries)[::-1]:
                    readings[name].append(cs.cuda_time_ms(entries[name], 5))
            med = {n: statistics.median(r) for n, r in readings.items()}
            medians[(shape, kind)] = med
            cs.log("k7_f32_turns", shape=shape, kind=kind, taps=taps, cin=cin, cout=cout,
                   dilation=d, prologue=pro, residual=res is not None, median_ms=med,
                   readings=readings, kept_over_first=med["kept"] / med["first"],
                   kept_over_cudnn=med["kept"] / med["cudnn"],
                   tflops=flop / med["kept"] / 1e9,
                   split_bound=cs.bound(ops=flop, peak=cs.SPLIT_FLOPS),
                   fma_bound=cs.bound(ops=flop, peak=cs.F32_FLOPS), rel_err=errs[kind],
                   dw_splits=(splits, splits1) if kind == "dw" else None, card=card)
            if errs[kind]["kept"] > cs.K7_F32_REL_TOL:
                raise AssertionError(f"K7 f32 {kind} at {shape}: {errs[kind]}")
        if shape in ("dilated_9", "1x1", "stem"):
            names = ["kept"] + list(K7F32_SUBS)
            parts = {kind: {} for kind in kinds}
            for order in (names, names[::-1]):
                for name in order:
                    for kind in kinds:
                        parts[kind].setdefault(name, []).append(
                            cs.cuda_time_ms(kept(name, kind), 5))
            for kind in kinds:
                cs.log("k7_f32_parts", shape=shape, kind=kind,
                       parts_ms={n: statistics.mean(r) for n, r in parts[kind].items()},
                       split_bound_ms=cs.bound(ops=flop, peak=cs.SPLIT_FLOPS)["bound_ms"],
                       card=card)
        del x, dy, y, y1, dx, dx1, pieces, partial, partial1, dw, dw1, dw_s, x_t, dy_t, res
        torch.cuda.empty_cache()
    # a step's calls: the forward's 11 (the stem, 5 dilated, 5 1 x 1), dX's
    # 10 (no stem), dW's 11
    for kind in ("fwd", "dx", "dw"):
        total = {n: 0.0 for n in ("kept", "first", "cudnn") + (("dw_smem",) if kind == "dw"
                                                                 else ())}
        for shape, taps, cin, cout, d, pro in shapes:
            if (shape, kind) not in medians:
                continue
            count = 5 if shape == "1x1" else 1
            for n in total:
                total[n] += count * medians[(shape, kind)][n]
        cs.log("k7_f32_step", kind=kind, median_sum_ms=total,
               kept_over_first=total["kept"] / total["first"],
               kept_over_cudnn=total["kept"] / total["cudnn"], card=card)


# the rounding points of the tower's bf16 chain that --qk-noise raises one
# at a time ("probs" rounds P, "dprobs" its gradient dP)
QK_POINTS = ("weights", "qkv", "lora", "probs", "dprobs", "ctx", "o_proj", "residual", "ln",
             "ffn")


def qk_noise(card: str) -> None:
    """``--qk-noise``: the q and k LoRA leaves' L2 distance to the float32
    chain with each bf16 rounding point of the tower raised alone."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.models import text_transformer as tt
    from protnote_tpu_torch.ops import text_attention as k8a

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    cfg = tt.TextEncoderConfig.e5_large(dtype=bf16)
    text = tt.init_text_encoder(torch.Generator(device="cuda").manual_seed(42), cfg, "cuda")
    lora = tt.init_lora(torch.Generator(device="cuda").manual_seed(43), cfg,
                        rank=cs.TOWER_LORA_RANK, last_n_layers=cs.TOWER_TRAIN_LAYERS,
                        device="cuda")
    gen = torch.Generator().manual_seed(41)
    for entry in lora.values():  # B non-zero, as chip_smoke.py's tower runs
        for t in entry.values():
            t["B"] = 1e-3 * torch.randn(t["B"].shape, generator=gen).to(dev)
    ids, am = cs.tower_token_table(gen, 128, cfg.vocab_size, cfg.pad_token_id)
    ids, am = torch.from_numpy(ids).to(dev), torch.from_numpy(am).to(dev)
    cot = torch.randn(ids.shape[0], cfg.hidden_size, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(3))
    leaves = [(f"/{li}/{t}/{ab}", lora[li][t][ab]) for li in sorted(lora)
              for t in sorted(lora[li]) for ab in ("A", "B")]
    alpha, rank = cs.TOWER_LORA_ALPHA, cs.TOWER_LORA_RANK

    def grads(forward, text_cfg):
        for _, t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                hidden = forward(text, ids, am, text_cfg, lora=lora, lora_alpha=alpha,
                                 lora_rank=rank)
                pooled = tt.pool_hidden_states(hidden, am, "mean")
                out = torch.autograd.grad((pooled.float() * cot).sum(), [t for _, t in leaves])
        finally:
            for _, t in leaves:
                t.requires_grad_(False)
        return {n: g.float() for (n, _), g in zip(leaves, out)}

    class Round(torch.autograd.Function):
        """bf16 rounding of a float32 value (``fwd``) and of its gradient
        (``bwd``), as a bf16 tensor of the chain has both."""

        @staticmethod
        def forward(ctx, t, fwd, bwd):
            ctx.bwd = bwd
            return t.to(bf16).float() if fwd else t.clone()

        @staticmethod
        def backward(ctx, g):
            return (g.to(bf16).float() if ctx.bwd else g), None, None

    def rounded_forward(raised):
        """``text_encoder_forward_reference``'s chain in float32 arithmetic
        with the bf16 chain's roundings, but those of ``raised``."""
        def r(point, t):
            return Round.apply(t, point not in raised, point not in raised)

        def project(lp, name, x, lora_entry, scaling):
            point = "qkv" if name in ("q", "k", "v") else "o_proj" if name == "o" else "ffn"
            if name == "fc2":
                x = r("ffn", x)  # the GELU's output
            w = Round.apply(lp[name]["kernel"], "weights" not in raised, False)
            y = r(point, x @ w)
            if "bias" in lp[name]:
                y = r(point, y + Round.apply(lp[name]["bias"], "weights" not in raised, False))
            if lora_entry is not None and name in lora_entry:
                a, b = (r("lora", lora_entry[name][n]) for n in ("A", "B"))
                d = r("lora", r("lora", x @ a.T) @ b.T)
                y = r(point, y + r("lora", d * scaling))
            return y

        def core(q, k, v, key_mask, causal):
            T, hd = q.shape[2], q.shape[3]
            keep = (key_mask > 0)[:, None, None, :]
            if causal:
                keep = keep & torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
            scores = (q @ k.transpose(-1, -2)) * k8a.scale_for(hd) + torch.where(
                keep, 0.0, k8a.MASKED)
            e = torch.exp(scores - scores.amax(-1, keepdim=True))
            p = Round.apply(e / e.sum(-1, keepdim=True), "probs" not in raised,
                            "dprobs" not in raised)
            return r("ctx", p @ v)

        def norm(x, residual, scale, bias, eps):
            if residual is not None:
                x = r("residual", x + residual)
            mu = x.mean(-1, keepdim=True)
            rs = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)
            return r("ln", (x - mu) * rs * scale + bias)

        def forward(params, input_ids, attention_mask, text_cfg, lora, lora_alpha, lora_rank):
            saved = tt._project
            tt._project = project
            try:
                return tt._forward(params, input_ids, attention_mask,
                                   dataclasses.replace(text_cfg, dtype=f32), lora, lora_alpha,
                                   lora_rank, core, norm)
            finally:
                tt._project = saved
        return forward

    ref = grads(tt.text_encoder_forward_reference, dataclasses.replace(cfg, dtype=f32))

    def l2(got):
        def err(names):
            num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in names)
            return (num / sum(float((ref[n] ** 2).sum()) for n in names)) ** 0.5
        qk = [n for n in ref if n.split("/")[-2] in ("q", "k")]
        other = [n for n in ref if n not in qk]
        return {"q_k": err(qk), "other": err(other),
                "q_k_worst_leaf": max(err([n]) for n in qk)}

    two = k8a.two_kernel_backward_cuda
    chains = {"plain_bf16": grads(tt.text_encoder_forward_reference, cfg),
              "kernels": grads(tt.text_encoder_forward, cfg)}
    saved = k8a.masked_attention_backward_cuda
    k8a.masked_attention_backward_cuda = two
    try:
        chains["kernels_two_kernel_bwd"] = grads(tt.text_encoder_forward, cfg)
    finally:
        k8a.masked_attention_backward_cuda = saved
    out = {name: l2(g) for name, g in chains.items()}
    # what chip_smoke.py's check holds within 5e-2: the worst leaf's L2
    # distance of the kernels' chain to the plain bf16 chain
    plain = chains["plain_bf16"]
    out["kernels_vs_plain_bf16_worst_leaf"] = {
        key: max(float((chains[key][n] - plain[n]).norm() / plain[n].norm()) for n in ref)
        for key in ("kernels", "kernels_two_kernel_bwd")}
    # each point raised alone, and each point the only one left rounded
    rounded = {"none": (), "all": QK_POINTS, **{p: (p,) for p in QK_POINTS},
               **{f"all_but_{p}": tuple(x for x in QK_POINTS if x != p) for p in QK_POINTS}}
    for name, raised in rounded.items():
        out[f"raised_{name}"] = l2(grads(rounded_forward(set(raised)), cfg))
        cs.log("qk_noise_point", raised=name, **out[f"raised_{name}"], card=card)
    cs.log("qk_noise", leaves=len(ref), descriptions=int(ids.shape[0]), tokens=int(ids.shape[1]),
           results=out, card=card)


def main() -> None:
    import tempfile

    if sys.argv[1:2] == ["--time-header-users"]:
        time_header_users(sys.argv[2])
        return
    if sys.argv[1:2] == ["--train-turn"]:
        train_turn(sys.argv[2])
        return
    if sys.argv[1:2] == ["--eval-turn"]:
        eval_turn(sys.argv[2])
        return
    if sys.argv[1:2] == ["--encoder-train-turn"]:
        encoder_train_turn(sys.argv[2])
        return
    if sys.argv[1:2] == ["--dense-serve-turn"]:
        dense_serve_turn(sys.argv[2])
        return
    if sys.argv[1:2] == ["--dense-train-turn"]:
        dense_train_turn(*sys.argv[2:4])
        return
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_variants.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = cs.card_line()
    if sys.argv[1:2] == ["--header-against"]:
        header_against(sys.argv[2], card)
        print(card)
        return
    if sys.argv[1:2] == ["--train-against"]:
        train_against(sys.argv[2], card)
        print(card)
        return
    if sys.argv[1:2] == ["--eval-against"]:
        eval_against(sys.argv[2], card)
        print(card)
        return
    if sys.argv[1:2] == ["--encoder-train-against"]:
        encoder_train_against(sys.argv[2], card)
        print(card)
        return
    if sys.argv[1:2] == ["--dense-serve-against"]:
        dense_serve_against(sys.argv[2], card)
        print(card)
        return
    if sys.argv[1:2] == ["--dense-train-against"]:
        dense_train_against(sys.argv[2], card, *sys.argv[3:4])
        print(card)
        return
    if sys.argv[1:2] == ["--k5-dense"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k5_dense_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--dense-first"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            dense_first_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k7-bn"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k7_bn_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k4-bwd"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k4_bwd_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k7"]:
        k7_shapes(card)
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k7_dw_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k8a-bwd"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k8a_bwd_turns(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k8a-f32"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k8a_f32_turns(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k7-f32"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k7_f32_turns(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--qk-noise"]:
        qk_noise(card)
        print(card)
        return
    if sys.argv[1:2] == ["--k2-codes"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k2_codes_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k7-pool"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k7_pool_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k9-update"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k9_update_variants(build_dir, card)
        print(card)
        return
    if sys.argv[1:2] == ["--k3"]:
        with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
            k3_variants(build_dir, card)
        print(card)
        return
    with tempfile.TemporaryDirectory(dir=ROOT) as build_dir:
        libs = build(build_dir)
        cs.log("ptxas", **{n: log for n, (_, log) in libs.items()})
        k8a_variants(libs, card)
        k2_register_a(libs, card)
    print(card)


if __name__ == "__main__":
    main()
