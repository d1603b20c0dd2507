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

    python3 chip_variants.py --k3

builds K3 (``csrc/eval_accumulator.cu``) with parts of its work taken out
(timing only): the update without its histogram adds, the finalize without
its micro-AP bin sums (their shared-memory turns and atomic flush); times
each beside the kept kernels at full width (32 rows x 32,102 labels x 512
bins, ~1% positives; the finalize on histograms with 0.5% positive counts),
the list run forward and then backward, calling the C entry points alone.

    python3 chip_variants.py --k4-bwd

builds K4-bwd (``csrc/pair_train_bwd.cu``) with parts of its work taken
out (timing only: the results are wrong): dX without its gated epilogue,
dX without the W tile's loads, dW without the formation of its A
fragments (constant fragments instead of ``ldmatrix`` + a2 + ReLU), dW
without the dz tile's loads; and times them beside the kept kernels and
the kept dW with 128-column tiles and with 11 splits of the pair rows, at
the training path's 32-sequence shapes (a2 (32, 3072), c2 (32,102, 3072),
dz (1,027,264 x 3072)), the list run forward and then backward, calling
the C entry points alone.

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

    python3 chip_variants.py --k8a-bwd

times K8a-bwd at ``chip_smoke.py``'s shapes (a) 128 x 128 and (c) causal
128 x 128: the one-pass kernel (the port's at T <= 128), the two-kernel
form on the same tensors (``two_kernel_backward_cuda``), SDPA's backward
with the same additive mask, and the one-pass kernel built with parts of
its work taken out (timing only: without its four TMA loads, without its
three TMA output stores, without expf and the divisions), in turns over 7
rounds (medians; SDPA's time is noisy from run to run), each against the
plain backward, with ptxas's registers and spills.

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


# text replaced in pair_train_bwd.cu: (old, new), each old found exactly once
K4BWD_SUBS = {
    "dx_no_epilogue": [(
        "        // ---- epilogue: gate, round, sum ------------------------------------\n",
        "        if (b >= 0) continue;\n")],
    "dx_no_w_load": [(
        "            mbar_expect_tx(full_bar(s), Lay::STAGE);\n"
        "            tma_load_3d(st, &tm_dz, ns * BK, l0, b, full_bar(s));\n"
        "            tma_load(st + Lay::A_BYTES, &tm_w, ns * BK, k0, full_bar(s));\n",
        "            mbar_expect_tx(full_bar(s), Lay::A_BYTES);\n"
        "            tma_load_3d(st, &tm_dz, ns * BK, l0, b, full_bar(s));\n")],
    "dw_no_a_formation": [(
        "        ldsm_x4_trans(c, box + kk * 16 * 128 + ld_off);\n",
        "        c[0] = c[1] = c[2] = c[3] = 0x3f803f80u + kk;\n")],
    "dw_no_dz_load": [(
        "          mbar_expect_tx(full_bar(s), Lay::STAGE);\n"
        "          tma_load(st, &tm_c, m0, l0, full_bar(s));\n",
        "          mbar_expect_tx(full_bar(s), Lay::X_BYTES);\n"
        "          tma_load(st, &tm_c, m0, l0, full_bar(s));\n"), (
        "            tma_load_3d(st + Lay::X_BYTES + i * BOX, &tm_dz, n0 + 64 * i, l0, b, full_bar(s));\n",
        "            (void)i;\n")],
}


def k4_bwd_variants(build_dir: str, card: str) -> None:
    """K4-bwd's dX and dW, kept and with parts taken out, timed by calling
    each library's C entry points at the training path's shapes."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import chip_smoke as cs
    from protnote_tpu_torch.ops import kernels
    from protnote_tpu_torch.ops import streaming_train as st

    base = (kernels.CSRC_DIR / "pair_train_bwd.cu").read_text()
    jobs = {}
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
    libs = {}
    for name, (_, out) in jobs.items():
        cs.log("k4_bwd_variant_ptxas", variant=name, ptxas=logs[name])
        lib = ctypes.CDLL(out)
        lib.pair_train_dx.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.pair_train_dw.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        libs[name] = lib
    B, L, H = cs.TRAIN_B, cs.NUM_LABELS, cs.H
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    a2 = torch.randn(B, H, device=dev, generator=gen).to(bf16)
    c2 = torch.randn(L, H, device=dev, generator=gen).to(bf16)
    w = (torch.randn(H, H, device=dev, generator=gen) * 0.02).to(bf16)
    dz = (torch.randn(B * L, H, device=dev, generator=gen) * 1e-3).to(bf16)
    da2 = torch.zeros(B, H, device=dev)
    dc2 = torch.empty(L, H, device=dev, dtype=bf16)
    part = torch.empty(11, H, H, device=dev)
    dw = torch.empty(H, H, device=dev, dtype=bf16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    dx_grid = st.pair_dx_plan(B, L, H, H, sms).grid

    def dx(lib):
        return lambda: lib.pair_train_dx(dz.data_ptr(), w.data_ptr(), a2.data_ptr(),
                                         c2.data_ptr(), da2.data_ptr(), dc2.data_ptr(), B, L, H,
                                         H, dx_grid, stream)

    def dw_call(lib, block_n=256, splits=1):
        grid = min(sms, (H // 128) * (H // block_n) * splits)
        return lambda: lib.pair_train_dw(a2.data_ptr(), c2.data_ptr(), dz.data_ptr(),
                                         part.data_ptr(), dw.data_ptr(), B, L, H, H, block_n,
                                         splits, grid, stream)

    calls = [("dx", "kept", dx(libs["kept"])),
             ("dx", "no_epilogue", dx(libs["dx_no_epilogue"])),
             ("dx", "no_w_load", dx(libs["dx_no_w_load"])),
             ("dw", "kept", dw_call(libs["kept"])),
             ("dw", "block_n_128", dw_call(libs["kept"], block_n=128)),
             ("dw", "splits_11", dw_call(libs["kept"], splits=11)),
             ("dw", "no_a_formation", dw_call(libs["dw_no_a_formation"])),
             ("dw", "no_dz_load", dw_call(libs["dw_no_dz_load"]))]
    times = {(k, v): [] for k, v, _ in calls}
    for order in (calls, calls[::-1]):
        for kernel, variant, fn in order:
            times[(kernel, variant)].append(cs.cuda_time_ms(fn, 3))
    ops = 2.0 * B * L * H * H
    for (kernel, variant), t in times.items():
        cs.log("k4_bwd_variant", kernel=kernel, variant=variant, ms=t,
               tflops=[ops / x / 1e9 for x in t], card=card)


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


def nvcc(src: str, out: str) -> str:
    """Build ``src`` into ``out`` with the port's flags; returns ptxas's
    register and spill lines."""
    from protnote_tpu_torch.ops import kernels

    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
                           "-o", out, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    return "\n".join(x.strip() for x in log.splitlines() if "registers" in x or "spill" in x)


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


def turns(parent: str, flag: str, card: str) -> list:
    """``chip_variants.py FLAG TREE`` in DIR, this checkout, this, DIR, one
    process a turn; the JSON lines each printed, by phase (the last line
    under "turn")."""
    import chip_smoke as cs

    out = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, tree],
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
    if sys.argv[1:2] == ["--qk-noise"]:
        qk_noise(card)
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
