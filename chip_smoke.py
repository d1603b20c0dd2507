#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, evaluation and training paths on
one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device: card name, power limit, CUDA and nvcc versions;
2. build: compiles every ``protnote_tpu_torch/csrc/*.cu`` with nvcc, one
   nvcc per source, all at once, and prints each one's ptxas lines;
3. the pair-scorer kernel (K1) against its plain PyTorch version at the full
   serving width (32 sequences x 64,204 label rows, d=1024, H=3072, bf16),
   with both times from CUDA events;
4. serving: a full-width ``ServingEngine`` (ProteInfer 1100 channels x 5
   blocks, 32,102 labels x 2 descriptions) behind the stdlib HTTP server,
   answering /v1/predict and /healthz requests;
5. serving parity: ``engine.score`` against a forward through the plain
   pair scorer on the same device tensors;
6. the eval-accumulator kernels (K3) against their plain version at full
   width (32 rows x 32,102 labels x 512 bins, 8 batches with padded rows,
   a label_mask with zeros and one label-subset batch), with both times;
7. evaluation: a 256-sequence FASTA -> ``ProteinDataset`` -> ``BucketBatcher``
   (device label gather) -> ``PrefetchBatcher`` -> the port's
   ``Trainer.evaluate`` (eval step with K1, then a K3 update per batch, K3
   finalize), then a second pass over the same batches that feeds each
   logits tensor to the kernel and to the plain accumulator;
8. the training kernels: at full width with 8 sequences (the reference's
   per-card batch, where the plain scorer still fits), the decomposed
   scorer through K4 + K5 against its plain version on the same device
   tensors (logits, new BN running statistics, the gradients of P_e, L_e
   and every output-MLP parameter); then K4's forward, K5's forward and
   K5's backward alone at the training path's 32-sequence shapes
   (1,027,264 x 3072 pre-activations) against their plain versions (K5's
   in 512-column slices), with both times;
9. training: a generated FASTA (352 training and 64 validation sequences
   over the 32,102-label vocabulary) -> weighted, shuffled ``BucketBatcher``
   -> ``PrefetchBatcher`` -> the port's ``Trainer.train`` for one epoch at
   full width and 32 sequences a step (train steps through K4 + K5, FocalLoss,
   clipped Adam; validation through K1 + K3; checkpoints), each step's loss
   and time, one ``torch.profiler`` pass for the device idle share and the
   top kernels, peak memory, and a checkpoint written, restored and scored
   to the same logits.

10. the int8 pair scorer (K2) alone at the full serving width (the same
    shapes as phase 3), with static scales from ``calibrate_act_scales``
    and with dynamic per-row scales, against its plain version on the same
    device tensors: max |Δlogit|, the carried layer-1 rows of two label
    chunks compared element by element, the row-scale kernel against its
    plain version, times from CUDA events beside the 39.2 ms int8 bound,
    and ``torch._int_mm`` on the same GEMM shapes as the yardstick;
11. int8 serving: a full-width ``ServingEngine`` with ``PAIR_BACKEND
    tiled_int8`` calibrated from random sequences (``calibrate_from``),
    warmed up, then full batches (batch ms, seqs/s, peak memory), its
    probabilities against a forward through the plain int8 scorer, and the
    drift from the bf16 engine on the same weights (printed, not gated);
12. int8 evaluation: ``Trainer.evaluate`` on the phase-7 FASTA with
    ``tiled_int8``, auto-calibrated (static, K2's layer kernel), then with
    ``INT8_CALIBRATE`` off (dynamic: the row-scale kernel too): seqs/s, the
    scales and mAP beside the bf16 pass (random weights: printed only).

Then one JSON line with every kernel: its launches on its path (K1 and K3
in the training run, whose validation evaluates; K4 and K5 in training; K2
in the int8 serving and evaluation runs; each count set to 0 just before the
path and read just after), its error against the plain version, its time,
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

KERNEL_SOURCES = ("pair_scorer", "eval_accumulator", "pair_train", "bn_relu", "pair_scorer_int8")

# H100 SXM dense peaks for the bounds (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

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
    flop = 2.0 * 2 * H * H * B * L_e.shape[0]
    log("kernel_time", ms=ms, plain_ms=plain_ms, tflops=flop / ms / 1e9,
        plain_tflops=flop / plain_ms / 1e9, card=card)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound(ops=flop),
            "library_ms": None}


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
    """Drive the engine through the HTTP front end; count K1's launches."""
    import threading
    import urllib.request

    import numpy as np
    import torch

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
    batches = health["batches"] - stats0["batches"]
    n_seqs = sum(len(r) for r in requests)
    log("serving", requests=len(requests), sequences=n_seqs, batches=batches,
        k1_launches=launches, request_ms=latencies,
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
    return launches


def plain_probs(engine, seqs):
    """(n, labels) probabilities of ``seqs`` through a forward with the plain
    pair scorer (bf16 or int8, as the engine's backend) on the engine's
    device tensors."""
    import torch

    from protnote_tpu_torch.models.fusion import ensemble_logits, projection_head_apply
    from protnote_tpu_torch.models.proteinfer import embed_from_ids
    from protnote_tpu_torch.ops import pair_scorer as ps

    aa, lengths = engine._assemble(engine._encode(seqs), 512)
    ts, cfg = engine.ts, engine.pn_cfg
    pn, state = ts["trainable"]["protnote"], ts["model_state"]
    with torch.inference_mode():
        P_f = embed_from_ids(ts["enc_params"], ts["enc_state"],
                             torch.from_numpy(aa).cuda(), torch.from_numpy(lengths).cuda(),
                             engine.pi_cfg)
        P_e, _ = projection_head_apply(pn["W_p"], state["W_p"], P_f.to(cfg.compute_dtype))
        folded = ps.fold_output_mlp(pn["output_mlp"], state["output_mlp"], cfg.feature_fusion,
                                    cfg.latent_dim, dtype=cfg.compute_dtype)
        if cfg.pair_backend == "tiled_int8":
            logits = ps.pair_logits_tiled_int8_reference(
                ps.quantize_folded(folded, act_scales=cfg.int8_act_scales), P_e,
                engine.latents, cfg.label_tile, cfg.compute_dtype)
        else:
            logits = ps.pair_logits_tiled_reference(folded, P_e, engine.latents,
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
    its plain version on the same device tensors; the row-scale kernel
    alone against ``_row_scales``; ``torch._int_mm`` on the GEMM shapes."""
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
        row_scale_ms=rs["ms"], row_scale_plain_ms=rs["plain_ms"], card=card)
    layer = {"max_abs_err": max(v["max_abs_err"] for v in out.values()),
             "ms": out["static"]["ms"], "plain_ms": out["static"]["plain_ms"],
             **bound(ops=ops, peak=INT8_OPS), "library_ms": library_ms}
    return {"pair_int8_layer": layer, "pair_int8_row_scale": rs}


def k2_row_scale(q, P_e, L_e):
    """The row-scale kernel alone: against ``_row_scales`` on the same rows
    of two chunks (layer 1 from a and c, layer 2 from the kernel's bf16
    carry), and the time of its 2 x 126 launches of a batch."""
    import torch

    from protnote_tpu_torch.ops import pair_scorer as ps

    k = ps._Int8Kernel(q, P_e, L_e, LABEL_TILE, torch.bfloat16)
    L_rows = L_e.shape[0]

    def launch(l0, nl, src):
        err = k.scale_fn(k.a.data_ptr(), k.c.data_ptr(), None if src is None else src.data_ptr(),
                         k.row_scale.data_ptr(), nl, l0, B * nl, H, 8, 1.3, int(src is None),
                         k.stream)
        if err != 0:
            raise RuntimeError(f"pair_int8_row_scale launch failed: CUDA error {err}")

    def plain_first(l0, nl):
        h = torch.relu(k.a[:, None, :] + k.c[None, l0:l0 + nl, :]).reshape(B * nl, -1)
        return ps._row_scales(h.to(torch.bfloat16))[:, 0]

    chunks = [(l0, min(LABEL_TILE, L_rows - l0)) for l0 in range(0, L_rows, LABEL_TILE)]
    err = 0.0
    with torch.cuda.device(P_e.device):
        for l0, nl in K2_CHUNKS:
            launch(l0, nl, None)
            err = max(err, float((k.row_scale[:B * nl] - plain_first(l0, nl)).abs().max()))
            carry = ps.int8_carry_cuda(q, P_e, L_e, l0, nl)
            launch(l0, nl, carry)
            err = max(err, float((k.row_scale[:B * nl] - ps._row_scales(carry)[:, 0]).abs().max()))
        work = k.work[0] if k.work else torch.zeros(B * LABEL_TILE, H, dtype=torch.bfloat16,
                                                       device=P_e.device)
        work.copy_(ps.int8_carry_cuda(q, P_e, L_e, 0, LABEL_TILE))

        def kernel_pass():
            for l0, nl in chunks:
                launch(l0, nl, None)
                launch(l0, nl, work)

        def plain_pass():
            for l0, nl in chunks:
                plain_first(l0, nl)
                ps._row_scales(work[:B * nl])

        ms = cuda_time_ms(kernel_pass, 3)
        plain_ms = cuda_time_ms(plain_pass, 1)
    log("k2_row_scale_check", chunks=len(K2_CHUNKS), max_abs_err=err)
    if err != 0.0:
        raise AssertionError(f"the row-scale kernel disagrees with _row_scales: {err}")
    # bytes the function needs: a and c at every 8th column (layer 1), the
    # bf16 carry at every 8th column (layer 2), one float32 scale a row out
    # per layer
    rows = B * L_rows
    nbytes = 4.0 * (B + L_rows) * H / 8 + 2.0 * rows * H / 8 + 8.0 * rows
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

    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        ds = eval_dataset(tmp)
    pi_cfg, pn_cfg, ts = random_models()
    pn8 = dataclasses.replace(pn_cfg, pair_backend="tiled_int8")
    total = {name: 0 for name in ps.INT8_LAUNCHES}
    for mode, calibrate in (("static", True), ("dynamic", False)):
        batcher = PrefetchBatcher(BucketBatcher(
            ds, B, buckets=(256, 512, 1024), return_label_multihots=True,
            descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True), prefetch=2)
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
        ran = launches["pair_int8_layer"] > 0 and (calibrate or launches["pair_int8_row_scale"] > 0)
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
    """K3's three entry points at full width against the plain version on
    the same tensors."""
    import torch

    from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator
    from protnote_tpu_torch.ops import eval_accumulator as k3

    dev = torch.device("cuda")
    batches = k3_batches(torch.Generator().manual_seed(4), dev)
    kern = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev)
    plain = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev)
    edges = 0
    for (logits, targets, em, lm), li in batches:
        cols = kern.cols_for(li, logits.shape[1])
        k3.update_cuda(kern.state, logits, targets, em, lm, cols, THRESHOLD, NUM_BINS)
        k3.update_reference(plain.state, logits, targets, em, lm, cols, THRESHOLD, NUM_BINS)
        edges += edge_elements(logits, (em[:, None] > 0) & (lm[None, :] > 0))
    torch.cuda.synchronize()
    deltas = compare_states(kern.state, plain.state, edges)
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
    sum_err = max(deltas["precision_sum"], deltas["recall_sum"])
    log("k3_check", batches=len(batches), labels=NUM_LABELS, bins=NUM_BINS,
        edge_elements=edges, state_deltas=deltas, max_ap_err=ap_err,
        micro_macro=out.tolist(), micro_macro_plain=out_p.tolist())

    # times, on scratch states (CUDA events; warm-up inside cuda_time_ms)
    (logits, targets, em, lm), _ = batches[0]
    s_k = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev).state
    s_p = DeviceEvalAccumulator(NUM_LABELS, THRESHOLD, NUM_BINS, device=dev).state
    row_counts = torch.randint(0, 100, (B, 3), dtype=torch.int32, device=dev)
    t = {
        "update": (cuda_time_ms(lambda: k3.update_cuda(
            s_k, logits, targets, em, lm, None, THRESHOLD, NUM_BINS), 20),
            cuda_time_ms(lambda: k3.update_reference(
                s_p, logits, targets, em, lm, None, THRESHOLD, NUM_BINS), 5)),
        "row_tail": (cuda_time_ms(lambda: k3.row_tail_cuda(s_k, row_counts, em), 50),
                     cuda_time_ms(lambda: k3.row_tail_reference(s_p, row_counts, em), 20)),
        "finalize": (cuda_time_ms(lambda: k3.finalize_cuda(
            kern.state["hist"], NUM_LABELS, NUM_BINS), 10),
            cuda_time_ms(lambda: k3.finalize_reference(
                plain.state["hist"], NUM_LABELS, NUM_BINS), 3)),
    }
    log("k3_time", **{f"{k}_ms": v[0] for k, v in t.items()},
        **{f"{k}_plain_ms": v[1] for k, v in t.items()}, card=card)
    errs = {"update": int_err, "row_tail": sum_err, "finalize": max(ap_err, out_err)}
    # bytes each entry point must move for the timed batch: the update reads
    # the logits, targets and masks, reads and writes tp/fp/fn and one
    # histogram count per valid element; the row tail reads the per-row
    # counts; finalize reads the histograms and writes per-label AP
    n_valid = float((em[:, None] * lm[None, :]).sum())
    nbytes = {"update": 8.0 * logits.numel() + 4 * (B + NUM_LABELS) + 24 * NUM_LABELS
              + 8 * n_valid + 12 * B,
              "row_tail": 16.0 * B + 8,
              "finalize": 4.0 * 2 * NUM_LABELS * NUM_BINS + 8 * NUM_LABELS + 16 * NUM_BINS + 8}
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

    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.evaln.metrics import DeviceEvalAccumulator, EvalMetrics
    from protnote_tpu_torch.ops import eval_accumulator as k3
    from protnote_tpu_torch.ops import pair_scorer as ps
    from protnote_tpu_torch.train.step import batch_to_device_dict
    from protnote_tpu_torch.train.trainer import Trainer, TrainerConfig

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = eval_dataset(tmp)
        batcher = PrefetchBatcher(BucketBatcher(
            ds, B, buckets=(256, 512, 1024), return_label_multihots=True,
            descriptions_per_label=K_DESCRIPTIONS, device_label_gather=True), prefetch=2)
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
    t0 = time.perf_counter()
    metrics = trainer.evaluate(batcher)["metrics"]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {"pair_mlp_layer": ps.LAUNCHES,
                **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}}
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
    return phase_train_kernels_alone(p, s, card)


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
    log("train_kernels_alone", batch=TRAIN_B, rows=int(z.shape[0]), width=H,
        elements=z.numel(), k5_plain_cols=K5_PLAIN_COLS,
        max_abs_errs={k: {o: d[0] for o, d in v.items()} for k, v in outs.items()},
        rel_errs=rel, rel_tol=K45_REL_TOL, **{f"{k}_ms": v[0] for k, v in times.items()},
        **{f"{k}_plain_ms": v[1] for k, v in times.items()}, card=card)
    if max(rel.values()) > K45_REL_TOL:
        raise AssertionError(f"a training kernel disagrees with its plain version: {outs}")
    return {k: {"max_abs_err": abs_errs[k], "ms": times[k][0], "plain_ms": times[k][1],
                **bounds[k], "library_ms": None} for k in times}


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


def phase_training(card: str):
    """One epoch of ``Trainer.train`` at full width; returns the launches of
    every kernel in it."""
    import dataclasses
    import statistics
    import tempfile

    import torch

    from protnote_tpu_torch.data.batching import BucketBatcher, PrefetchBatcher
    from protnote_tpu_torch.ops import eval_accumulator as k3
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
        t0 = time.perf_counter()
        summary = trainer.train(train_b, val_b)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"pair_mlp_layer": ps.LAUNCHES,
                    **{f"eval_acc_{k}": v for k, v in k3.LAUNCHES.items()}, **st.LAUNCHES}
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
    phase_serving(engine, rng, card)
    drift_seqs, drift_probs = phase_parity(engine, rng)
    int8_launches = phase_int8_serving(engine, rng, drift_seqs, drift_probs, card)
    del engine
    torch.cuda.empty_cache()
    k3_times = phase_k3(card)
    bf16_metrics = phase_eval(card, k3_times)
    torch.cuda.empty_cache()
    for name, v in phase_int8_eval(card, bf16_metrics).items():
        int8_launches[name] += v
    torch.cuda.empty_cache()
    train_times = phase_train_kernels(card)
    torch.cuda.empty_cache()
    launches = phase_training(card)
    if "jax" in sys.modules or any(m == "protnote_tpu" or m.startswith("protnote_tpu.")
                                   for m in sys.modules):
        raise AssertionError("the port's serving, evaluation or training path imported jax "
                             "or the JAX package")
    k3_src = "protnote_tpu_torch/csrc/eval_accumulator.cu"
    replaces = {"update": "protnote_tpu/evaln/metrics.py:601",
                "row_tail": "protnote_tpu/evaln/metrics.py:628",
                "finalize": "protnote_tpu/evaln/metrics.py:732"}
    train_kernels = {
        "pair_train_hidden": ("protnote_tpu_torch/csrc/pair_train.cu",
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
    } for k in ("update", "row_tail", "finalize")] + [{
        "name": k, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[k], **train_times[k],
    } for k, (src, rep) in train_kernels.items()] + [{
        "name": k, "route": "cuda", "source": "protnote_tpu_torch/csrc/pair_scorer_int8.cu",
        "replaces": "protnote_tpu/ops/pair_scorer.py:375", "launches": int8_launches[k], **k2[k],
    } for k in ("pair_int8_layer", "pair_int8_row_scale")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
