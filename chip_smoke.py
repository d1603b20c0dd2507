#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one CUDA card (H100).

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):

1. device: card name, power limit, CUDA and nvcc versions;
2. build: compiles ``protnote_tpu_torch/csrc/pair_scorer.cu`` with nvcc;
3. the pair-scorer kernel against its plain PyTorch version at the full
   serving width (32 sequences x 64,204 label rows, d=1024, H=3072, bf16),
   with both times from CUDA events;
4. serving: a full-width ``ServingEngine`` (ProteInfer 1100 channels x 5
   blocks, 32,102 labels x 2 descriptions) behind the stdlib HTTP server,
   answering /v1/predict and /healthz requests;
5. serving parity: ``engine.score`` against a forward through the plain
   pair scorer on the same device tensors.

Then one JSON line per kernel with its launches on the serving path, its
error against the plain version and both times, the card's name and power
limit, and last the line ``{"ok": true, "device": {...}}``.  Weights and
label embeddings are random, made from fixed seeds.  There is no CPU path:
without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    from protnote_tpu_torch.ops.kernels import load_kernel_library

    lib = load_kernel_library("pair_scorer")
    ptxas = [line.strip() for line in lib.build_log.splitlines()
             if "registers" in line or "spill" in line]
    log("build", library=os.path.relpath(lib.path, ROOT),
        seconds=lib.build_seconds, ptxas=ptxas)


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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def build_engine():
    import numpy as np
    import torch

    from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu_torch.serving import ServingEngine

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
    gen = torch.Generator().manual_seed(2)
    matrix = torch.randn(NUM_LABELS * K_DESCRIPTIONS, D_LATENT, generator=gen).numpy()
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


def phase_parity(engine, rng):
    """engine.score against a forward through the plain pair scorer on the
    same device tensors (the engine reads logits back in f16)."""
    import numpy as np
    import torch

    from protnote_tpu_torch.models.fusion import ensemble_logits, projection_head_apply
    from protnote_tpu_torch.models.proteinfer import embed_from_ids
    from protnote_tpu_torch.ops.pair_scorer import (
        fold_output_mlp,
        pair_logits_tiled_reference,
    )

    seqs = random_sequences(rng, [120, 333, 480, 77])
    got = engine.score(seqs)
    aa, lengths = engine._assemble(engine._encode(seqs), 512)
    ts, cfg = engine.ts, engine.pn_cfg
    pn, state = ts["trainable"]["protnote"], ts["model_state"]
    with torch.inference_mode():
        P_f = embed_from_ids(ts["enc_params"], ts["enc_state"],
                             torch.from_numpy(aa).cuda(), torch.from_numpy(lengths).cuda(),
                             engine.pi_cfg)
        P_e = projection_head_apply(pn["W_p"], state["W_p"], P_f.to(cfg.compute_dtype))
        folded = fold_output_mlp(pn["output_mlp"], state["output_mlp"], cfg.feature_fusion,
                                 cfg.latent_dim, dtype=cfg.compute_dtype)
        logits = pair_logits_tiled_reference(folded, P_e, engine.latents, cfg.label_tile,
                                             cfg.compute_dtype)
        want = torch.sigmoid(ensemble_logits(logits, K_DESCRIPTIONS))[: len(seqs)]
    want = want.float().cpu().numpy()
    err = float(np.abs(got - want).max())
    log("serving_parity", sequences=len(seqs), max_abs_prob_err=err, prob_atol=PROB_ATOL,
        prob_std=float(want.std()))
    if not (np.isfinite(got).all() and err <= PROB_ATOL):
        raise AssertionError(f"engine disagrees with the plain forward: {err}")


def main() -> None:
    sys.path.insert(0, ROOT)
    phase_device()
    import torch

    card = card_line()
    phase_build()
    k1 = phase_kernel(card)
    engine, build_s, rng = build_engine()
    log("engine", build_seconds=build_s, labels=NUM_LABELS, label_rows=NUM_LABELS * K_DESCRIPTIONS,
        latents=list(engine.latents.shape), latents_dtype=str(engine.latents.dtype))
    launches = phase_serving(engine, rng, card)
    phase_parity(engine, rng)
    if "jax" in sys.modules:
        raise AssertionError("the port's serving path imported jax")
    print(json.dumps({"kernels": [{
        "name": "pair_mlp_layer", "route": "cuda",
        "source": "protnote_tpu_torch/csrc/pair_scorer.cu",
        "replaces": "protnote_tpu/ops/pair_scorer.py:197",
        "launches": launches, **k1,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
