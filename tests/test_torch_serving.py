"""The port's serving path (protnote_tpu_torch/serving.py, cli/serve.py)
against the JAX ServingEngine on the same weights, and end to end through
the stdlib HTTP front end, on the CPU.

Tolerance on probabilities: 2e-3 absolute. Both engines read logits back in
float16 (a relative step of 2^-11) and apply the sigmoid on the host, so a
logit that lands on the neighbouring f16 value moves its probability by at
most sigmoid'(x) * |x| * 2^-10 ~ 5e-4 for the |logit| < 8 here; bf16 compute
adds at most one bf16 step of the logit before that rounding.
"""

import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from protnote_tpu.data.label_cache import LabelEmbeddingCache
from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu.serving import ServingEngine as JaxEngine
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state
from protnote_tpu_torch.cli import serve as tserve
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.serving import ServingEngine, make_http_server

AAS = "ACDEFGHIKLMNPQRSTVWY"
L, K, D = 7, 2, 16
SMALL_PI = dict(output_channels=24, kernel_size=5, num_resnet_blocks=1, num_labels=L)
SMALL_PN = dict(protein_embedding_dim=24, label_embedding_dim=D, latent_dim=8,
                projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
                output_mlp_num_layers=2, output_mlp_hidden_dim_scale_factor=2,
                label_tile=4, inference_descriptions_per_label=K)
DTYPES = {"f32": (None, jnp.float32, None, torch.float32),
          "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, torch.bfloat16)}


def _engines(dtype="f32", max_batch=4, buckets=(32, 64)):
    """A JAX engine and the port's engine on the same weights and labels."""
    jpi_dt, jpn_dt, tpi_dt, tpn_dt = DTYPES[dtype]
    jpi = ProteInferConfig(**SMALL_PI, compute_dtype=jpi_dt)
    jpn = ProtNoteConfig(**SMALL_PN, compute_dtype=jpn_dt)
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(0), jpi)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(1), jpn)
    ts = init_train_state(pn_p, pn_s, pi_p, pi_s,
                          make_optimizer({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3}))
    matrix = np.random.default_rng(0).normal(size=(L * K, D)).astype(np.float32)
    vocab = [f"GO:{i:07d}" for i in range(L)]
    jax_engine = JaxEngine(ts, jpi, jpn, matrix, vocab, buckets=buckets,
                           max_batch=max_batch)
    port = ServingEngine(
        from_jax_tree(jax.tree_util.tree_map(np.asarray, ts)),
        tpi.ProteInferConfig(**SMALL_PI, compute_dtype=tpi_dt),
        tfu.ProtNoteConfig(**SMALL_PN, compute_dtype=tpn_dt),
        matrix, vocab, buckets=buckets, max_batch=max_batch, device="cpu")
    return jax_engine, port


def _seqs(rng, n, lo=10, hi=50):
    return ["".join(rng.choice(list(AAS), int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_matches_jax_engine(dtype, rng):
    jax_engine, port = _engines(dtype)
    seqs = _seqs(rng, 6, lo=5, hi=60) + ["MKVXBZ*ACD"]  # unknown residues too
    want = jax_engine.score(seqs)
    got = port.score(seqs)
    assert got.shape == (7, L) and got.dtype == np.float32
    assert np.all((got > 0) & (got < 1))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    assert port.stats.snapshot()["sequences"] == 7


def test_bucket_order_invariance_and_truncation(rng):
    _, port = _engines(max_batch=3)
    seqs = _seqs(rng, 7, lo=5, hi=60)
    probs = port.score(seqs)
    perm = rng.permutation(len(seqs))
    np.testing.assert_allclose(port.score([seqs[i] for i in perm]), probs[perm], atol=1e-6)
    long_seq = "".join(rng.choice(list(AAS), 200))  # > largest bucket (64)
    np.testing.assert_allclose(port.score([long_seq]), port.score([long_seq[:64]]),
                               atol=1e-6)
    with pytest.raises(ValueError, match="empty"):
        port.score(["ACDE", ""])


def test_top_k_reload_and_warmup(rng):
    jax_engine, port = _engines()
    seqs = _seqs(rng, 2)
    probs = port.score(seqs)
    top = port.top_k(seqs, k=3)
    for row, pairs in zip(probs, top):
        ps = [p for _, p in pairs]
        assert len(pairs) == 3 and ps == sorted(ps, reverse=True)
        assert ps[0] == pytest.approx(float(row.max()), abs=1e-6)
    port.warmup()
    assert port.stats.snapshot()["batches"] >= 3
    # reload with other weights changes the scores; reloading the first back
    # restores them
    jpn = ProtNoteConfig(**SMALL_PN)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(7), jpn)
    first = port.ts
    other = dict(first, trainable={"protnote": from_jax_tree(
        {"p": jax.tree_util.tree_map(np.asarray, pn_p)})["p"]})
    port.reload(other)
    assert not np.allclose(port.score(seqs), probs, atol=1e-4)
    port.reload(first)
    np.testing.assert_allclose(port.score(seqs), probs, atol=1e-6)


def test_http_server_end_to_end(rng):
    _, port = _engines()
    server, batcher = make_http_server(port, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        seqs = _seqs(rng, 3)
        req = urllib.request.Request(
            url + "/v1/predict", method="POST",
            data=json.dumps({"sequences": seqs, "top_k": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            preds = json.loads(resp.read())["predictions"]
        assert len(preds) == 3 and all(len(p) == 4 for p in preds)
        want = port.top_k(seqs, k=4)
        for got_row, want_row in zip(preds, want):
            assert [g for g, _ in got_row] == [g for g, _ in want_row]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["labels"] == L
        assert health["backend"] == "auto" and health["requests"] >= 1
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_engine_refuses_later_slices():
    """A mesh (label-sharded serving) is a later slice; the int8 backend is
    served now (tests/test_torch_int8_wiring.py holds it against JAX)."""
    jax_engine, port = _engines()
    ts, matrix = port.ts, port._label_matrix.numpy()
    vocab = port.label_vocabulary
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ServingEngine(ts, port.pi_cfg, port.pn_cfg, matrix, vocab, device="cpu",
                      mesh=object())
    int8 = tfu.ProtNoteConfig(**{**port.pn_cfg.__dict__, "pair_backend": "tiled_int8"})
    engine = ServingEngine(ts, port.pi_cfg, int8, matrix, vocab, device="cpu")
    assert engine._needs_calibration


def test_cli_builds_engine_from_config(tmp_path, monkeypatch, rng):
    """cli.serve: config file + label cache -> a working engine, without jax
    in the loop (load_config/override_config, not get_setup)."""
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH

    with open(DEFAULT_CONFIG_PATH) as fh:
        cfg = yaml.safe_load(fh)
    cfg["embed_sequences_params"].update(OUTPUT_CHANNELS=24, KERNEL_SIZE=5,
                                         NUM_RESNET_BLOCKS=1, PROTEINFER_NUM_GO_LABELS=L)
    cfg["params"].update(LATENT_EMBEDDING_DIM=8, PROJECTION_HEAD_NUM_LAYERS=2,
                         OUTPUT_MLP_NUM_LAYERS=2, SEQUENCE_BUCKETS=[32, 64])
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    ids = [f"GO:{i:07d}" for i in range(L) for _ in range(K)]
    emb_dir = tmp_path / "embeddings"
    emb_dir.mkdir()
    LabelEmbeddingCache.save(
        str(emb_dir / "frozen_label_embeddings_E5multilingual_mean.npz"),
        rng.normal(size=(L * K, D)).astype(np.float32), ids,
        ["name", "label"] * L, ["d"] * (L * K), [3] * (L * K))
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path))
    args = tserve.build_argparser().parse_args(
        ["--config", str(path), "--device", "cpu", "--max-batch", "2",
         "--override", "MIXED_PRECISION", "False"])
    engine, _ = tserve.build_engine(args)
    assert engine.pn_cfg.compute_dtype == torch.float32
    assert engine.pn_cfg.inference_descriptions_per_label == K
    probs = engine.score(_seqs(rng, 3))
    assert probs.shape == (3, L) and np.all((probs > 0) & (probs < 1))
    with pytest.raises(FileNotFoundError, match="--model-file"):
        tserve.build_engine(tserve.build_argparser().parse_args(
            ["--config", str(path), "--device", "cpu", "--model-file", "x.ckpt"]))
    assert "jax" in sys.modules  # this test process has it; the port does not
