"""Hot reload in the port's serve CLI (protnote_tpu_torch/cli/serve.py), on
the CPU: ``POST /v1/reload`` restores another PNTPU1 checkpoint through
``Trainer.load`` and swaps it into the engine, which then scores as an
engine built on that checkpoint directly (exactly: the same weights through
the same CPU arithmetic); ``--name`` and ``--annotations-path-name`` reach
``get_setup``.  The checkpoints are random JAX ``init_train_state``s
written by the JAX ``save_checkpoint``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import yaml

import jax

AAS = "ACDEFGHIKLMNPQRSTVWY"
L, K, D = 7, 2, 16


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A small config file, the label cache and two checkpoints of other
    random weights."""
    from protnote_tpu.core.checkpoint import save_checkpoint
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state

    root = tmp_path_factory.mktemp("serve_reload")
    with open(DEFAULT_CONFIG_PATH) as fh:
        cfg = yaml.safe_load(fh)
    cfg["embed_sequences_params"].update(OUTPUT_CHANNELS=24, KERNEL_SIZE=5, NUM_RESNET_BLOCKS=1,
                                         PROTEINFER_NUM_GO_LABELS=L)
    cfg["params"].update(LATENT_EMBEDDING_DIM=8, PROJECTION_HEAD_NUM_LAYERS=2,
                         OUTPUT_MLP_NUM_LAYERS=2, SEQUENCE_BUCKETS=[32, 64],
                         MIXED_PRECISION=False)
    (root / "small.yaml").write_text(yaml.safe_dump(cfg))
    (root / "embeddings").mkdir()
    rng = np.random.default_rng(0)
    ids = [f"GO:{i:07d}" for i in range(L) for _ in range(K)]
    LabelEmbeddingCache.save(
        str(root / "embeddings" / "frozen_label_embeddings_E5multilingual_mean.npz"),
        rng.normal(size=(L * K, D)).astype(np.float32), ids, ["name", "label"] * L,
        ["d"] * (L * K), [3] * (L * K))
    pi = ProteInferConfig(input_channels=20, output_channels=24, kernel_size=5,
                          num_resnet_blocks=1, num_labels=L)
    pn = ProtNoteConfig.from_params(cfg["params"], protein_embedding_dim=24,
                                    label_embedding_dim=D, inference_descriptions_per_label=K)
    for name, seed in (("a", 10), ("b", 20)):
        pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(seed), pi)
        pn_p, pn_s = init_protnote(jax.random.PRNGKey(seed + 1), pn)
        save_checkpoint(str(root / f"{name}.ckpt"), init_train_state(
            pn_p, pn_s, pi_p, pi_s, make_optimizer(cfg["params"])), epoch=0)
    return root


@pytest.fixture()
def env(toy, monkeypatch):
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(toy))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(toy / "outputs"))
    return toy


def _engine(env, ckpt, *extra):
    from protnote_tpu_torch.cli import serve as tserve

    return tserve.build_engine(tserve.build_argparser().parse_args(
        ["--config", str(env / "small.yaml"), "--device", "cpu", "--max-batch", "4",
         "--model-file", str(env / ckpt), *extra]))


def _post(url, payload):
    req = urllib.request.Request(url, method="POST", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_reload_route_swaps_the_weights(env):
    from protnote_tpu_torch.cli import serve as tserve
    from protnote_tpu_torch.serving import make_http_server

    engine, trainer = _engine(env, "a.ckpt")
    direct, _ = _engine(env, "b.ckpt")
    rng = np.random.default_rng(1)
    seqs = ["".join(rng.choice(list(AAS), int(rng.integers(10, 50)))) for _ in range(5)]
    before = engine.score(seqs)
    want = direct.score(seqs)
    assert not np.allclose(before, want)
    server, batcher = make_http_server(engine, port=0,
                                       reload_fn=tserve.make_reload_fn(engine, trainer))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        status, body = _post(url + "/v1/reload", {"model_file": str(env / "b.ckpt")})
        assert status == 200 and body["status"] == "reloaded"
        np.testing.assert_array_equal(engine.score(seqs), want)
        _, preds = _post(url + "/v1/predict", {"sequences": seqs, "top_k": 3})
        assert [[g for g, _ in row] for row in preds["predictions"]] == \
            [[g for g, _ in row] for row in direct.top_k(seqs, k=3)]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/v1/reload", {"model_file": str(env / "missing.ckpt")})
        assert err.value.code == 400
        np.testing.assert_array_equal(engine.score(seqs), want)  # a failed reload keeps b
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_reload_with_equal_weights_keeps_the_scores(env):
    """Reloading the checkpoint the engine already serves changes nothing."""
    from protnote_tpu_torch.cli import serve as tserve

    engine, trainer = _engine(env, "a.ckpt")
    seqs = ["MKVLAAGIVGLLLAQ", "ACDEFGHIKLMNPQRSTVWY" * 2]
    before = engine.score(seqs)
    tserve.make_reload_fn(engine, trainer)(str(env / "a.ckpt"))
    np.testing.assert_array_equal(engine.score(seqs), before)


def test_name_and_annotations_path_name_parse(env):
    from protnote_tpu_torch.cli import serve as tserve

    args = tserve.build_argparser().parse_args(
        ["--name", "srv", "--annotations-path-name", "GO_ANNOTATIONS_2019_UPDATED_PATH"])
    assert args.name == "srv" and args.annotations_path_name == "GO_ANNOTATIONS_2019_UPDATED_PATH"
    defaults = tserve.build_argparser().parse_args([])
    assert defaults.name == "serve" and defaults.annotations_path_name == "GO_ANNOTATIONS_PATH"
    _, trainer = _engine(env, "a.ckpt", "--name", "srv")
    assert trainer.cfg.run_name.endswith("_srv")
