"""The port's copies of the JAX package's host-only modules against their
originals on the same inputs, on the CPU: ``data/`` (FASTA, vocabularies,
BLOSUM augmentation, the label-embedding cache and view, datasets, bucketed
and prefetching batchers), ``core/config.py``, the request side of
``serving.py`` (``topk_from_probs``, ``MicroBatcher``, the HTTP server) and
``resolve_label_tile``.  Every comparison is exact: the copies run the same
host code (the port leaves out the native parser, whose numpy path the
originals keep)."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from protnote_tpu.cli import _model_setup as jsetup
from protnote_tpu.core import config as jconfig
from protnote_tpu.data import batching as jbatching
from protnote_tpu.data import blosum as jblosum
from protnote_tpu.data import dataset as jdataset
from protnote_tpu.data import fasta as jfasta
from protnote_tpu.data import label_cache as jcache
from protnote_tpu.data import vocab as jvocab
from protnote_tpu import serving as jserving
from protnote_tpu_torch import serving_http as tserving
from protnote_tpu_torch.cli import _model_setup as tsetup
from protnote_tpu_torch.core import config as tconfig
from protnote_tpu_torch.data import batching as tbatching
from protnote_tpu_torch.data import blosum as tblosum
from protnote_tpu_torch.data import dataset as tdataset
from protnote_tpu_torch.data import fasta as tfasta
from protnote_tpu_torch.data import label_cache as tcache
from protnote_tpu_torch.data import vocab as tvocab

AAS = "ACDEFGHIKLMNPQRSTVWY"
N_LABELS = 40


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTA with wrapped sequences, odd residues, blank lines and
    duplicates, and a label cache with two or three descriptions a label."""
    root = tmp_path_factory.mktemp("host_copies")
    rng = np.random.default_rng(0)
    labels = [f"GO:{i:07d}" for i in range(N_LABELS)]
    lines = []
    seqs = []
    for i in range(60):
        seq = "".join(rng.choice(list(AAS + "XU"), int(rng.integers(5, 400))))
        if i % 17 == 3:
            seq = seqs[i - 1]  # a duplicate, dropped by DEDUPLICATE
        seqs.append(seq)
        labs = list(rng.choice(labels, size=int(rng.integers(0, 4)), replace=False))
        lines.append(">" + " ".join([f"s{i}", *labs]))
        lines += [seq[j:j + 60] for j in range(0, len(seq), 60)] + ([""] if i % 5 == 0 else [])
    (root / "x.fasta").write_text("\n".join(lines) + "\n")
    ids, types, texts = [], [], []
    for g in labels:
        for t in ("name", "label", "definition")[: 2 + int(g[-1]) % 2]:
            ids.append(g), types.append(t), texts.append(f"{t} of {g}")
    emb = rng.normal(size=(len(ids), 8)).astype(np.float32)
    jcache.LabelEmbeddingCache.save(str(root / "c.npz"), emb, ids, types, texts,
                                    rng.integers(1, 9, len(ids)))
    return root


def _assert_equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert (a is None) == (b is None)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_fasta_vocab_and_lut(files, tmp_path):
    path = str(files / "x.fasta")
    want = jfasta.read_fasta(path, use_native=False)
    got = tfasta.read_fasta(path)
    assert got == want == jfasta.read_fasta(path) and len(got) == 60
    for a, b in ((tfasta.save_to_fasta(got, str(tmp_path / "t.fa")),
                  jfasta.save_to_fasta(want, str(tmp_path / "j.fa"))),):
        assert open(a).read() == open(b).read()
    assert tvocab.generate_vocabularies(data=got) == jvocab.generate_vocabularies(data=want)
    assert tvocab.generate_vocabularies(file_path=path) == jvocab.generate_vocabularies(
        file_path=path)
    assert tvocab.COMMON_AMINOACIDS == jvocab.COMMON_AMINOACIDS
    assert tvocab.get_vocab_mappings(["b", "a"]) == jvocab.get_vocab_mappings(["b", "a"])
    with pytest.raises(ValueError, match="duplicate"):
        tvocab.get_vocab_mappings(["a", "a"])
    aa = sorted(tvocab.COMMON_AMINOACIDS)
    np.testing.assert_array_equal(tdataset.make_residue_lut(aa), jdataset.make_residue_lut(aa))


def test_blosum_augmentation(files):
    aa = sorted(AAS)
    ids = np.random.default_rng(1).integers(0, 21, 500).astype(np.int8)
    got = tblosum.Blosum62Mutations(aa).augment_ids(ids, 0.3, np.random.default_rng(2))
    want = jblosum.Blosum62Mutations(aa).augment_ids(ids, 0.3, np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)
    assert (got != ids).any()


def test_label_cache_and_view(files, tmp_path):
    tc = tcache.LabelEmbeddingCache.load(str(files / "c.npz"))
    jc = jcache.LabelEmbeddingCache.load(str(files / "c.npz"))
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(getattr(tc, f.name), getattr(jc, f.name))
    saved = tcache.LabelEmbeddingCache.save(str(tmp_path / "again"), tc.embeddings, tc.ids,
                                            tc.description_types, tc.descriptions,
                                            tc.token_counts)
    assert saved.endswith(".npz")
    np.testing.assert_array_equal(tcache.LabelEmbeddingCache.load(saved).embeddings,
                                  jc.embeddings)
    vocab = sorted(set(jc.ids.tolist()))[::-1][:30]  # unsorted, a subset
    for types in (("name", "label"), ("definition", "name"), ("label",)):
        tv = tcache.LabelEmbeddingView.build(tc, vocab, types)
        jv = jcache.LabelEmbeddingView.build(jc, vocab, types)
        for name in ("embeddings", "token_counts", "cache_indices", "label_starts", "counts"):
            np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
        np.testing.assert_array_equal(tv.first_k_rows(3), jv.first_k_rows(3))
        np.testing.assert_array_equal(tv.first_k_rows(2, np.array([4, 1])),
                                      jv.first_k_rows(2, np.array([4, 1])))
        np.testing.assert_array_equal(tv.sample_rows(np.random.default_rng(5)),
                                      jv.sample_rows(np.random.default_rng(5)))
    with pytest.raises(ValueError, match="no cached description"):
        tcache.LabelEmbeddingView.build(tc, vocab + ["GO:9999999"], ("name",))


@pytest.mark.parametrize("role", ["train", "test"])
def test_dataset_and_batcher_match(files, role):
    """ProteinDataset into a weighted, shuffled, token-budget BucketBatcher
    with device_label_gather (train: residue augmentation and one sampled
    description a label; test: k = 2 descriptions, padded label axis), equal
    array by array for every batch of two epochs; then a PrefetchBatcher
    around each yields the same batches."""
    params = {"AUGMENT_RESIDUE_PROBABILITY": 0.1, "LABEL_AUGMENTATION_DESCRIPTIONS":
              "name+label", "INFERENCE_GO_DESCRIPTIONS": "name+label", "DEDUPLICATE": True,
              "MAX_SEQUENCE_LENGTH": 300}
    path, cache = str(files / "x.fasta"), str(files / "c.npz")
    tds = tdataset.ProteinDataset(path, tdataset.DatasetConfig.from_params(params, role),
                                  tcache.LabelEmbeddingCache.load(cache), seed=3)
    jds = jdataset.ProteinDataset(path, jdataset.DatasetConfig.from_params(params, role),
                                  jcache.LabelEmbeddingCache.load(cache), seed=3)
    assert tds.label_vocabulary == jds.label_vocabulary and len(tds) == len(jds) > 30
    np.testing.assert_array_equal(tds.lengths, jds.lengths)
    np.testing.assert_array_equal(tds.calculate_label_counts(), jds.calculate_label_counts())
    weights = jds.calculate_sequence_weights(jds.calculate_label_weights(0.5), "sum")
    np.testing.assert_array_equal(
        tds.calculate_sequence_weights(tds.calculate_label_weights(0.5), "sum"), weights)
    kw = dict(batch_size=16, buckets=(64, 128, 256), shuffle=True, seed=7,
              sequence_weights=weights, device_label_gather=True, tokens_per_batch=2048,
              descriptions_per_label=2, label_pad_multiple=16)
    tb, jb = tbatching.BucketBatcher(tds, **kw), jbatching.BucketBatcher(jds, **kw)
    for epoch in (0, 1):
        tb.set_epoch(epoch)
        jb.set_epoch(epoch)
        assert len(tb) == len(jb) > 3
        n = 0
        for got, want in zip(tb, jb):
            for f in dataclasses.fields(want):
                _assert_equal(getattr(got, f.name), getattr(want, f.name))
            n += 1
        assert n == len(jb)
    got = list(tbatching.PrefetchBatcher(tb, prefetch=2))
    want = list(jbatching.PrefetchBatcher(jb, prefetch=2))
    assert len(got) == len(want) == len(tb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.aa_ids, w.aa_ids)
        np.testing.assert_array_equal(g.label_rows, w.label_rows)


def test_prefetch_batcher_delegates_and_raises():
    class Boom:
        ds = "the dataset"

        def __len__(self):
            return 2

        def __iter__(self):
            yield 1
            raise RuntimeError("boom")

    pb = tbatching.PrefetchBatcher(Boom(), prefetch=1)
    assert pb.ds == "the dataset" and len(pb) == 2
    it = iter(pb)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_config_functions(tmp_path, monkeypatch):
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path / "d"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(tmp_path / "o"))
    assert tconfig.DEFAULT_CONFIG_PATH == jconfig.DEFAULT_CONFIG_PATH
    over = ["DECISION_TH", "null", "ESTIMATE_MAP", "true", "SEQUENCE_BUCKETS", "[128, 256]",
            "OUTPUT_CHANNELS", "48", "LABEL_ENCODER_CHECKPOINT", "intfloat/e5-large-v2",
            "OPTIMIZER", "AdamW"]
    t = tconfig.resolve_paths(tconfig.override_config(tconfig.load_config(), over))
    j = jconfig.resolve_paths(jconfig.override_config(jconfig.load_config(), over))
    assert dict(t) == dict(j)
    assert t.params["DECISION_TH"] is None and t.params["SEQUENCE_BUCKETS"] == [128, 256]
    base = t["paths_resolved"]["GO_BASE_LABEL_EMBEDDING_PATH"]
    emb = tconfig.generate_label_embedding_path(t["params"], base)
    assert emb == jconfig.generate_label_embedding_path(j["params"], base)
    assert tconfig.label_embedding_index_path(emb) == jconfig.label_embedding_index_path(emb)
    with pytest.raises(KeyError, match="NOT_A_KEY"):
        tconfig.override_config(tconfig.load_config(), ["NOT_A_KEY", "1"])
    with pytest.raises(ValueError, match="pairs"):
        tconfig.override_config(tconfig.load_config(), ["DECISION_TH"])
    log = tconfig.setup_logging(str(tmp_path / "logs"), "run")
    log.info("hello")
    assert (tmp_path / "logs" / "run.log").exists()


@pytest.mark.parametrize("params", [
    {}, {"LABEL_TILE_SIZE": 256}, {"LABEL_BATCH_SIZE_LIMIT_NO_GRAD": 1000},
    {"LABEL_BATCH_SIZE_LIMIT_NO_GRAD": 50}, {"LABEL_TILE_SIZE": 1024,
                                              "LABEL_BATCH_SIZE_LIMIT_NO_GRAD": 300},
])
def test_resolve_label_tile(params):
    assert tsetup.resolve_label_tile(params) == jsetup.resolve_label_tile(params)


def test_topk_from_probs():
    rng = np.random.default_rng(0)
    probs = rng.random((5, 30)).astype(np.float32)
    vocab = [f"GO:{i}" for i in range(30)]
    for k, th in ((3, None), (10, 0.5), (100, None), (0, 0.9)):
        assert tserving.topk_from_probs(vocab, probs, k, th) == \
            jserving.topk_from_probs(vocab, probs, k, th)


class _StubEngine:
    """What the request side reads of an engine: deterministic scores."""

    max_batch = 4
    label_vocabulary = [f"GO:{i:07d}" for i in range(6)]

    def __init__(self, stats):
        self.stats = stats
        self.pn_cfg = type("Cfg", (), {"pair_backend": "tiled_int8"})()

    def _encode(self, sequences):
        for i, s in enumerate(sequences):
            if not s or not isinstance(s, str):
                raise ValueError(f"sequence {i} is empty or not a string")
        return sequences

    def score(self, sequences):
        with self.stats.lock:
            self.stats.sequences += len(sequences)
            self.stats.batches += 1
            self.stats.batched_rows += self.max_batch
        return np.array([[(len(s) * (j + 1)) % 7 / 7.0 + 0.01 for j in range(6)]
                         for s in sequences], np.float32)


def _serve(module, stats_cls, calls):
    """Start ``module``'s HTTP server on a stub engine, make ``calls``
    (method, path, body) and return the (code, body) replies."""
    engine = _StubEngine(stats_cls())
    reloaded = []
    server, batcher = module.make_http_server(engine, port=0, reload_fn=reloaded.append)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    out = []
    try:
        for method, path, body in calls:
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(url + path, data=data, method=method)
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    code, text = resp.status, resp.read().decode()
            except urllib.error.HTTPError as e:
                code, text = e.code, e.read().decode()
            out.append((code, text if path == "/metrics" else json.loads(text)))
        out.append(("reloaded", reloaded))
    finally:
        batcher.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    return out


def test_http_server_and_micro_batcher_match():
    calls = [("POST", "/v1/predict", {"sequences": ["MKV", "ACDEFG"], "top_k": 3}),
             ("POST", "/v1/predict", {"sequences": ["MKVLA"], "top_k": 2, "threshold": 0.3}),
             ("POST", "/v1/predict", {"sequences": []}),
             ("POST", "/v1/predict", {"sequences": ["MK", ""]}),
             ("POST", "/v1/reload", {"model_file": "a.ckpt"}),
             ("POST", "/v1/reload", {}),
             ("GET", "/healthz", None), ("GET", "/metrics", None), ("GET", "/nope", None)]
    got = _serve(tserving, tserving.ServingStats, calls)
    want = _serve(jserving, jserving.ServingStats, calls)
    assert got == want
    assert got[0][0] == 200 and len(got[0][1]["predictions"]) == 2
    assert got[2][0] == 400 and got[6][1]["backend"] == "tiled_int8"
    assert got[-1] == ("reloaded", ["a.ckpt"])


def test_micro_batcher_coalesces_concurrent_requests():
    stats = tserving.ServingStats()
    engine = _StubEngine(stats)
    mb = tserving.MicroBatcher(engine, max_wait_ms=200, pipeline_depth=1)
    results = [None] * 3
    seqs = [["MK"], ["ACD", "EF"], ["G"]]

    def call(i):
        results[i] = mb.submit(seqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.close()
    for r, s in zip(results, seqs):
        np.testing.assert_array_equal(r, engine.score(s))
    assert stats.snapshot()["requests"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(["MK"])
