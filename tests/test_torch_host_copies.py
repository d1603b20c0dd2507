"""The port's copies of the JAX package's host-only modules against their
originals on the same inputs, on the CPU: ``data/`` (FASTA, vocabularies,
BLOSUM augmentation, the label-embedding cache and view, datasets, bucketed
and prefetching batchers), ``core/config.py``, the request side of
``serving.py`` (``topk_from_probs``, ``MicroBatcher``, the HTTP server),
``resolve_label_tile``, and the label-text helpers of the label tower
(``remove_obsolete_from_string``, ``E5_INSTRUCTION``, ``MAX_LABEL_TOKENS``,
the numpy ``pool_hidden_states``, ``HashLabelEncoder``,
``flatten_annotations``), and the host half of evaluation
(``average_precision``, ``average_precision_columns``, ``_logit_grid_keys``,
``_ap_from_dense_hist``, ``ExactAUPRC`` with its disk spool, ``DagNormalizer``,
``save_evaluation_results`` and ``cli/test_models.TEST_COMMANDS``).  Every
comparison is exact: the copies run the same host code (the port leaves out
the native parser, whose numpy path the originals keep)."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from protnote_tpu.cli import _model_setup as jsetup
from protnote_tpu.cli import generate_label_embeddings as jgen
from protnote_tpu.core import config as jconfig
from protnote_tpu.data import batching as jbatching
from protnote_tpu.data import annotations as jannotations
from protnote_tpu.data import blosum as jblosum
from protnote_tpu.data import dataset as jdataset
from protnote_tpu.data import fasta as jfasta
from protnote_tpu.data import label_cache as jcache
from protnote_tpu.data import vocab as jvocab
from protnote_tpu.models import label_encoder as jlabel
from protnote_tpu import serving as jserving
from protnote_tpu.cli import test_models as jtest_models
from protnote_tpu.evaln import go_dag as jgo_dag
from protnote_tpu.evaln import metrics as jmetrics
from protnote_tpu.evaln import results_io as jresults
from protnote_tpu_torch import serving_http as tserving
from protnote_tpu_torch.cli import _model_setup as tsetup
from protnote_tpu_torch.cli import generate_label_embeddings as tgen
from protnote_tpu_torch.core import config as tconfig
from protnote_tpu_torch.data import batching as tbatching
from protnote_tpu_torch.data import annotations as tannotations
from protnote_tpu_torch.data import blosum as tblosum
from protnote_tpu_torch.data import dataset as tdataset
from protnote_tpu_torch.data import fasta as tfasta
from protnote_tpu_torch.data import label_cache as tcache
from protnote_tpu_torch.data import vocab as tvocab
from protnote_tpu_torch.cli import test_models as ttest_models
from protnote_tpu_torch.evaln import go_dag as tgo_dag
from protnote_tpu_torch.evaln import metrics as tmetrics
from protnote_tpu_torch.evaln import results_io as tresults
from protnote_tpu_torch.models import label_encoder as tlabel

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


@pytest.mark.parametrize("roles", [
    {}, {"train_path_name": "TRAIN_DATA_PATH", "val_path_name": "VAL_DATA_PATH",
         "test_paths_names": ["TEST_DATA_PATH", "TEST_DATA_PATH_ZERO_SHOT"],
         "annotations_path_name": "GO_ANNOTATIONS_2019_UPDATED_PATH"}])
def test_get_setup(tmp_path, monkeypatch, roles):
    """The port's one-process ``get_setup``: the JAX one's config (dataset
    roles, annotations and label-embedding paths) and a run name
    ``<timestamp>_<name>``."""
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path / "d"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(tmp_path / "o"))
    over = ["LABEL_ENCODER_CHECKPOINT", "intfloat/e5-large-v2", "DECISION_TH", "null"]
    t, t_name, t_log = tconfig.get_setup(run_name="x", overrides=over, **roles)
    j, j_name, _ = jconfig.get_setup(run_name="x", overrides=over, **roles)
    assert dict(t) == dict(j)
    assert t_name.endswith("_x") and len(t_name) == len(j_name)
    assert t["LABEL_EMBEDDING_PATH"].endswith("_E5_mean.npz")
    assert t_log.name == f"protnote_tpu_torch.{t_name}"


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


@pytest.mark.parametrize("text", ["OBSOLETE. kinase activity", "  obsolete kinase", "Obsolete.",
                                  "kinase, obsolete form", "plain text  ", ""])
def test_remove_obsolete_from_string(text):
    assert tannotations._OBSOLETE_PREFIX_RE.pattern == jannotations._OBSOLETE_PREFIX_RE.pattern
    assert tannotations._OBSOLETE_PREFIX_RE.flags == jannotations._OBSOLETE_PREFIX_RE.flags
    assert tannotations.remove_obsolete_from_string(text) == \
        jannotations.remove_obsolete_from_string(text)


def test_label_text_constants_and_numpy_pooling():
    assert tlabel.E5_INSTRUCTION == jlabel.E5_INSTRUCTION
    assert tlabel.MAX_LABEL_TOKENS == jlabel.MAX_LABEL_TOKENS
    assert tlabel.NativeLabelEncoder._LEN_BUCKETS == jlabel.JaxLabelEncoder._LEN_BUCKETS
    rng = np.random.default_rng(0)
    h = rng.normal(size=(4, 9, 8)).astype(np.float32)
    mask = np.array([[1] * 9, [1] * 4 + [0] * 5, [1] + [0] * 8, [0] * 9], np.int32)
    for method in ("mean", "last_token", "all"):
        for sos in (True, False):
            np.testing.assert_array_equal(tlabel.pool_hidden_states(h, mask, method, sos),
                                          jlabel.pool_hidden_states(h, mask, method, sos))
    with pytest.raises(ValueError):
        tlabel.pool_hidden_states(h, mask, "max")


def test_hash_label_encoder():
    texts = ["kinase activity", "", "DNA repair of the DNA", "x " * 600]
    t, j = tlabel.HashLabelEncoder(dim=32), jlabel.HashLabelEncoder(dim=32)
    assert t.checkpoint == j.checkpoint == "hash" and t.dim == j.dim
    assert t.token_counts(texts) == j.token_counts(texts)
    np.testing.assert_array_equal(t.embed(texts), j.embed(texts))


def test_flatten_annotations():
    import pandas as pd

    df = pd.DataFrame(
        {"name": ["alpha", "beta", None],
         "label": ["def of alpha", "OBSOLETE. def of beta", float("nan")],
         "synonym_exact": [["syn1", "syn2"], [], np.array(["s3", ""])]},
        index=["GO:1", "GO:2", "GO:3"])
    assert tgen.DESCRIPTION_TYPES == jgen.DESCRIPTION_TYPES
    assert tgen.flatten_annotations(df) == jgen.flatten_annotations(df)
    only_names = df[["name"]]
    assert tgen.flatten_annotations(only_names) == jgen.flatten_annotations(only_names)


def _scores(rng, n, c):
    """Probabilities with ties (a coarse grid), a NaN-free (n, c) block,
    and targets with an all-negative column."""
    probs = (np.round(rng.random((n, c)) * 50) / 50).astype(np.float32)
    targets = (rng.random((n, c)) < 0.3).astype(np.float32)
    targets[:, 1] = 0
    return probs, targets


def test_average_precision_and_logit_grid():
    rng = np.random.default_rng(5)
    probs, targets = _scores(rng, 40, 7)
    for c in range(7):
        t, j = (m.average_precision(probs[:, c], targets[:, c]) for m in (tmetrics, jmetrics))
        assert (np.isnan(t) and np.isnan(j)) or t == j
    np.testing.assert_array_equal(tmetrics.average_precision_columns(probs, targets),
                                  jmetrics.average_precision_columns(probs, targets))
    p = np.r_[probs.reshape(-1), 0.0, 1.0, np.nan].astype(np.float32)
    for bins in (1 << 20, 64):
        np.testing.assert_array_equal(tmetrics._logit_grid_keys(p, bins),
                                      jmetrics._logit_grid_keys(p, bins))
    pos, neg = rng.integers(0, 5, 300), rng.integers(0, 5, 300)
    assert tmetrics._ap_from_dense_hist(pos, neg) == jmetrics._ap_from_dense_hist(pos, neg)
    assert np.isnan(tmetrics._ap_from_dense_hist(np.zeros(4), np.ones(4)))


@pytest.mark.parametrize("spill", [False, True], ids=["in_ram", "spooled"])
def test_exact_auprc(tmp_path, spill):
    """Four updates (one masked); ``spill`` forces the disk spool with a
    16-byte threshold and 8-row tiles, so per-label AP reads the spool."""
    rng = np.random.default_rng(6)
    kw = dict(spill_threshold_bytes=16, tile_rows=8, spill_dir=str(tmp_path)) if spill else {}
    accs = [m.ExactAUPRC(9, macro_chunk=4, **kw) for m in (tmetrics, jmetrics)]
    for i in range(4):
        probs, targets = _scores(rng, 11, 9)
        mask = rng.random(11) < 0.8 if i == 2 else None
        for acc in accs:
            acc.update(probs, targets, mask)
    t, j = accs
    assert (t._spool is not None) == (j._spool is not None) == spill
    np.testing.assert_array_equal(t.per_label(), j.per_label())
    assert t.compute() == j.compute()
    with pytest.raises(ValueError, match="label subsets"):
        t.update(probs, targets, label_indices=np.arange(9))
    metrics = [m.EvalMetrics(9, 0.4, map_estimate=False, spill_threshold_bytes=16,
                             spill_dir=str(tmp_path), spill_tile_rows=8)
               for m in (tmetrics, jmetrics)]
    for met in metrics:
        met.update(probs, targets)
        met.update(probs, targets)
    assert metrics[0].auprc._spool is not None
    assert metrics[0].compute("x") == metrics[1].compute("x")


def test_dag_normalizer():
    vocab = [f"GO:{i}" for i in range(6)]
    parenthood = {"GO:3": ["GO:0", "GO:1"], "GO:4": ["GO:0", "GO:1"], "GO:5": ["GO:2"],
                  "GO:9": ["GO:0"], "GO:1": ["GO:0"]}
    preds = np.random.default_rng(7).random((5, 6)).astype(np.float32)
    t, j = tgo_dag.DagNormalizer(vocab, parenthood), jgo_dag.DagNormalizer(vocab, parenthood)
    np.testing.assert_array_equal(t.offsets, j.offsets)
    np.testing.assert_array_equal(t.child_idx, j.child_idx)
    np.testing.assert_array_equal(t(preds), j(preds))
    np.testing.assert_array_equal(tgo_dag.normalize_confidences(preds, vocab, parenthood),
                                  jgo_dag.normalize_confidences(preds, vocab, parenthood))
    assert tgo_dag.reverse_map(parenthood, {"GO:3"}) == jgo_dag.reverse_map(parenthood, {"GO:3"})


def test_save_evaluation_results(tmp_path):
    rng = np.random.default_rng(8)
    vocab = [f"GO:{i}" for i in range(5)]
    results = {"logits": rng.normal(size=(4, 5)).astype(np.float16),
               "labels": (rng.random((4, 5)) < 0.5), "sequence_ids": list("abcd")}
    paths = {}
    for name, mod in (("t", tresults), ("j", jresults)):
        paths[name] = mod.save_evaluation_results(results, vocab, f"run_{name}",
                                                  str(tmp_path / name), "test")
    assert {k: v.replace("/t/", "/").replace("run_t", "run")
            for k, v in paths["t"].items()} == {
        k: v.replace("/j/", "/").replace("run_j", "run") for k, v in paths["j"].items()}
    for kind in ("logits", "labels"):
        got, want = tresults.load_logits(paths["t"][kind]), jresults.load_logits(paths["j"][kind])
        assert got.equals(want)
    with pytest.raises(ValueError, match="vocabulary"):
        tresults.save_evaluation_results(results, vocab[:4], "r", str(tmp_path), "x")


def test_test_models_commands():
    assert ttest_models.TEST_COMMANDS == jtest_models.TEST_COMMANDS
