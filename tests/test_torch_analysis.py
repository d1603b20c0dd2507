"""The port's copies of the analysis helpers (protnote_tpu_torch/evaln/
analysis.py, ``ec_number_to_code`` in data/annotations.py) and of
``cli/calculate_supervised_metrics.py`` against the JAX package's, on the
same inputs.  Both run the same numpy arithmetic on the host: every metric,
frame and statistic is compared exactly (NaN where both give NaN)."""

import json

import numpy as np
import pandas as pd
import pytest

from protnote_tpu.data import annotations as jann
from protnote_tpu.evaln import analysis as jan
from protnote_tpu_torch.data import annotations as tann
from protnote_tpu_torch.evaln import analysis as tan

GO = {"GO:0000001": ["GO:0008150"], "GO:0000002": ["GO:0003674", "GO:0008150"],
      "GO:0000003": ["GO:0005575"], "GO:0000004": ["GO:0003674"], "GO:0000005": []}
EC = ["EC:1.1.1.1", "EC:1.2.-.-", "EC:2.7.11.1", "EC:3.-.-.-", "EC:7.1.1.2", "EC:6.3.2.4"]
EC_CLASSES = {(1, 0, 0): {"label": "Oxidoreductases"}, (2, 0, 0): {"label": "Transferases"},
              (3, 0, 0): {"label": "Hydrolases"}, (6, 0, 0): {"label": "Ligases"}}


def _frames(columns, seed, n=40):
    rng = np.random.default_rng(seed)
    index = [f"S{i}" for i in range(n)]
    logits = pd.DataFrame(rng.normal(0, 2, size=(n, len(columns))).astype(np.float32),
                          index=index, columns=columns)
    labels = pd.DataFrame((rng.random((n, len(columns))) < 0.3).astype(np.int64),
                          index=index, columns=columns)
    labels.iloc[:, -1] = 0  # a label without positives
    labels.iloc[0, :-1] = 1
    return logits, labels


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("number", ["1.1.1.4", "1.-.-.-", "EC:2.7.11.1", " 3.4 ", "7"])
@pytest.mark.parametrize("depth", [1, 3, 4])
def test_ec_number_to_code(number, depth):
    assert tann.ec_number_to_code(number, depth) == jann.ec_number_to_code(number, depth)


def test_ontology_slices_and_metrics():
    logits, labels = _frames(list(GO), 0)
    for term in list(GO) + ["GO:0008150", "GO:9999999"]:
        assert tan.ontology_of(term, GO) == jan.ontology_of(term, GO)
    for ontology in tan.ONTOLOGIES:
        _same(tan.filter_by_go_ontology(ontology, logits, GO),
              jan.filter_by_go_ontology(ontology, logits, GO))
    for threshold in (0.5, None):
        _same(tan.get_metrics(logits.values, labels.values, threshold),
              jan.get_metrics(logits.values, labels.values, threshold))
        _same(tan.metrics_by_go_ontology(logits, labels, GO, threshold),
              jan.metrics_by_go_ontology(logits, labels, GO, threshold))
    _same(tan.metrics_per_label_df(logits, labels, 0.5), jan.metrics_per_label_df(logits, labels, 0.5))
    _same(tan.metrics_per_label_df(logits, labels), jan.metrics_per_label_df(logits, labels))


def test_ec_slices_and_metrics():
    logits, labels = _frames(EC, 1)
    for lvl in ["All", "Oxidoreductases", "Transferases", "Ligases", "Translocases"]:
        _same(tan.filter_by_ec_level_1(lvl, logits, EC_CLASSES),
              jan.filter_by_ec_level_1(lvl, logits, EC_CLASSES))
    _same(tan.metrics_by_ec_level_1(logits, labels, EC_CLASSES, 0.5),
          jan.metrics_by_ec_level_1(logits, labels, EC_CLASSES, 0.5))


def test_blast_completion_and_replicate_statistics(tmp_path):
    blast = pd.DataFrame([[3.0, -1.0], [0.5, 2.0]], index=["S1", "S3"],
                         columns=["GO:0000002", "GO:0000004"])
    seqs, cols = ["S0", "S1", "S2", "S3"], list(GO)
    _same(tan.complete_blast_preds(blast, cols, seqs), jan.complete_blast_preds(blast, cols, seqs))
    rng = np.random.default_rng(3)
    a, b = rng.normal(0.5, 0.05, 5), rng.normal(0.45, 0.08, 5)
    _same(tan.welch_t_test(a, b), jan.welch_t_test(a, b))
    _same(tan.welch_t_test(a, a.copy()), jan.welch_t_test(a, a.copy()))
    files = {}
    for model, mu in (("protnote", 0.5), ("proteinfer", 0.45)):
        files[model] = []
        for seed in range(3):
            path = tmp_path / f"{model}_{seed}.json"
            path.write_text(json.dumps([{"run_name": f"r{seed}", "metrics": {"test": {
                "map_macro": mu + 0.01 * seed, "map_micro": mu + 0.02 * seed}}}]))
            files[model].append(str(path))
    _same(tan.aggregate_seed_replicates(files["protnote"]),
          jan.aggregate_seed_replicates(files["protnote"]))
    _same(tan.aggregate_seed_replicates(files["protnote"], ["map_micro"]),
          jan.aggregate_seed_replicates(files["protnote"], ["map_micro"]))
    _same(tan.compare_replicates(files), jan.compare_replicates(files))


@pytest.mark.parametrize("output", ["table.parquet", "table.json"])
def test_calculate_supervised_metrics_matches_jax(tmp_path, capsys, output):
    """Both CLIs on two logits files (one a glob match) and a BLAST file
    written by the port's ``save_evaluation_results``: the same table."""
    from protnote_tpu.cli import calculate_supervised_metrics as jcli
    from protnote_tpu_torch.cli import calculate_supervised_metrics as tcli
    from protnote_tpu_torch.evaln.results_io import save_evaluation_results

    logits, labels = _frames(list(GO), 4)
    for seed in (5, 6):
        other, _ = _frames(list(GO), seed)
        save_evaluation_results({"logits": other.values, "labels": labels.values,
                                 "sequence_ids": list(labels.index)},
                                list(GO), f"seed{seed}", str(tmp_path / "res"), "test")
    blast = logits.iloc[::2, :3]
    blast.to_parquet(tmp_path / "blast.parquet")
    (tmp_path / "parenthood.json").write_text(json.dumps(GO))
    labels_file = str(tmp_path / "res" / "test_labels_seed5.parquet")
    common = ["--logits", str(tmp_path / "res" / "test_logits_seed*.parquet"),
              "--labels", labels_file, "--parenthood-json", str(tmp_path / "parenthood.json"),
              "--blast", str(tmp_path / "blast.parquet")]
    want = jcli.main(common + ["--output", str(tmp_path / f"j_{output}")])
    got = tcli.main(common + ["--output", str(tmp_path / f"t_{output}")])
    capsys.readouterr()
    assert len(got) == 12  # 2 files + BLAST, 4 ontologies each
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if output.endswith(".json"):
        assert json.loads((tmp_path / f"t_{output}").read_text()) == \
            json.loads((tmp_path / f"j_{output}").read_text())
    else:
        pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / f"t_{output}"),
                                      pd.read_parquet(tmp_path / f"j_{output}"))
