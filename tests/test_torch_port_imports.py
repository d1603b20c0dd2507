"""The port stands without jax and without the JAX package: importing it (its
serving engine and CLIs included) leaves jax and every ``protnote_tpu``
module out of ``sys.modules``, no source of the port or of chip_smoke.py
imports either, and chip_smoke.py refuses to run without a CUDA card instead
of falling back to the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

import jax

from protnote_tpu_torch.models.convert import from_jax_tree, proteinfer_from_tf_pickle
from protnote_tpu_torch.models.proteinfer import ProteInferConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODULES = [
    "protnote_tpu_torch", "protnote_tpu_torch.serving", "protnote_tpu_torch.cli.serve",
    "protnote_tpu_torch.train.step", "protnote_tpu_torch.models.convert",
    "protnote_tpu_torch.ops.pair_scorer", "protnote_tpu_torch.ops.kernels",
    "protnote_tpu_torch.core.checkpoint", "protnote_tpu_torch.cli._model_setup",
    "protnote_tpu_torch.cli.main", "protnote_tpu_torch.evaln.metrics",
    "protnote_tpu_torch.ops.eval_accumulator", "protnote_tpu_torch.train.trainer",
    "protnote_tpu_torch.ops.streaming_train", "protnote_tpu_torch.train.losses",
    "protnote_tpu_torch.train.optim", "protnote_tpu_torch.serving_http",
    "protnote_tpu_torch.core.config", "protnote_tpu_torch.data.batching",
    "protnote_tpu_torch.data.dataset", "protnote_tpu_torch.data.fasta",
    "protnote_tpu_torch.data.label_cache", "protnote_tpu_torch.data.vocab",
    "protnote_tpu_torch.data.blosum",
]
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(from|import) protnote_tpu(\.|\s|$)", re.M)


def _port_sources():
    return sorted((ROOT / "protnote_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in MODULES)
            + "from protnote_tpu_torch.cli.serve import build_argparser\n"
            + "build_argparser()\n"
            + "from protnote_tpu_torch.cli import main\n"
            + "main.build_argparser().parse_args(['--test-paths-names', 'X'])\n"
            + "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_importing_the_port_loads_nothing_of_the_jax_package():
    """Every module of the port (found by walking the package, so a new one
    is covered), the CLIs' argument parsers run, and chip_smoke.py imported:
    no ``protnote_tpu`` or ``protnote_tpu.*`` entry in ``sys.modules``."""
    code = ("import importlib, pkgutil, sys\n"
            "import protnote_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(protnote_tpu_torch.__path__,"
            " 'protnote_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "from protnote_tpu_torch.cli import main, serve\n"
            "main.build_argparser().parse_args(['--test-paths-names', 'X'])\n"
            "serve.build_argparser().parse_args(['--calibration-fasta', 'x.fa'])\n"
            "import chip_smoke\n"
            "print(len(names))\n"
            "print(sorted(m for m in sys.modules if m == 'protnote_tpu'"
            " or m.startswith('protnote_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    count, loaded = out.stdout.strip().splitlines()
    assert int(count) >= len(MODULES) and loaded == "[]"


def test_no_source_of_the_port_imports_the_jax_package():
    offenders = [str(p) for p in _port_sources() if JAX_PACKAGE_IMPORT.search(p.read_text())]
    assert offenders == []
    assert JAX_PACKAGE_IMPORT.search("    from protnote_tpu.data import fasta")
    assert JAX_PACKAGE_IMPORT.search("import protnote_tpu")
    assert not JAX_PACKAGE_IMPORT.search("from protnote_tpu_torch.data import fasta")


def test_no_source_of_the_port_imports_jax():
    sources = _port_sources()
    assert len(sources) >= 10
    pattern = re.compile(r"^\s*(import jax\b|from jax\b|import flax|from flax)", re.M)
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert offenders == []


def test_chip_smoke_needs_a_card():
    """Without CUDA the smoke run exits non-zero and prints no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), cwd=ROOT,
                         timeout=120)
    if torch.cuda.is_available():  # pragma: no cover - only on the card
        return
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_from_jax_tree_drops_optimizer_state():
    """``step`` becomes an int and ``opt_state`` the port's optimizer state;
    an optax state without Adam moments (SGD's) leaves none, and the
    parameters come back as tensors."""
    import collections

    Adam = collections.namedtuple("ScaleByAdamState", "count mu nu")
    tree = {"trainable": {"protnote": {"k": np.ones((2, 3), np.float32)}},
            "model_state": {"bns": [{"mean": np.zeros(3, np.float32)}]},
            "enc_params": None, "opt_state": (np.zeros(1),), "step": np.int32(4)}
    out = from_jax_tree(tree)
    assert set(out) == {"trainable", "model_state", "enc_params", "opt_state", "step"}
    assert out["step"] == 4 and out["opt_state"] == {"count": 0, "mu": None, "nu": None}
    assert out["enc_params"] is None
    assert isinstance(out["trainable"]["protnote"]["k"], torch.Tensor)
    assert isinstance(out["model_state"]["bns"], list)
    moments = {"protnote": {"k": np.full((2, 3), 0.5, np.float32)}}
    tree["opt_state"] = ((), (Adam(np.int32(7), moments, moments), ()))
    state = from_jax_tree(tree)["opt_state"]
    assert state["count"] == 7
    torch.testing.assert_close(state["nu"]["protnote"]["k"], torch.full((2, 3), 0.5))


def test_tf_pickle_matches_jax_loader(tmp_path):
    """The port's TF-pickle reader gives the JAX reader's weights, by name
    from a scrambled pickle and positionally from an unnamed one."""
    import pickle

    from protnote_tpu.models import convert as jconvert
    from protnote_tpu.models import proteinfer as jpi

    rng = np.random.default_rng(1)
    jcfg = jpi.ProteInferConfig(input_channels=4, output_channels=8, kernel_size=3,
                                num_resnet_blocks=2, num_labels=5)
    tcfg = ProteInferConfig(input_channels=4, output_channels=8, kernel_size=3,
                            num_resnet_blocks=2, num_labels=5)
    entries = [("inferrer/conv1d/kernel:0", rng.normal(size=(3, 4, 8))),
               ("inferrer/conv1d/bias:0", rng.normal(size=8)),
               ("inferrer/dense/kernel:0", rng.normal(size=(8, 5))),
               ("inferrer/dense/bias:0", rng.normal(size=5)),
               ("inferrer/global_step:0", np.int64(7))]
    for i in range(2):
        bn1, bn2, cd, c1 = 2 * i, 2 * i + 1, 1 + 2 * i, 2 + 2 * i
        for bn, n in ((f"batch_normalization{f'_{bn1}' if bn1 else ''}", 8),
                      (f"batch_normalization_{bn2}", 4)):
            entries += [(f"inferrer/{bn}/gamma:0", rng.normal(size=n)),
                        (f"inferrer/{bn}/beta:0", rng.normal(size=n)),
                        (f"inferrer/{bn}/moving_mean:0", rng.normal(size=n)),
                        (f"inferrer/{bn}/moving_variance:0", rng.random(n) + 0.5)]
        entries += [(f"inferrer/conv1d_{cd}/kernel:0", rng.normal(size=(3, 8, 4))),
                    (f"inferrer/conv1d_{cd}/bias:0", rng.normal(size=4)),
                    (f"inferrer/conv1d_{c1}/kernel:0", rng.normal(size=(1, 4, 8))),
                    (f"inferrer/conv1d_{c1}/bias:0", rng.normal(size=8))]
    keys = [k for k, _ in entries]
    rng.shuffle(keys)
    d = dict(entries)
    path = tmp_path / "w.pkl"
    with open(path, "wb") as fh:
        pickle.dump({k: d[k] for k in keys}, fh)
    jp, js = jconvert.proteinfer_from_tf_pickle(str(path), jcfg)
    want = from_jax_tree({"p": jax.tree_util.tree_map(np.asarray, jp),
                          "s": jax.tree_util.tree_map(np.asarray, js)})
    tp, ts = proteinfer_from_tf_pickle(str(path), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves((want["p"], want["s"])),
                    jax.tree_util.tree_leaves((tp, ts))):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    # unnamed arrays in slot order load positionally
    values = [np.asarray(c[k]) for c, k, _ in jconvert._proteinfer_slots(jp, js)]
    pos = tmp_path / "pos.pkl"
    with open(pos, "wb") as fh:
        pickle.dump({f"v{i}": v for i, v in enumerate(values)}, fh)
    tp2, ts2 = proteinfer_from_tf_pickle(str(pos), tcfg)
    for a, b in zip(jax.tree_util.tree_leaves((tp, ts)),
                    jax.tree_util.tree_leaves((tp2, ts2))):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
