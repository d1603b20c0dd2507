"""Training the label text tower through the port's CLI
(``LABEL_ENCODER_NUM_TRAINABLE_LAYERS``) against the JAX ``cli.main.run``
on the CPU, and the checkpoints of such runs read both ways.

A tiny tokenizer (a ``tokenizers`` WordLevel model wrapped in
``PreTrainedTokenizerFast``) and two tiny random towers (2 layers, H 32, 4
heads), an XLM-R and a BioGPT, are saved with ``save_pretrained`` and named
by ``LABEL_ENCODER_CHECKPOINT``, as in tests/test_torch_label_encoder.py;
both CLIs read them with ``local_files_only``.  ``LORA True`` trains the
XLM-R's adapters, ``LORA False`` the BioGPT's last layer under the
trainable mask.  The mask path runs on the pre-LN BioGPT because in the
post-LN XLM-R the last layer ends in a LayerNorm whose bias shifts every
label embedding alike: the BatchNorm of the W_l head takes that shift out
in training, so its gradient is zero in exact arithmetic, Adam turns each
side's float32 noise there into steps of up to the learning rate, and the
eval-mode BatchNorm (running statistics) does not take the two different
shifts out (a probe on this fixture: validation loss 0.3096 against 0.3071
after one epoch, with training losses equal to 3e-7).  The toy data is that of
tests/test_torch_train_cli.py (a small encoder through a patched
``load_config``), with 6 labels whose descriptions are made of the
tokenizer's words and a 32-wide label cache (the tower's width).  Both CLIs
start from one JAX ``init_train_state`` with the tower (and, with ``LORA``,
its adapters) saved by the JAX ``save_checkpoint`` (``--model-file``), and
train 2 epochs in float32 with validation and a test set.

Tolerances: those of tests/test_torch_train_cli.py (losses 1e-5, the other
metrics 1e-6; the trainable trees and Adam moments of the last checkpoints
1e-5 absolute and 1e-4 relative), except for the leaves whose gradient is
zero in exact arithmetic (the key bias: a softmax does not see a constant
added to a row of scores, in training or in evaluation): Adam turns their
float32 noise into steps of up to the learning rate, so both sides' values
stay within 6 steps x LEARNING_RATE of the start.
"""

import numpy as np
import pytest
import torch

import jax

AAS = "ACDEFGHIKLMNPQRSTVWY"
NUM_LABELS = 6
WORDS = ("protein binding activity of the cell membrane transport kinase regulation "
         "dna repair metabolic process ion channel nucleus receptor signaling obsolete "
         "alpha beta gamma catalytic complex").split()
LR = 0.003
OVERRIDES = [
    "NUM_EPOCHS", "2", "TRAIN_BATCH_SIZE", "8", "VALIDATION_BATCH_SIZE", "8",
    "TEST_BATCH_SIZE", "8", "SEQUENCE_BUCKETS", "[128]",
    "EXTRACT_VOCABULARIES_FROM", "null",
    "PROTEIN_EMBEDDING_DIM", "48", "LABEL_EMBEDDING_DIM", "32",
    "LATENT_EMBEDDING_DIM", "16", "PROJECTION_HEAD_NUM_LAYERS", "2",
    "OUTPUT_MLP_NUM_LAYERS", "2", "OUTPUT_MLP_HIDDEN_DIM_SCALE_FACTOR", "2",
    "PROJECTION_HEAD_HIDDEN_DIM_SCALE_FACTOR", "2",
    "MIXED_PRECISION", "False", "ESTIMATE_MAP", "True", "DECISION_TH", "0.5",
    "LABEL_EMBEDDING_NOISING_ALPHA", "0", "LEARNING_RATE", str(LR),
    "LABEL_ENCODER_NUM_TRAINABLE_LAYERS", "1", "LORA_RANK", "2", "LORA_ALPHA", "4",
]
RATES = ("seqs_per_sec", "pairs_per_sec")
TOWERS = {True: "tiny-xlmr", False: "tiny-biogpt"}  # by LORA


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """FASTA splits, a label cache of word descriptions, and the tiny HF
    checkpoint."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import (
        BioGptConfig,
        BioGptModel,
        PreTrainedTokenizerFast,
        XLMRobertaConfig,
        XLMRobertaModel,
    )

    from protnote_tpu.data.fasta import save_to_fasta
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.models.label_encoder import HashLabelEncoder

    root = tmp_path_factory.mktemp("toy_tower")
    data_dir = root / "data"
    split_dir = data_dir / "swissprot" / "proteinfer_splits" / "random"
    split_dir.mkdir(parents=True)
    (data_dir / "embeddings").mkdir(parents=True)
    (root / "outputs").mkdir()
    rng = np.random.default_rng(0)
    labels_all = [f"GO:{i:07d}" for i in range(NUM_LABELS)]
    for name, n in (("train_GO.fasta", 24), ("dev_GO.fasta", 8), ("test_GO.fasta", 8)):
        recs = []
        for i in range(n):
            seq = "".join(rng.choice(list(AAS), int(rng.integers(20, 120))))
            labs = list(rng.choice(labels_all, size=int(rng.integers(1, 3)), replace=False))
            recs.append((seq, f"{name}{i}", labs))
        save_to_fasta(recs, str(split_dir / name))
    ids, dtypes, texts = [], [], []
    for g in labels_all:
        for dt in ("name", "label"):
            ids.append(g)
            dtypes.append(dt)
            texts.append(" ".join(rng.choice(WORDS, int(rng.integers(2, 12)))))
    enc = HashLabelEncoder(dim=32)
    for tower in TOWERS.values():  # named after LABEL_ENCODER_CHECKPOINT's nickname
        LabelEmbeddingCache.save(
            str(data_dir / "embeddings" / _cache_name(tower)), enc.embed(texts), ids, dtypes,
            texts, enc.token_counts(texts))

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   pad_token="<pad>", unk_token="<unk>")
    small = dict(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64, pad_token_id=1)
    torch.manual_seed(0)
    models_ = {
        "tiny-xlmr": XLMRobertaModel(XLMRobertaConfig(**small, max_position_embeddings=130,
                                                      type_vocab_size=1)),
        "tiny-biogpt": BioGptModel(BioGptConfig(**small, max_position_embeddings=130,
                                                scale_embedding=True)),
    }
    for name, model in models_.items():
        fast.save_pretrained(str(root / name))
        model.eval().save_pretrained(str(root / name))
    return root


def _cache_name(tower):
    from protnote_tpu_torch.core.config import encoder_nickname

    return f"frozen_label_embeddings_{encoder_nickname(tower)}_mean.npz"


@pytest.fixture()
def env(toy, monkeypatch):
    from protnote_tpu.core import config as cfgmod
    from protnote_tpu_torch.core import config as tcfgmod

    root = toy
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(root / "data"))
    monkeypatch.setenv("PROTNOTE_OUTPUT_DIR", str(root / "outputs"))
    for mod in (cfgmod, tcfgmod):
        monkeypatch.setattr(mod, "load_config", _small_loader(mod.load_config))
    return toy


def _small_loader(orig_load):
    def load_small(path):
        cfg = orig_load(path)
        cfg["embed_sequences_params"].update(
            OUTPUT_CHANNELS=48, KERNEL_SIZE=5, NUM_RESNET_BLOCKS=1,
            PROTEINFER_NUM_GO_LABELS=NUM_LABELS)
        return cfg

    return load_small


def _overrides(hf_dir, lora):
    return OVERRIDES + ["LABEL_ENCODER_CHECKPOINT", hf_dir, "LORA", str(lora)]


def _jax_start(params, hf_dir, lora):
    """The JAX CLI's train state with the tower (the JaxLabelEncoder's
    weights) and its optimizer: ``(ts, tx)``."""
    from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
    from protnote_tpu.models.label_encoder import JaxLabelEncoder
    from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
    from protnote_tpu.models.text_transformer import init_lora, trainable_mask
    from protnote_tpu.train.optim import make_optimizer
    from protnote_tpu.train.step import init_train_state

    pi = ProteInferConfig(input_channels=20, output_channels=48, kernel_size=5,
                          num_resnet_blocks=1, num_labels=NUM_LABELS)
    pn = ProtNoteConfig.from_params(params, protein_embedding_dim=48, label_embedding_dim=32,
                                    inference_descriptions_per_label=2)
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(3), pi)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(4), pn)
    pn_p["output_mlp"] = jax.tree_util.tree_map(lambda x: x * 4.0, pn_p["output_mlp"])
    enc = JaxLabelEncoder(hf_dir)
    text = jax.tree_util.tree_map(np.asarray, enc.params)
    if lora:
        adapters = init_lora(jax.random.PRNGKey(7), enc.cfg, rank=2, last_n_layers=1)
        tx = make_optimizer(params)
        return init_train_state(pn_p, pn_s, pi_p, pi_s, tx, text_params=text,
                                lora_params=adapters), tx
    mask = {"protnote": jax.tree_util.tree_map(lambda _: True, pn_p),
            "text": trainable_mask(text, enc.cfg, 1)}
    tx = make_optimizer(params, trainable_mask=mask)
    return init_train_state(pn_p, pn_s, pi_p, pi_s, tx, text_params=text,
                            train_label_encoder=True), tx


def _run(module, name, extra, overrides):
    args = module.build_argparser().parse_args(
        ["--name", name, *extra, "--override", *overrides])
    return module.run(args)


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], (int, float)) and not k.endswith(RATES):
            assert np.isfinite(got[k]), k
            tol = 1e-5 if k.endswith("loss") else 1e-6
            assert got[k] == pytest.approx(want[k], abs=tol, rel=0), k


def _zero_gradient(path):
    return path.endswith("['k']['bias']")


def _assert_state_close(got, want, start):
    """``trainable``, ``text_params`` and ``opt_state`` leaf by leaf (JAX
    trees): 1e-5 absolute and 1e-4 relative, the zero-gradient leaves within
    6 Adam steps of their start."""
    for key in ("trainable", "text_params", "opt_state"):
        flat = jax.tree_util.tree_flatten_with_path(want[key])[0]
        a = jax.tree_util.tree_leaves(got[key])
        s0 = jax.tree_util.tree_leaves(start[key])
        assert len(a) == len(flat), key
        if key == "opt_state":
            s0 = [None] * len(a)
        for (path, y), x, x0 in zip(flat, a, s0):
            path = key + jax.tree_util.keystr(path)
            x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
            if key == "trainable" and _zero_gradient(path):
                bound = 6 * LR * (1 + 1e-3)
                assert np.abs(x - x0).max() <= bound and np.abs(y - x0).max() <= bound, path
                continue
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("lora", [True, False])
def test_tower_training_matches_jax_cli(env, lora):
    """2 epochs with the last layer of the tower trainable (``LORA True``:
    the XLM-R's adapters; ``LORA False``: the whole BioGPT under the
    trainable mask, its last layer updated):
    histories and test metrics agree; the last checkpoints hold the text
    (or LoRA) trees and the masked optimizer state, and each side reads the
    other's: the port's in the JAX ``restore_checkpoint``, the JAX one in
    the port's ``load_model_file``."""
    import protnote_tpu.cli.main as jmain
    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu.core.checkpoint import restore_checkpoint, save_checkpoint
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH, load_config, override_config
    from protnote_tpu_torch.cli._model_setup import load_model_file
    from protnote_tpu_torch.models.convert import from_jax_tree, to_jax_tree
    from protnote_tpu_torch.models.text_transformer import trainable_mask
    from protnote_tpu_torch.train.optim import Optimizer, tree_map

    root = env
    hf_dir = str(root / TOWERS[lora])
    overrides = _overrides(hf_dir, lora)
    params = override_config(load_config(DEFAULT_CONFIG_PATH), overrides)["params"]
    start, _ = _jax_start(params, hf_dir, lora)
    ckpt = root / "outputs" / f"start_lora{lora}.ckpt"
    save_checkpoint(str(ckpt), start, epoch=0)
    roles = ["--train-path-name", "TRAIN_DATA_PATH", "--validation-path-name",
             "VAL_DATA_PATH", "--test-paths-names", "TEST_DATA_PATH", "--model-file", str(ckpt)]
    tag = f"lora{lora}"
    want = _run(jmain, f"jax{tag}", roles, overrides)
    got = _run(tmain, f"port{tag}", roles + ["--device", "cpu"], overrides)
    assert len(got["train_summary"]["history"]) == len(want["train_summary"]["history"]) == 2
    for g, w in zip(got["train_summary"]["history"], want["train_summary"]["history"]):
        _assert_metrics_close(g, w)
    _assert_metrics_close(got["test"], want["test"])

    out = root / "outputs" / "checkpoints"
    paths = {side: str(next(out.glob(f"*_{side}{tag}_last_epoch.ckpt")))
             for side in ("port", "jax")}
    template, _ = _jax_start(params, hf_dir, lora)
    trees = {side: jax.tree_util.tree_map(np.asarray, restore_checkpoint(p, template)[0])
             for side, p in paths.items()}
    assert int(trees["port"]["step"]) == int(trees["jax"]["step"]) == 6
    start_np = jax.tree_util.tree_map(np.asarray, start)
    assert ("lora" in trees["port"]["trainable"]) == lora
    assert ("text" in trees["port"]["trainable"]) == (not lora)
    _assert_state_close(trees["port"], trees["jax"], start_np)

    # the JAX checkpoint into the port's template, and out again
    port_ts = from_jax_tree(start_np)
    mask = None
    if not lora:
        mask = {"protnote": tree_map(lambda _: True, port_ts["trainable"]["protnote"]),
                "text": trainable_mask(port_ts["trainable"]["text"],
                                       _port_text_cfg(hf_dir), 1)}
    opt = Optimizer(params, trainable_mask=mask)
    loaded, meta = load_model_file(port_ts, paths["jax"], None, None, opt)
    assert meta["epoch"] == 1 and loaded["step"] == 6
    back = jax.tree_util.tree_map(np.asarray, restore_checkpoint(
        _write(root / "outputs" / f"roundtrip_{tag}.ckpt", to_jax_tree(loaded, opt)),
        template)[0])
    for key in ("trainable", "text_params", "opt_state"):
        for x, y in zip(jax.tree_util.tree_leaves(back[key]),
                        jax.tree_util.tree_leaves(trees["jax"][key])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _port_text_cfg(hf_dir):
    from protnote_tpu_torch.models.label_encoder import load_pretrained_tower

    return load_pretrained_tower(hf_dir)[0]


def _write(path, tree):
    from protnote_tpu_torch.core.checkpoint import save_checkpoint

    save_checkpoint(str(path), tree, epoch=1)
    return str(path)


def test_tower_cli_refuses_float32_on_the_card(env, monkeypatch):
    """The tower's kernels once took bfloat16 only, and a CUDA device with
    ``MIXED_PRECISION False`` was refused.  They take float32 now: on
    ``cuda`` the tower keeps ``load_pretrained_tower``'s float32 (as the JAX
    CLI trains it), and computes in bfloat16 under ``MIXED_PRECISION``
    (nothing is put on the card while the tower is built); a checkpoint that
    is not there locally exits as in the JAX CLI; on the CPU the tower
    computes in float32, the descriptions tokenized."""
    import protnote_tpu_torch.cli.main as tmain
    from protnote_tpu_torch.data.label_cache import LabelEmbeddingCache

    root = env
    hf_dir = str(root / TOWERS[True])
    cache = LabelEmbeddingCache.load(str(root / "data" / "embeddings" / _cache_name(TOWERS[True])))
    params = {"LABEL_ENCODER_NUM_TRAINABLE_LAYERS": 1, "LABEL_ENCODER_CHECKPOINT": hf_dir,
              "MIXED_PRECISION": False, "LORA": True}
    text_cfg, _, lora, (ids, _), _ = tmain.build_label_tower(params, cache, {},
                                                            torch.device("cuda"), 0)
    assert text_cfg.dtype == torch.float32 and set(lora) == {"1"}
    assert ids.shape[0] == len(cache.descriptions)
    text_cfg = tmain.build_label_tower(dict(params, MIXED_PRECISION=True), cache, {},
                                       torch.device("cuda"), 0)[0]
    assert text_cfg.dtype == torch.bfloat16
    with pytest.raises(SystemExit, match="weights locally"):  # as the JAX CLI exits
        tmain.build_label_tower(dict(params, LABEL_ENCODER_CHECKPOINT=str(root / "missing")),
                                cache, {}, torch.device("cpu"), 0)
    text_cfg, text, lora, (ids, attn), mask = tmain.build_label_tower(
        dict(params, MIXED_PRECISION=True), cache, {}, torch.device("cpu"), 0)
    assert text_cfg.dtype == torch.float32 and mask is None and set(lora) == {"1"}
    assert ids.shape == attn.shape and ids.shape[0] == len(cache.descriptions)
    assert ids.dtype == np.int32 and attn.sum(1).min() >= 3  # <s> word </s>
