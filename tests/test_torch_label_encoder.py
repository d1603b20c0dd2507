"""The port's label encoders, label-embedding CLI and the eval step's
on-the-fly text branch against the JAX package on the CPU.

A tiny tokenizer (a ``tokenizers`` WordLevel model with ``<s> .. </s>``
added, wrapped in ``PreTrainedTokenizerFast``) and a tiny random XLM-R
(2 layers, H 32, 4 heads) are built in memory and saved with
``save_pretrained``, so both packages load them through ``transformers``
with ``local_files_only``: no download.  Everything runs in float32 and is
held to 1e-5 (the `TOL` of tests/test_reference_parity.py; only summation
orders differ); the cache's ids, types, texts and token counts are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.cli import generate_label_embeddings as jcli
from protnote_tpu.data.label_cache import LabelEmbeddingCache
from protnote_tpu.models import fusion as jfu
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu.models import text_transformer as jtt
from protnote_tpu.models.label_encoder import JaxLabelEncoder
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state as jax_init_state
from protnote_tpu.train.step import make_eval_step as jax_eval_step
from protnote_tpu_torch.cli import generate_label_embeddings as tcli
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import label_encoder as tle
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models import text_transformer as ttt
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.train.step import make_eval_step

TOL = 1e-5
WORDS = ("protein binding activity of the cell membrane transport kinase regulation "
         "dna repair metabolic process ion channel nucleus receptor signaling obsolete "
         "alpha beta gamma catalytic complex").split()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A saved tokenizer + XLM-R pair, as an HF checkpoint directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast, XLMRobertaConfig, XLMRobertaModel

    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                   pad_token="<pad>", unk_token="<unk>")
    hf_cfg = XLMRobertaConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64,
                              max_position_embeddings=130, type_vocab_size=1, pad_token_id=1)
    torch.manual_seed(0)
    model = XLMRobertaModel(hf_cfg).eval()
    path = tmp_path_factory.mktemp("tiny-xlmr")
    fast.save_pretrained(str(path))
    model.save_pretrained(str(path))
    return str(path)


def _texts(n=7, seed=0):
    """Descriptions of 1-25 words; with batch 4 the last chunk is partial."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(1, 26)))) for _ in range(n)]


@pytest.mark.parametrize("pooling", ["mean", "all", "last_token"])
def test_native_encoder_matches_jax_encoder(checkpoint, pooling):
    texts = _texts()
    jenc = JaxLabelEncoder(checkpoint, pooling_method=pooling)
    tenc = tle.NativeLabelEncoder.from_pretrained(checkpoint, pooling_method=pooling,
                                                  device="cpu")
    assert tenc.cfg.dtype == torch.float32 and tenc.dim == jenc.dim == 32
    assert tenc.token_counts(texts) == jenc.token_counts(texts)
    want = jenc.embed(texts, batch_size=4)
    got = tenc.embed(texts, batch_size=4)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_native_encoder_pads_chunks_to_buckets(checkpoint, monkeypatch):
    """Each chunk goes through the tower at a bucket width with the full
    batch of rows; the filler rows (all-zero masks) are sliced off."""
    tenc = tle.NativeLabelEncoder.from_pretrained(checkpoint, device="cpu")
    shapes = []
    orig = tenc.embed_ids

    def spy(ids, mask, account_for_sos=True):
        shapes.append((ids.shape, int(mask.sum(1).min())))
        return orig(ids, mask, account_for_sos)

    monkeypatch.setattr(tenc, "embed_ids", spy)
    out = tenc.embed(_texts(5), batch_size=4)
    assert out.shape == (5, 32)
    assert [s for s, _ in shapes] == [(4, 32), (4, 32)] and shapes[1][1] == 0


def test_torch_and_hash_encoders_copy_the_jax_ones(checkpoint):
    """The HF AutoModel backend on the CPU and the hash stub give the JAX
    package's embeddings."""
    from protnote_tpu.models import label_encoder as jle

    texts = _texts(5, seed=1)
    want = jle.TorchLabelEncoder(checkpoint).embed(texts, batch_size=3)
    got = tle.TorchLabelEncoder(checkpoint, device="cpu").embed(texts, batch_size=3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(tle.HashLabelEncoder(16).embed(texts),
                                  jle.HashLabelEncoder(16).embed(texts))


def test_build_label_encoder_backends_and_fallback(checkpoint, tmp_path, caplog):
    assert isinstance(tle.build_label_encoder("hash"), tle.HashLabelEncoder)
    enc = tle.build_label_encoder(checkpoint, backend="native", device="cpu")
    assert isinstance(enc, tle.NativeLabelEncoder) and enc.checkpoint == checkpoint
    missing = str(tmp_path / "no-such-model")
    with caplog.at_level("WARNING"):
        enc = tle.build_label_encoder(missing, backend="native", device="cpu")
    assert isinstance(enc, tle.HashLabelEncoder)
    assert "using HashLabelEncoder" in caplog.text
    with pytest.raises(Exception):
        tle.build_label_encoder(missing, backend="native", device="cpu", allow_fallback=False)


def _annotations(path):
    import pandas as pd

    df = pd.DataFrame(
        {"name": ["kinase activity", "dna repair", "ion channel"],
         "label": ["catalytic kinase of the cell", "OBSOLETE. repair of dna",
                   "transport of ion in the membrane"],
         "synonym_exact": [["protein kinase"], [], ["channel activity", "ion transport"]]},
        index=["GO:0000001", "GO:0000002", "GO:0000003"])
    df.to_pickle(path)
    return str(path)


def _run_cli(cli, root, monkeypatch, argv):
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(root))
    out = cli.main(argv)
    return LabelEmbeddingCache.load(out)


@pytest.mark.parametrize("extra", [[], ["--add-instruction", "--no-account-for-sos"]])
def test_cli_native_backend_matches_jax_cli(checkpoint, tmp_path, monkeypatch, extra):
    ann = _annotations(tmp_path / "ann.pkl")
    common = ["--annotations", ann, "--encoder", checkpoint, "--batch-size", "4", *extra]
    want = _run_cli(jcli, tmp_path / "jax", monkeypatch, common + ["--backend", "jax"])
    got = _run_cli(tcli, tmp_path / "port", monkeypatch,
                   common + ["--backend", "native", "--device", "cpu"])
    assert got.embeddings.shape == want.embeddings.shape == (9, 32)
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=TOL, rtol=0)
    for field in ("ids", "description_types", "descriptions", "token_counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert "OBSOLETE" not in " ".join(got.descriptions)


def test_cli_hash_encoder_writes_the_jax_cache(tmp_path, monkeypatch):
    ann = _annotations(tmp_path / "ann.pkl")
    argv = ["--annotations", ann, "--encoder", "hash"]
    want = _run_cli(jcli, tmp_path / "jax", monkeypatch, argv)
    got = _run_cli(tcli, tmp_path / "port", monkeypatch, argv + ["--device", "cpu"])
    for field in ("embeddings", "ids", "description_types", "descriptions", "token_counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_cli_flags_default_to_the_card():
    args = tcli.build_argparser().parse_args([])
    assert args.device == "cuda" and args.backend == "torch"
    with pytest.raises(SystemExit):
        tcli.build_argparser().parse_args(["--backend", "jax"])


# ----------------------------------------------------------------------
# the eval step's on-the-fly text branch

PI = dict(input_channels=20, output_channels=24, kernel_size=3, num_resnet_blocks=1,
          num_labels=5)
PN = dict(protein_embedding_dim=24, label_embedding_dim=32, latent_dim=8,
          projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
          output_mlp_num_layers=3, output_mlp_hidden_dim_scale_factor=2, label_tile=4)
TEXT = dict(vocab_size=40, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            max_position_embeddings=40)


@pytest.mark.parametrize("with_lora", [False, True])
def test_eval_step_text_branch_matches_jax(with_lora):
    """One JAX ``init_train_state`` holding frozen ``text_params`` (and
    trainable LoRA adapters with non-zero B), scored on tokenized label text
    by the JAX ``make_eval_step(text_cfg=...)`` and by the port's."""
    jpi_cfg, tpi_cfg = jpi.ProteInferConfig(**PI), tpi.ProteInferConfig(**PI)
    jpn, tpn = jfu.ProtNoteConfig(**PN), tfu.ProtNoteConfig(**PN)
    jtext, ttext = jtt.TextEncoderConfig(**TEXT), ttt.TextEncoderConfig(**TEXT)
    pi_p, pi_s = jpi.init_proteinfer(jax.random.PRNGKey(0), jpi_cfg)
    pn_p, pn_s = jfu.init_protnote(jax.random.PRNGKey(1), jpn)
    text = jtt.init_text_encoder(jax.random.PRNGKey(2), jtext)
    lora = None
    if with_lora:
        lora = jax.tree_util.tree_map(np.asarray, jtt.init_lora(
            jax.random.PRNGKey(3), jtext, rank=2, last_n_layers=1))
        rng = np.random.default_rng(4)
        for ab in lora["1"].values():
            ab["B"] = rng.normal(0, 0.3, ab["B"].shape).astype(np.float32)
    ts = jax_init_state(pn_p, pn_s, pi_p, pi_s, make_optimizer({"OPTIMIZER": "Adam",
                                                                "LEARNING_RATE": 1e-3}),
                        text_params=text, lora_params=lora)
    rng = np.random.default_rng(5)
    B, T, L, Tl = 3, 30, 6, 9
    lengths = np.array([30, 17, 9], np.int32)
    aa = rng.integers(0, 20, size=(B, T)).astype(np.int32)
    aa[np.arange(T)[None, :] >= lengths[:, None]] = 20
    label_mask = (np.arange(Tl)[None, :] < rng.integers(2, Tl + 1, size=L)[:, None])
    label_ids = np.where(label_mask, rng.integers(3, 40, size=(L, Tl)), 1).astype(np.int32)
    batch = {"aa_ids": aa, "lengths": lengths, "example_mask": np.ones(B, np.float32),
             "label_input_ids": label_ids,
             "label_attention_mask": label_mask.astype(np.int32)}
    step = jax_eval_step(jpi_cfg, jpn, text_cfg=jtext, lora_alpha=4.0, lora_rank=2)
    want = np.asarray(step(ts, {k: jnp.asarray(v) for k, v in batch.items()})["logits"])
    tree = jax.tree_util.tree_map(np.asarray, ts)
    tree.pop("opt_state")
    port = from_jax_tree(tree)
    got = make_eval_step(tpi_cfg, tpn, text_cfg=ttext, lora_alpha=4.0, lora_rank=2)(
        port, {k: torch.from_numpy(v) for k, v in batch.items()})["logits"]
    assert got.shape == (B, L) and got.dtype == torch.float32
    assert float(np.abs(want).std()) > 0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # without text_cfg the step reads label rows as before
    rows = np.asarray(jtt.pool_hidden_states_jnp(
        jtt.text_encoder_forward(text, jnp.asarray(label_ids), jnp.asarray(batch[
            "label_attention_mask"]), jtext, lora=lora and jax.tree_util.tree_map(
                jnp.asarray, lora), lora_alpha=4.0, lora_rank=2),
        jnp.asarray(batch["label_attention_mask"]), "mean"))
    plain = dict(batch, label_embeddings=rows)
    plain.pop("label_input_ids")
    got2 = make_eval_step(tpi_cfg, tpn)(port, {k: torch.from_numpy(np.array(v))
                                               for k, v in plain.items()})["logits"]
    np.testing.assert_allclose(got2.numpy(), want, atol=TOL, rtol=0)
