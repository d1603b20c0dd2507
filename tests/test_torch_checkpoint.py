"""Weights into the port: the PNTPU1 checkpoint reader
(protnote_tpu_torch/core/checkpoint.py) against the JAX ``save_checkpoint``
and ``restore_checkpoint``, the reference ``.pt`` loader
(protnote_tpu_torch/models/convert.py) against the JAX one, and
``--model-file`` in the port's serve CLI.

Every comparison is exact (rtol = atol = 0): reading a checkpoint moves
bits, it computes nothing.
"""

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from protnote_tpu.core.checkpoint import restore_checkpoint as jax_restore
from protnote_tpu.core.checkpoint import save_checkpoint
from protnote_tpu.models import convert as jconvert
from protnote_tpu.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state
from protnote_tpu_torch.core import checkpoint as tckpt
from protnote_tpu_torch.models import convert as tconvert
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree

PI = dict(input_channels=20, output_channels=12, kernel_size=3, num_resnet_blocks=2,
          num_labels=5)
PN = dict(protein_embedding_dim=12, label_embedding_dim=10, latent_dim=6,
          projection_head_num_layers=3, projection_head_hidden_dim_scale_factor=2,
          output_mlp_num_layers=3, output_mlp_hidden_dim_scale_factor=2)


def _jax_state(bf16_leaves=False):
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(0), ProteInferConfig(**PI))
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(1), ProtNoteConfig(**PN))
    if bf16_leaves:
        pn_p["W_p"]["layers"][0]["kernel"] = pn_p["W_p"]["layers"][0]["kernel"].astype(
            jnp.bfloat16)
        pi_p["blocks"][1]["conv_dilated"]["kernel"] = (
            pi_p["blocks"][1]["conv_dilated"]["kernel"].astype(jnp.bfloat16))
    return init_train_state(pn_p, pn_s, pi_p, pi_s,
                            make_optimizer({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3}))


def _port_template():
    gen = torch.Generator().manual_seed(9)
    pi_p, pi_s = tpi.init_proteinfer(gen, tpi.ProteInferConfig(**PI))
    pn_p, pn_s = tfu.init_protnote(gen, tfu.ProtNoteConfig(**PN))
    return {"trainable": {"protnote": pn_p}, "model_state": pn_s,
            "enc_params": pi_p, "enc_state": pi_s}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) and len(g) > 10
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_raw_read_is_bit_equal_with_bf16_leaves(tmp_path):
    ts = _jax_state(bf16_leaves=True)
    path = str(tmp_path / "run.ckpt")
    save_checkpoint(path, ts, epoch=2, best_val_metric=0.5, extra={"note": "x"})
    stored, meta = tckpt.read_checkpoint(path)
    assert meta["epoch"] == 2 and meta["best_val_metric"] == 0.5 and meta["note"] == "x"
    saved = jax.tree_util.tree_map(np.asarray, ts)
    kern = stored["trainable"]["protnote"]["W_p"]["layers"]["0"]["kernel"]
    want = saved["trainable"]["protnote"]["W_p"]["layers"][0]["kernel"]
    assert isinstance(kern, tckpt._BF16Array)
    np.testing.assert_array_equal(kern.bits, want.view(np.uint16))
    t = kern.to_tensor()
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.uint16).numpy(), want.view(np.uint16))
    # an f32 leaf and the optimizer's int32 step counter, decoded and kept raw
    np.testing.assert_array_equal(
        stored["enc_state"]["blocks"]["1"]["bn2"]["var"],
        saved["enc_state"]["blocks"][1]["bn2"]["var"])
    assert int(stored["step"]) == 0 and stored["text_params"] is None
    assert "opt_state" in stored


@pytest.mark.parametrize("bf16_leaves", [False, True])
def test_restore_matches_jax_restore(tmp_path, bf16_leaves):
    """Into f32 templates on both sides: the port's tree equals the JAX
    restore (conv kernels in the port's layout), optimizer state dropped."""
    path = str(tmp_path / "run.ckpt")
    save_checkpoint(path, _jax_state(bf16_leaves), epoch=1)
    jts, jmeta = jax_restore(path, _jax_state())
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    for k in ("text_params", "opt_state", "step"):  # not in the eval template
        want.pop(k)
    got, meta = tckpt.restore_checkpoint(path, _port_template())
    assert meta == jmeta
    _assert_trees_equal(got, want)


def test_corrupt_files_raise(tmp_path):
    path = tmp_path / "run.ckpt"
    save_checkpoint(str(path), _jax_state(), epoch=0)
    data = path.read_bytes()
    bad_magic = tmp_path / "magic.ckpt"
    bad_magic.write_bytes(b"PNTPU9\n" + data[7:])
    with pytest.raises(ValueError, match="not a protnote_tpu checkpoint"):
        tckpt.read_checkpoint(str(bad_magic))
    flipped = bytearray(data)
    flipped[-100] ^= 0xFF
    bad_crc = tmp_path / "crc.ckpt"
    bad_crc.write_bytes(bytes(flipped))
    with pytest.raises(ValueError, match="checksum"):
        tckpt.read_checkpoint(str(bad_crc))
    for cut in (len(data) - 1000, 40, 12):
        short = tmp_path / f"short{cut}.ckpt"
        short.write_bytes(data[:cut])
        with pytest.raises(ValueError):
            tckpt.read_checkpoint(str(short))
    # a shape that does not fit the template
    tmpl = _port_template()
    tmpl["model_state"]["W_p"]["bns"][0]["mean"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(str(path), tmpl)
    # a template whose encoder is trainable (enc_params None) against a
    # checkpoint with a frozen encoder
    tmpl = _port_template()
    tmpl["trainable"]["encoder"], tmpl["enc_params"] = tmpl["enc_params"], None
    with pytest.raises(ValueError, match="structure mismatch at '/enc_params'"):
        tckpt.restore_checkpoint(str(path), tmpl)


def test_msgpack_subset_matches_msgpack_package():
    """The decoder against the msgpack package on every type byte flax can
    write (fix/8/16/32-bit sizes, ints of every width, floats, ext)."""
    msgpack = pytest.importorskip("msgpack")
    obj = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128,
                    -129, -32768, -32769, -2**31 - 1, 2**63 - 1, -2**63],
           "floats": [1.5, -0.25, 1e300], "nil": None, "bools": [True, False],
           "str": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, "héllo"],
           "bin": [b"", b"\x00" * 300, b"\x01" * 70000],
           "big_list": list(range(20)), "huge_list": list(range(70000)),
           "big_map": {str(i): i for i in range(20)},
           "huge_map": {str(i): i for i in range(70000)}}
    packed = msgpack.packb(obj, use_bin_type=True)
    assert tckpt.msgpack_unpack(packed) == msgpack.unpackb(packed, raw=False)
    packed32 = msgpack.packb([1.25], use_single_float=True)
    assert tckpt.msgpack_unpack(packed32) == [1.25]
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):
        ext = msgpack.packb(msgpack.ExtType(5, b"\x07" * n))
        with pytest.raises(ValueError, match="ext type 5"):
            tckpt.msgpack_unpack(ext)
    with pytest.raises(ValueError, match="0xc1"):
        tckpt.msgpack_unpack(b"\xc1")


def _torch_proteinfer_sd(g):
    c, cb, k = PI["output_channels"], PI["output_channels"] // 2, PI["kernel_size"]
    sd = {"conv1.weight": torch.randn(c, PI["input_channels"], k, generator=g),
          "conv1.bias": torch.randn(c, generator=g)}
    for i in range(PI["num_resnet_blocks"]):
        p = f"resnet_blocks.{i}"
        for j, n in ((1, c), (2, cb)):
            bn = f"{p}.bn_activation_{j}.0"
            sd[f"{bn}.weight"] = torch.randn(n, generator=g)
            sd[f"{bn}.bias"] = torch.randn(n, generator=g)
            sd[f"{bn}.running_mean"] = torch.randn(n, generator=g)
            sd[f"{bn}.running_var"] = torch.rand(n, generator=g) + 0.5
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(7)
        sd[f"{p}.masked_conv1.weight"] = torch.randn(cb, c, k, generator=g)
        sd[f"{p}.masked_conv1.bias"] = torch.randn(cb, generator=g)
        sd[f"{p}.masked_conv2.weight"] = torch.randn(c, cb, 1, generator=g)
        sd[f"{p}.masked_conv2.bias"] = torch.randn(c, generator=g)
    sd["output_layer.weight"] = torch.randn(PI["num_labels"], c, generator=g)
    sd["output_layer.bias"] = torch.randn(PI["num_labels"], generator=g)
    return sd


def _torch_protnote_sd(g):
    """Reference names: torchvision-MLP Sequential indices for W_p/W_l and
    get_mlp indices for output_layer (as tests/test_convert.py builds them)."""
    cfg = ProtNoteConfig(**PN)
    sd = {}

    def bn(prefix, h):
        sd[f"{prefix}.weight"] = torch.randn(h, generator=g)
        sd[f"{prefix}.bias"] = torch.randn(h, generator=g)
        sd[f"{prefix}.running_mean"] = torch.randn(h, generator=g)
        sd[f"{prefix}.running_var"] = torch.rand(h, generator=g) + 0.5
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(3)

    for head, d in (("W_p", cfg.protein_embedding_dim), ("W_l", cfg.label_embedding_dim)):
        hidden = [cfg.latent_dim * cfg.projection_head_hidden_dim_scale_factor] * (
            cfg.projection_head_num_layers - 1) + [cfg.latent_dim]
        idx = 0
        for li, h in enumerate(hidden):
            sd[f"{head}.{idx}.weight"] = torch.randn(h, d, generator=g)
            idx += 1
            if li < len(hidden) - 1:
                bn(f"{head}.{idx}", h)
                idx += 3  # BN, ReLU, Dropout
            else:
                idx += 1  # trailing Dropout
            d = h
    H, idx, d = cfg.output_mlp_hidden_dim, 0, cfg.joint_dim
    for li in range(cfg.output_mlp_num_layers):
        sd[f"output_layer.{idx}.weight"] = torch.randn(H, d, generator=g)
        bn(f"output_layer.{idx + 1}", H)
        idx += 3 + (li < cfg.output_mlp_num_layers - 1)  # BN, ReLU (+ Dropout)
        d = H
    sd[f"output_layer.{idx}.weight"] = torch.randn(1, H, generator=g)
    sd[f"output_layer.{idx}.bias"] = torch.randn(1, generator=g)
    return sd


@pytest.mark.parametrize("ddp", [False, True])
def test_reference_pt_matches_jax_loader(tmp_path, ddp):
    g = torch.Generator().manual_seed(5)
    sd = _torch_protnote_sd(g)
    sd.update({f"sequence_encoder.{k}": v for k, v in _torch_proteinfer_sd(g).items()})
    if ddp:
        sd = {f"module.{k}": v for k, v in sd.items()}
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd, "epoch": 7, "best_val_metric": 0.3}, path)
    jp, js, jenc, jmeta = jconvert.load_reference_checkpoint(
        path, ProtNoteConfig(**PN), ProteInferConfig(**PI))
    want = from_jax_tree(jax.tree_util.tree_map(
        np.asarray, {"p": jp, "s": js, "ep": jenc[0], "es": jenc[1]}))
    tp, ts, tenc, tmeta = tconvert.load_reference_checkpoint(
        path, tfu.ProtNoteConfig(**PN), tpi.ProteInferConfig(**PI))
    assert tmeta == jmeta == {"epoch": 7, "best_val_metric": 0.3}
    _assert_trees_equal({"p": tp, "s": ts, "ep": tenc[0], "es": tenc[1]}, want)
    # through --model-file: the embedded encoder replaces enc_params
    from protnote_tpu_torch.cli._model_setup import load_model_file

    bundle, meta = load_model_file(_port_template(), path, tpi.ProteInferConfig(**PI),
                                   tfu.ProtNoteConfig(**PN))
    assert meta == tmeta
    _assert_trees_equal({"p": bundle["trainable"]["protnote"], "s": bundle["model_state"],
                         "ep": bundle["enc_params"], "es": bundle["enc_state"]}, want)
    # a missing batchnorm is an error, not a silent random init
    short = {k: v for k, v in sd.items() if ".W_l.1." not in f".{k}"}
    with pytest.raises(ValueError, match="batchnorms"):
        tconvert.protnote_from_torch_state_dict(short, tfu.ProtNoteConfig(**PN))


L, K, D = 7, 2, 16
SMALL_PI = dict(OUTPUT_CHANNELS=24, KERNEL_SIZE=5, NUM_RESNET_BLOCKS=1,
                PROTEINFER_NUM_GO_LABELS=L)


def test_serve_cli_loads_model_file(tmp_path, monkeypatch, rng):
    """``cli/serve.build_engine --model-file run.ckpt`` scores with the
    checkpoint's weights: the same probabilities as the JAX engine on the
    tree that was saved (float32, 2e-3 as in tests/test_torch_serving.py:
    both engines read logits back in float16)."""
    from protnote_tpu.core.config import DEFAULT_CONFIG_PATH
    from protnote_tpu.data.label_cache import LabelEmbeddingCache
    from protnote_tpu.serving import ServingEngine as JaxEngine
    from protnote_tpu_torch.cli import serve as tserve

    with open(DEFAULT_CONFIG_PATH) as fh:
        cfg = yaml.safe_load(fh)
    cfg["embed_sequences_params"].update(SMALL_PI)
    cfg["params"].update(LATENT_EMBEDDING_DIM=8, PROJECTION_HEAD_NUM_LAYERS=2,
                         OUTPUT_MLP_NUM_LAYERS=2, SEQUENCE_BUCKETS=[32, 64])
    cfg_path = tmp_path / "small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    emb_dir = tmp_path / "embeddings"
    emb_dir.mkdir()
    matrix = rng.normal(size=(L * K, D)).astype(np.float32)
    LabelEmbeddingCache.save(
        str(emb_dir / "frozen_label_embeddings_E5multilingual_mean.npz"), matrix,
        [f"GO:{i:07d}" for i in range(L) for _ in range(K)], ["name", "label"] * L,
        ["d"] * (L * K), [3] * (L * K))
    monkeypatch.setenv("PROTNOTE_DATA_DIR", str(tmp_path))

    params = dict(cfg["params"], MIXED_PRECISION=False)
    jpi = ProteInferConfig(input_channels=20, output_channels=24, kernel_size=5,
                           num_resnet_blocks=1, num_labels=L)
    jpn = ProtNoteConfig.from_params(params, protein_embedding_dim=24,
                                     label_embedding_dim=D,
                                     inference_descriptions_per_label=K)
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(11), jpi)
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(12), jpn)
    ts = init_train_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(params))
    ckpt = str(tmp_path / "run.ckpt")
    save_checkpoint(ckpt, ts, epoch=0)

    args = tserve.build_argparser().parse_args(
        ["--config", str(cfg_path), "--device", "cpu", "--max-batch", "2",
         "--model-file", ckpt, "--override", "MIXED_PRECISION", "False"])
    engine, _ = tserve.build_engine(args)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) for n in (9, 30, 50)]
    want = JaxEngine(ts, jpi, jpn, matrix, [f"GO:{i:07d}" for i in range(L)],
                     buckets=(32, 64), max_batch=2).score(seqs)
    np.testing.assert_allclose(engine.score(seqs), want, atol=2e-3, rtol=0)
    # the checkpoint's weights, not the seeded init
    got = engine.ts["trainable"]["protnote"]["W_l"]["layers"][0]["kernel"].numpy()
    np.testing.assert_array_equal(got, np.asarray(pn_p["W_l"]["layers"][0]["kernel"]))


def _jax_encoder_state():
    """A JAX state that trains the encoder (``trainable["encoder"]``,
    ``enc_params`` None) with nonzero Adam moments and step."""
    pi_p, pi_s = init_proteinfer(jax.random.PRNGKey(0), ProteInferConfig(**PI))
    pn_p, pn_s = init_protnote(jax.random.PRNGKey(1), ProtNoteConfig(**PN))
    pi_s = jax.tree_util.tree_map(lambda x: x + 0.125, pi_s)  # trained running statistics
    ts = init_train_state(pn_p, pn_s, pi_p, pi_s,
                          make_optimizer({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3}),
                          train_sequence_encoder=True)
    rng = np.random.default_rng(3)

    def moved(x):
        x = np.asarray(x)
        if x.dtype == np.float32:
            return x + rng.uniform(0.01, 0.1, x.shape).astype(np.float32)
        return x + 3
    return dict(jax.tree_util.tree_map(moved, ts))


def _port_encoder_template():
    from protnote_tpu_torch.train.optim import Optimizer
    from protnote_tpu_torch.train.step import init_train_state as port_init

    gen = torch.Generator().manual_seed(9)
    pi_p, pi_s = tpi.init_proteinfer(gen, tpi.ProteInferConfig(**PI))
    pn_p, pn_s = tfu.init_protnote(gen, tfu.ProtNoteConfig(**PN))
    opt = Optimizer({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3})
    return port_init(pn_p, pn_s, pi_p, pi_s, opt, train_sequence_encoder=True), opt


def test_encoder_checkpoint_reads_and_writes_both_ways(tmp_path):
    """A checkpoint of a run that trains the encoder: the JAX one read by the
    port's ``load_model_file`` (encoder weights, running statistics, Adam
    moments and step, ``enc_params`` None) equals ``from_jax_tree`` of the
    JAX restore; the port's written back by ``save_checkpoint`` restores in
    JAX to the original."""
    from protnote_tpu_torch.cli._model_setup import load_model_file

    ts = _jax_encoder_state()
    path = str(tmp_path / "jax.ckpt")
    save_checkpoint(path, ts, epoch=1)
    jts, _ = jax_restore(path, dict(init_train_state(
        *init_protnote(jax.random.PRNGKey(5), ProtNoteConfig(**PN)),
        *init_proteinfer(jax.random.PRNGKey(6), ProteInferConfig(**PI)),
        make_optimizer({"OPTIMIZER": "Adam", "LEARNING_RATE": 1e-3}),
        train_sequence_encoder=True)))
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    template, opt = _port_encoder_template()
    got, _ = load_model_file(template, path, None, None, opt)
    assert got["enc_params"] is None and want["enc_params"] is None
    assert got["step"] == want["step"] == 3
    keys = ("trainable", "enc_state", "model_state")
    _assert_trees_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})
    for key in ("mu", "nu"):
        _assert_trees_equal(got["opt_state"][key], want["opt_state"][key])
    assert got["opt_state"]["count"] == want["opt_state"]["count"]
    assert float(got["opt_state"]["mu"]["encoder"]["conv1"]["kernel"].abs().min()) > 0

    back = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(back, tconvert.to_jax_tree(got, opt), epoch=1)
    again, _ = jax_restore(back, jts)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(jts)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert again["enc_params"] is None and "encoder" in again["trainable"]
