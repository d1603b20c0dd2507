"""The port's train step (protnote_tpu_torch/train/step.py) against the JAX
``make_train_step`` on the CPU.

One JAX ``init_train_state`` (small widths, random BatchNorm statistics,
He-scaled linears) is converted with ``from_jax_tree``; both steps then run
on the same numpy batches with label noising and dropout off (JAX's random
bits cannot be matched) and the default FocalLoss + clipped Adam.

Tolerances:
* float32: 1e-5 absolute on the loss, the gradient norm, parameters, BN
  running statistics and Adam moments (the `TOL` of
  tests/test_reference_parity.py); tp/fp/fn exactly (the logits agree to
  ~1e-6 and no probability lies within 1e-4 of the threshold).
* bfloat16: the loss to 2e-3 relative and the gradient norm to 5e-2
  relative after one step (both sides round at the same points, but a sum
  in another order lands a bf16 step away and the backward's bf16
  cotangents carry it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import fusion as jfu
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu.train.losses import get_loss_fn as jax_loss
from protnote_tpu.train.optim import make_optimizer
from protnote_tpu.train.step import init_train_state as jax_init_state
from protnote_tpu.train.step import make_train_step as jax_train_step
from protnote_tpu_torch.models import fusion as tfu
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree, to_jax_tree
from protnote_tpu_torch.train.losses import get_loss_fn
from protnote_tpu_torch.train.optim import Optimizer
from protnote_tpu_torch.train.step import make_train_step

TOL = 1e-5
B, T, L, D = 6, 40, 13, 16
PARAMS = {"LOSS_FN": "FocalLoss", "FOCAL_LOSS_GAMMA": 2, "FOCAL_LOSS_ALPHA": -1,
          "OPTIMIZER": "Adam", "LEARNING_RATE": 1e-2, "CLIP_VALUE": 0.3}
PI = dict(input_channels=20, output_channels=24, kernel_size=3, num_resnet_blocks=1,
          num_labels=5)
PN = dict(protein_embedding_dim=24, label_embedding_dim=D, latent_dim=8,
          projection_head_num_layers=2, projection_head_hidden_dim_scale_factor=2,
          output_mlp_num_layers=3, output_mlp_hidden_dim_scale_factor=2)


def _configs(bf16=False, **change):
    """Both packages' configs; ``change``: ProtNoteConfig fields of the same
    name on both sides."""
    jpi_cfg = jpi.ProteInferConfig(**PI)
    tpi_cfg = tpi.ProteInferConfig(**PI)
    jpn = jfu.ProtNoteConfig(**PN, **change,
                             compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tpn = tfu.ProtNoteConfig(**PN, **change,
                             compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return jpi_cfg, tpi_cfg, jpn, tpn


def _jax_state(seed=0, train_sequence_encoder=False, **change):
    jpi_cfg, _, jpn, _ = _configs(**change)
    pi_p, pi_s = jpi.init_proteinfer(jax.random.PRNGKey(seed), jpi_cfg)
    pn_p, pn_s = jfu.init_protnote(jax.random.PRNGKey(seed + 1), jpn)
    rng = np.random.default_rng(seed)
    pn_p = jax.tree_util.tree_map(np.asarray, pn_p)
    pn_s = jax.tree_util.tree_map(np.asarray, pn_s)
    for head in ("W_p", "W_l", "output_mlp"):
        for st in pn_s.get(head, {"bns": []})["bns"]:
            st["mean"] = rng.normal(0, 0.2, st["mean"].shape).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
        for lin in pn_p[head]["layers"] + [pn_p[head].get("out", {})]:
            if "kernel" in lin:
                lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
    return jax_init_state(pn_p, pn_s, pi_p, pi_s, make_optimizer(PARAMS),
                          train_sequence_encoder=train_sequence_encoder)


def _batches(n, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lengths = rng.integers(10, T + 1, size=B).astype(np.int32)
        aa = rng.integers(0, 20, size=(B, T)).astype(np.int32)
        aa[np.arange(T)[None, :] >= lengths[:, None]] = 20  # the pad id
        em = np.ones(B, np.float32)
        em[-1 - i % 2:] = 0.0
        lm = (np.arange(L) < L - 2).astype(np.float32)
        out.append({"aa_ids": aa, "lengths": lengths, "example_mask": em,
                    "label_embeddings": rng.normal(size=(L, D)).astype(np.float32),
                    "label_multihots": (rng.random((B, L)) < 0.3).astype(np.float32),
                    "label_mask": lm})
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _run_both(jts, batches, bf16=False, **change):
    """Steps on both sides from the same state; returns the metrics of each
    step on each side and the final states (the port's as a JAX tree)."""
    jpi_cfg, tpi_cfg, jpn, tpn = _configs(bf16, **change)
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(PARAMS), make_optimizer(PARAMS),
                           donate=False)
    opt = Optimizer(PARAMS)
    tstep = make_train_step(tpi_cfg, tpn, get_loss_fn(PARAMS), opt)
    tts = from_jax_tree(jax.tree_util.tree_map(np.asarray, jts))
    metrics = []
    gen = torch.Generator().manual_seed(0)
    for batch in batches:
        jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        tts, tm = tstep(tts, {k: torch.from_numpy(v) for k, v in batch.items()}, gen)
        metrics.append((jax.tree_util.tree_map(np.asarray, jm),
                        {k: v.numpy() for k, v in tm.items()}))
    return metrics, jax.tree_util.tree_map(np.asarray, jts), to_jax_tree(tts, opt)


def test_three_steps_match_jax_f32():
    _assert_steps_close(*_run_both(_jax_state(), _batches(3)))


@pytest.mark.parametrize("cache", [False, True])
def test_streaming_steps_match_jax(cache):
    """Three steps through the streamed scorer (``train_label_tile`` 4 over
    13 labels, 2 of them masked: the last tile holds one label and three
    padded ones), with the z1 cache off and on: the checks of
    ``test_three_steps_match_jax_f32``."""
    _assert_steps_close(*_run_both(_jax_state(), _batches(3), train_label_tile=4,
                                   train_streaming_cache=cache))


def _assert_steps_close(metrics, jts, tts, min_leaves=10):
    """Losses, gradient norms (the clip binding), tp/fp/fn exactly, and the
    trainable parameters, running statistics and Adam moments after three
    steps, float32 (each tree holds ``min_leaves`` leaves or more)."""
    for jm, tm in metrics:
        np.testing.assert_allclose(tm["loss"], jm["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], atol=TOL, rtol=0)
        assert jm["grad_norm"] > PARAMS["CLIP_VALUE"]  # the clip binds
        for k in ("tp", "fp", "fn"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
        assert int(tm["examples"]) == int(jm["examples"])
    assert sum(int(jm["tp"].sum()) for jm, _ in metrics) > 0
    for key in ("trainable", "model_state"):
        got, want = _leaves(tts[key]), _leaves(jts[key])
        assert len(got) == len(want) >= min_leaves
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=key)
    got, want = _leaves(tts["opt_state"]), _leaves(jts["opt_state"])
    assert len(got) == len(want) and int(tts["step"]) == int(jts["step"]) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


# The last block's 1 x 1 conv bias gets a gradient that is zero in exact
# arithmetic: it shifts every pooled embedding alike, and the W_p head's
# train-mode BatchNorm takes the shift out.  Each side's gradient there is
# float32 noise of ~1e-8, which Adam scales into a step of up to the
# learning rate with either sign, so that leaf is held to Adam's bound, and
# each step starts from the JAX side's state (a pooled embedding shifted by
# that noise rounds the scorer's pre-activations differently, and one ReLU
# gate at float32's edge then moves the next steps' gradients by ~1%).
_NOISE_BIAS = "['trainable']['encoder']['blocks'][0]['conv_1x1']['bias']"


@pytest.mark.parametrize("flag", ["train_sequence_encoder", "encoder_bn_train_mode"])
def test_encoder_training_settings_match_jax(flag):
    """Three steps with the encoder's BatchNorm on batch statistics (the
    count rule over the rows each batch's example mask keeps: one or two
    filler rows a batch), trained (``train_sequence_encoder``: the encoder
    in ``trainable["encoder"]``) or frozen (``encoder_bn_train_mode``), each
    from the JAX step's state: loss, grad_norm, every parameter (the
    encoder's updates included), the new ``enc_state`` and the Adam moments
    at 1e-5."""
    train = flag == "train_sequence_encoder"
    jpi_cfg, tpi_cfg, jpn, tpn = _configs()
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(PARAMS), make_optimizer(PARAMS),
                           donate=False, **{flag: True})
    opt = Optimizer(PARAMS)
    tstep = make_train_step(tpi_cfg, tpn, get_loss_fn(PARAMS), opt, **{flag: True})
    jts = jts0 = _jax_state(train_sequence_encoder=train)
    for batch in _batches(3):
        start = jax.tree_util.tree_map(np.asarray, jts)
        tts, tm = tstep(from_jax_tree(start), {k: torch.from_numpy(v) for k, v in batch.items()},
                        None)
        jts, jm = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
        np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], atol=TOL, rtol=0)
        np.testing.assert_allclose(tm["grad_norm"].numpy(), jm["grad_norm"], atol=TOL, rtol=0)
        got, want = to_jax_tree(tts, opt), jax.tree_util.tree_map(np.asarray, jts)
        assert ("encoder" in tts["trainable"]) == train and (tts["enc_params"] is None) == train
        for key in ("trainable", "model_state", "enc_state", "opt_state"):
            flat = jax.tree_util.tree_flatten_with_path(want[key])[0]
            paths = [f"['{key}']" + jax.tree_util.keystr(p) for p, _ in flat]
            a, b, a0 = _leaves(got[key]), _leaves(want[key]), _leaves(start[key])
            assert len(a) == len(b) == len(paths) >= 4
            assert (_NOISE_BIAS in paths) == (train and key == "trainable")
            for path, x, y, x0 in zip(paths, a, b, a0):
                if path == _NOISE_BIAS:
                    lr = PARAMS["LEARNING_RATE"]
                    assert np.abs(x - x0).max() <= lr and np.abs(y - x0).max() <= lr
                    continue
                np.testing.assert_allclose(x, y, atol=TOL, rtol=0, err_msg=path)
    moved = [np.abs(np.asarray(a) - b).max() for a, b in zip(
        _leaves(jax.tree_util.tree_map(np.asarray, jts["enc_state"])), _leaves(jts0["enc_state"]))]
    assert min(moved) > 0  # every running statistic moved
    enc0 = _leaves(jts0["trainable"]["encoder"] if train else jts0["enc_params"])
    enc = _leaves(jts["trainable"]["encoder"] if train else jts["enc_params"])
    assert any(np.abs(np.asarray(a) - b).max() > 0 for a, b in zip(enc, enc0)) == train


def test_one_step_matches_jax_bf16():
    metrics, _, _ = _run_both(_jax_state(), _batches(1), bf16=True)
    (jm, tm), = metrics
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=2e-3, atol=0)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=5e-2, atol=0)


def test_jax_trained_state_with_moments_steps_alike():
    """Two JAX steps, the state (Adam moments included) converted, then one
    step on each side."""
    jpi_cfg, _, jpn, _ = _configs()
    jstep = jax_train_step(jpi_cfg, jpn, jax_loss(PARAMS), make_optimizer(PARAMS),
                           donate=False)
    jts = _jax_state(seed=3)
    for batch in _batches(2, seed=4):
        jts, _ = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    assert int(jts["step"]) == 2
    metrics, jts, tts = _run_both(jts, _batches(1, seed=5))
    np.testing.assert_allclose(metrics[0][1]["loss"], metrics[0][0]["loss"], atol=TOL, rtol=0)
    for key in ("trainable", "model_state", "opt_state"):
        for a, b in zip(_leaves(tts[key]), _leaves(jts[key])):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=key)


def test_label_rows_gather_matches_shipped_embeddings():
    """A batch with ``label_rows`` into a resident matrix trains like the
    same batch with the gathered rows shipped."""
    jts = _jax_state()
    _, tpi_cfg, _, tpn = _configs()
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    matrix = torch.cat([batch["label_embeddings"], torch.randn(4, D)])
    gathered = dict(batch, label_matrix=matrix,
                    label_rows=torch.arange(L, dtype=torch.int32))
    del gathered["label_embeddings"]
    out = []
    for b in (batch, gathered):
        opt = Optimizer(PARAMS)
        step = make_train_step(tpi_cfg, tpn, get_loss_fn(PARAMS), opt)
        tts, m = step(from_jax_tree(jax.tree_util.tree_map(np.asarray, jts)), b, None)
        out.append((m["loss"], _leaves(to_jax_tree(tts, opt)["trainable"])))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


def test_label_noise_range_and_scale():
    """Noising cannot match JAX's bits: U(-1, 1) * alpha / sqrt(d)."""
    L_f = torch.zeros(400, 64)
    noised = tfu.noise_label_embeddings(L_f, 20.0, torch.Generator().manual_seed(0))
    bound = 20.0 / 8.0
    assert float(noised.abs().max()) <= bound
    assert abs(float(noised.std()) - bound / np.sqrt(3)) < 0.02 * bound
    assert abs(float(noised.mean())) < 0.02 * bound


@pytest.mark.parametrize("change", [
    {"pair_backend": "tiled"}, {"pair_backend": "dense"},
    {"feature_fusion": "concatenation_prod"}, {"output_mlp_batchnorm": False},
    {"pair_backend": "dense", "gradient_checkpointing": True},
], ids=["tiled", "dense", "prod", "no_bn", "dense_remat"])
def test_dense_training_settings_match_jax(change):
    """The settings the JAX dispatch trains through the materialised dense
    scorer (``tiled`` without a label tile, ``dense``, ``concatenation_prod``,
    no output-MLP BatchNorm, and dense with GRADIENT_CHECKPOINTING): three
    steps from one JAX state, the checks of
    ``test_three_steps_match_jax_f32``."""
    # without output-MLP BatchNorm the running statistics are the heads' 4
    _assert_steps_close(*_run_both(_jax_state(**change), _batches(3), **change),
                        min_leaves=4 if change.get("output_mlp_batchnorm") is False else 10)


def _position_mask(shape, rate):
    """A deterministic dropout mask of ``shape`` (about ``rate`` dropped)."""
    idx = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    return (idx * 2654435761 % 1000) >= int(rate * 1000)


def test_dropout_steps_match_jax(monkeypatch):
    """OUTPUT_MLP_DROPOUT 0.25 through the dense scorer, three steps, the
    same masks on both sides: the heads' dropout (the JAX and the port's
    ``dropout_fn`` of models/fusion.py) takes a position mask of its
    input's shape, the output MLP takes the port's counter-hash masks of a
    fixed step seed (the port's ``draw_seed`` returns it; the JAX output
    MLP's ``dropout_fn`` takes those masks in layer order): the checks of
    ``test_three_steps_match_jax_f32``."""
    from protnote_tpu.ops import pair_scorer as jps
    from protnote_tpu_torch.ops import dense_scorer as tds

    rate = 0.25
    seed = torch.tensor([17, 29], dtype=torch.int64)
    monkeypatch.setattr(jfu, "dropout_fn", lambda x, r, rng, train: jnp.where(
        _position_mask(x.shape, r), x / (1.0 - r), 0.0).astype(x.dtype))
    monkeypatch.setattr(tfu, "dropout_fn", lambda x, r, gen, train: torch.where(
        torch.from_numpy(_position_mask(tuple(x.shape), r)), x / (1.0 - r), 0.0).to(x.dtype))
    monkeypatch.setattr(tfu, "draw_seed", lambda gen: seed)
    H = PN["latent_dim"] * PN["output_mlp_hidden_dim_scale_factor"]
    rows, cols = torch.arange(B * L)[:, None], torch.arange(H)[None, :]
    masks = [tds.keep_mask(seed, i, rate, rows, cols).numpy() for i in range(2)]
    calls = []

    def mlp_dropout(x, r, rng, train):
        calls.append(r)
        return jnp.where(masks[(len(calls) - 1) % 2], x / (1.0 - r), 0.0).astype(x.dtype)

    monkeypatch.setattr(jps, "dropout_fn", mlp_dropout)
    _assert_steps_close(*_run_both(_jax_state(dropout=rate), _batches(3), dropout=rate))
    assert calls == [rate, rate]  # traced once: two dropout layers
