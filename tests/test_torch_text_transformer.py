"""The port's label text tower (protnote_tpu_torch/models/text_transformer.py)
and the plain versions of its kernels, masked attention (K8a,
ops/text_attention.py) and residual LayerNorm (K8b, ops/layer_norm.py),
against the JAX package and HF transformers on the CPU.

Sizes are small (2 layers, H 32-64, 4 heads); weights come from the JAX init
(LayerNorms perturbed) and are carried across with ``from_jax_tree``; inputs
from numpy seeds, with ragged masks and one all-masked row (the filler row of
a padded chunk).  The JAX side runs jitted, as the JAX label encoder and eval
step run it.

Tolerances:
* float32: 1e-5 absolute (the `TOL` of tests/test_reference_parity.py): both
  sides round at the same points and differ only in summation order;
* bfloat16: 2.5e-2 of the largest |value| (hidden states of std ~1): the
  rounding points are the same, but a sum in another order can land a bf16
  step (2^-8) away, and the port's GELU rounds once where JAX's erfc
  formula rounds four times in bf16; such steps pass through the layers;
* against HF transformers: the tolerances of tests/test_text_transformer.py
  (2e-4 bert, 2e-3 gpt, whose pre-LN residual stream amplifies float32
  noise).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import text_transformer as jtt
from protnote_tpu.models.label_encoder import pool_hidden_states as np_pool
from protnote_tpu_torch.models import text_transformer as ttt
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import layer_norm as k8b
from protnote_tpu_torch.ops import text_attention as k8a

TOL = 1e-5
BF16_REL_TOL = 2.5e-2
SMALL = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
             max_position_embeddings=40)


def _configs(arch="bert", position_style="fairseq", bf16=False, **kw):
    extra = dict(scale_embedding=True) if arch == "gpt" else dict(position_style=position_style)
    args = {**SMALL, **extra, **kw, "arch": arch}
    return (jtt.TextEncoderConfig(**args, dtype=jnp.bfloat16 if bf16 else jnp.float32),
            ttt.TextEncoderConfig(**args, dtype=torch.bfloat16 if bf16 else torch.float32))


def _params(jcfg, seed=0):
    """JAX-initialised tower as numpy, LayerNorm scales and biases perturbed
    (the init's ones and zeros would hide a swapped or missing LN term)."""
    p = jax.tree_util.tree_map(np.asarray, jtt.init_text_encoder(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(ln):
        n = ln["scale"].shape[0]
        ln["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        ln["bias"] = rng.normal(0, 0.2, n).astype(np.float32)

    perturb(p["embeddings_ln" if jcfg.arch == "bert" else "final_ln"])
    for lp in p["layers"]:
        perturb(lp["attn_ln"]), perturb(lp["ffn_ln"])
    return p


def _port(tree):
    return from_jax_tree({"t": tree})["t"]


def _inputs(seed=1, B=4, T=12, vocab=60, pad=1):
    """Ragged masks: a full row, two shorter ones and one all-masked row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, size=(B, T)).astype(np.int32)
    lengths = np.array([T, 7, 3, 0][:B])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    ids[mask == 0] = pad
    return ids, mask


@functools.lru_cache(maxsize=None)
def _jax_forward(cfg):
    return jax.jit(functools.partial(jtt.text_encoder_forward, cfg=cfg),
                   static_argnames=("lora_rank",))


def _run_both(jcfg, tcfg, params, ids, mask, lora=None, **kw):
    want = np.asarray(_jax_forward(jcfg)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids), jnp.asarray(mask),
        lora=None if lora is None else jax.tree_util.tree_map(jnp.asarray, lora), **kw
    ).astype(jnp.float32))
    got = ttt.text_encoder_forward(_port(params), torch.from_numpy(ids),
                                   torch.from_numpy(mask), tcfg,
                                   lora=None if lora is None else _port(lora), **kw)
    return got.float().numpy(), want


@pytest.mark.parametrize("arch,position_style", [("bert", "fairseq"), ("bert", "absolute"),
                                                 ("gpt", "fairseq")])
def test_forward_matches_jax_f32(arch, position_style):
    jcfg, tcfg = _configs(arch, position_style)
    params = _params(jcfg)
    ids, mask = _inputs()
    got, want = _run_both(jcfg, tcfg, params, ids, mask)
    assert got.shape == want.shape == (4, 12, 32)
    assert np.isfinite(got).all()  # the all-masked row too
    attended = mask > 0
    np.testing.assert_allclose(got[attended], want[attended], atol=TOL, rtol=0)
    # the all-masked row is finite on both sides and agrees as well
    np.testing.assert_allclose(got[3], want[3], atol=TOL, rtol=0)


@pytest.mark.parametrize("arch", ["bert", "gpt"])
def test_forward_matches_jax_bf16(arch):
    jcfg, tcfg = _configs(arch, bf16=True)
    params = _params(jcfg, seed=2)
    ids, mask = _inputs(seed=3, T=20)
    got, want = _run_both(jcfg, tcfg, params, ids, mask)
    assert np.isfinite(got).all()
    attended = mask > 0
    err = np.abs(got[attended] - want[attended]).max() / np.abs(want[attended]).max()
    assert err <= BF16_REL_TOL


@pytest.mark.parametrize("arch", ["bert", "gpt"])
def test_lora_forward_matches_jax(arch):
    """Adapters on every target of the last layer and on q/v of the first,
    with non-zero B (a fresh adapter is the identity and would test
    nothing)."""
    jcfg, tcfg = _configs(arch)
    params = _params(jcfg, seed=4)
    lora = jax.tree_util.tree_map(np.asarray, jtt.init_lora(
        jax.random.PRNGKey(5), jcfg, rank=2, last_n_layers=1))
    lora["0"] = jax.tree_util.tree_map(np.asarray, jtt.init_lora(
        jax.random.PRNGKey(6), jcfg, rank=2, last_n_layers=2, targets=("q", "v")))["0"]
    rng = np.random.default_rng(7)
    for entry in lora.values():
        for ab in entry.values():
            ab["B"] = rng.normal(0, 0.3, ab["B"].shape).astype(np.float32)
    ids, mask = _inputs(seed=8)
    got, want = _run_both(jcfg, tcfg, params, ids, mask, lora=lora, lora_alpha=4.0,
                          lora_rank=2)
    base, _ = _run_both(jcfg, tcfg, params, ids, mask)
    attended = mask > 0
    np.testing.assert_allclose(got[attended], want[attended], atol=TOL, rtol=0)
    assert np.abs(got - base)[attended].max() > 1e-2  # the adapters act


def test_init_lora_is_the_identity():
    _, tcfg = _configs()
    params = ttt.init_text_encoder(torch.Generator().manual_seed(0), tcfg)
    lora = ttt.init_lora(torch.Generator().manual_seed(1), tcfg, rank=2, last_n_layers=2)
    assert set(lora) == {"0", "1"} and set(lora["1"]) == set(ttt.LORA_TARGETS)
    ids, mask = _inputs()
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    torch.testing.assert_close(ttt.text_encoder_forward(params, ids, mask, tcfg, lora=lora),
                               ttt.text_encoder_forward(params, ids, mask, tcfg),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["bert", "gpt"])
def test_init_text_encoder_matches_the_jax_layout(arch):
    """The port's init gives the JAX tree: the same keys, shapes and dtypes,
    and draws of the same scales."""
    jcfg, tcfg = _configs(arch, num_layers=1, hidden_size=64, intermediate_size=128)
    want = jax.tree_util.tree_map(np.asarray, jtt.init_text_encoder(jax.random.PRNGKey(0), jcfg))
    got = ttt.init_text_encoder(torch.Generator().manual_seed(0), tcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert w.shape == g.shape and g.dtype == np.float32, path
        np.testing.assert_allclose(np.abs(g).max(), np.abs(w).max(), rtol=0.5)


def test_cast_for_inference_keeps_the_forward():
    """Embedding and Linear weights cast once to bf16 give the forward that
    casts them at use; LayerNorm parameters stay float32."""
    jcfg, tcfg = _configs(bf16=True)
    params = _port(_params(jcfg))
    cast = ttt.cast_for_inference(params, torch.bfloat16)
    assert cast["word_embeddings"].dtype == torch.bfloat16
    assert cast["layers"][0]["fc1"]["kernel"].dtype == torch.bfloat16
    assert cast["layers"][0]["attn_ln"]["scale"].dtype == torch.float32
    assert cast["embeddings_ln"]["bias"].dtype == torch.float32
    ids, mask = map(torch.from_numpy, _inputs())
    assert torch.equal(ttt.text_encoder_forward(cast, ids, mask, tcfg),
                       ttt.text_encoder_forward(params, ids, mask, tcfg))


# ----------------------------------------------------------------------
# the plain versions of the kernels against the JAX functions


@pytest.mark.parametrize("hd", [16, 8])
@pytest.mark.parametrize("arch", ["bert", "gpt"])
def test_attention_matches_jax(hd, arch):
    """The JAX ``_attention`` (jitted) against the port's, whose core is the
    plain K8a, at hd 16 and hd 8 (where 1/sqrt(hd) is not a power of two),
    with the key mask (and for gpt the causal mask) as the JAX forward
    builds it, an all-masked row included."""
    jcfg, tcfg = _configs(arch, hidden_size=4 * hd)
    lp = _params(jcfg, seed=hd)["layers"][0]
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(4, 12, 4 * hd)).astype(np.float32)
    _, mask = _inputs(seed=hd)
    keep = mask[:, None, None, :] > 0
    if arch == "gpt":
        keep = keep & np.tril(np.ones((12, 12), bool))[None, None]
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jtt._attention, cfg=jcfg, lora_entry=None, lora_scaling=1.0))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x), jnp.asarray(bias)))
    got = ttt._attention(_port(lp), torch.from_numpy(x), torch.from_numpy(mask), tcfg, None,
                         1.0, k8a.masked_attention)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("hd", [8, 16, 64])
def test_xla_divides_scores_by_sqrt_hd_as_a_reciprocal_multiply(hd):
    """Jitted, JAX's ``scores / math.sqrt(hd)`` is ``scores *
    float32(1 / sqrt(hd))``, which the plain K8a and the kernel use; at hd 8
    it differs from the true quotient on some scores, at hd 16 and 64 the
    reciprocal is a power of two and both agree."""
    s = np.random.default_rng(0).normal(size=100_000).astype(np.float32) * 10
    got = np.asarray(jax.jit(lambda v: v / math.sqrt(hd))(s))
    inv = np.float32(k8a.scale_for(hd))
    np.testing.assert_array_equal(got, s * inv)
    assert (s * inv != s / np.float32(math.sqrt(hd))).any() == (hd == 8)


def test_attention_core_all_masked_row_is_uniform():
    """A row whose keys are all masked gets the uniform softmax over every
    key (JAX adds -1e9 to all of them), so its context is the mean of v and
    stays finite; keys are never skipped."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 5, 8)).astype(np.float32))
               for _ in range(3))
    mask = torch.tensor([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]], dtype=torch.int32)
    for causal in (False, True):
        ctx = k8a.masked_attention(q, k, v, mask, causal)
        assert torch.isfinite(ctx).all()
        torch.testing.assert_close(ctx[1], v[1].mean(1, keepdim=True).expand(-1, 5, -1))


def _bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _k8a_emulated(q, k, v, mask, causal):
    """The CUDA K8a's algorithm in float32 numpy (q, k, v (B, nh, T, hd)
    bf16 values as float32, mask (B, T)): warps of 16 query rows and 64-key
    tiles; the key tiles a warp skips (before the first kept key, after the
    last, and causal after the warp's last row, unless a row of the warp
    has no kept key up to itself); at T <= 128 the scores held for every key
    (one pass), above it a running max and a rescaled running sum (pass 1)
    and the probabilities bf16(exp(s - m) / l) from the final m (pass 2),
    over the tiles any warp of the 64-row warpgroup needs (its wgmma runs
    for all four warps).  Returns the bf16 context and the tiles visited
    and skipped."""
    f32 = np.float32
    B, nh, T, hd = q.shape
    scale = f32(k8a.scale_for(hd))
    nkt = -(-T // 64)
    ctx = np.zeros(q.shape, f32)
    visited = skipped = 0
    for b in range(B):
        kept = np.nonzero(mask[b] > 0)[0]
        first, last = (kept[0], kept[-1]) if kept.size else (T, -1)
        kbias = np.where(mask[b] > 0, f32(0), f32(k8a.MASKED)).astype(f32)
        def warp_tiles(w0):
            if (first <= w0) if causal else (first < T):
                return first // 64, (min(last, w0 + 15) if causal else last) // 64 + 1
            return 0, nkt

        for h in range(nh):
            for w0 in range(0, T, 16):
                rows = np.arange(w0, min(w0 + 16, T))
                lo, hi = warp_tiles(w0)
                if T > 128:  # the warpgroup's tiles
                    group = [warp_tiles(w) for w in range(w0 // 64 * 64, w0 // 64 * 64 + 64, 16)
                             if w < T]
                    lo, hi = min(g[0] for g in group), max(g[1] for g in group)
                visited += hi - lo
                skipped += nkt - (hi - lo)

                def scores(kt):
                    keys = np.arange(kt * 64, min(kt * 64 + 64, T))
                    s = (q[b, h, rows] @ k[b, h, keys].T).astype(f32)
                    bias = np.broadcast_to(kbias[keys], s.shape).copy()
                    if causal:
                        bias[keys[None, :] > rows[:, None]] = f32(k8a.MASKED)
                    return (s * scale).astype(f32) + bias, keys

                o = np.zeros((rows.size, hd), f32)
                if T <= 128:
                    parts = [scores(kt) for kt in range(lo, hi)]
                    s = np.concatenate([p for p, _ in parts], 1)
                    e = np.exp(s - s.max(1, keepdims=True))
                    p = _bf16_round(e / e.sum(1, keepdims=True, dtype=f32))
                    o = p @ v[b, h, np.concatenate([ks for _, ks in parts])]
                else:
                    m = np.full((rows.size, 1), -np.inf, f32)
                    l_ = np.zeros((rows.size, 1), f32)
                    for kt in range(lo, hi):
                        s, _ = scores(kt)
                        mn = np.maximum(m, s.max(1, keepdims=True))
                        l_ = l_ * np.exp(m - mn) + np.exp(s - mn).sum(1, keepdims=True, dtype=f32)
                        m = mn
                    for kt in range(lo, hi):
                        s, keys = scores(kt)
                        o = o + _bf16_round(np.exp(s - m) / l_) @ v[b, h, keys]
                ctx[b, h, rows] = _bf16_round(o)
    return ctx, visited, skipped


@pytest.mark.parametrize("T,causal", [(77, False), (77, True), (128, True), (200, False),
                                      (200, True), (1, False)])
def test_attention_kernel_algorithm_matches_jax(T, causal):
    """K8a's blocking, tile skipping and one- or two-pass normalisation,
    emulated in float32 on the CPU, against the JAX ``_attention`` in bf16
    (its projections made exact: identity and two permutations, no bias).
    Rows: a full one, a half one, an all-masked filler row (JAX's uniform
    softmax over every key) and one whose first 70 keys are masked (causal:
    the rows before its first kept key see every key).  Within 1e-2 of the
    largest |value| (two bf16 steps: the sums run in other orders, so a
    probability or an output can round to the neighbouring bf16 value)."""
    nh, hd = 2, 64
    H = nh * hd
    jcfg, _ = _configs("gpt" if causal else "bert", hidden_size=H, num_heads=nh, bf16=True)
    rng = np.random.default_rng(T + 1000 * causal)
    x = _bf16_round(rng.normal(size=(4, T, H)) * 1.5)
    mask = np.zeros((4, T), np.int32)
    mask[0] = 1
    mask[1, : max(T // 2, 1)] = 1
    mask[3, min(70, T - 1):] = 1
    p1, p2 = rng.permutation(H), rng.permutation(H)
    eye = np.eye(H, dtype=np.float32)
    lp = {"q": {"kernel": eye}, "k": {"kernel": eye[:, p1]}, "v": {"kernel": eye[:, p2]},
          "o": {"kernel": eye}}
    keep = mask[:, None, None, :] > 0
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None, None]
    bias = np.where(keep, 0.0, -1e9).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(
        jtt._attention, cfg=jcfg, lora_entry=None, lora_scaling=1.0))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(bias)).astype(jnp.float32))

    def heads(y):
        return y.reshape(4, T, nh, hd).transpose(0, 2, 1, 3)

    got, visited, skipped = _k8a_emulated(heads(x), heads(x[..., p1]), heads(x[..., p2]),
                                          mask, causal)
    got = got.transpose(0, 2, 1, 3).reshape(4, T, H)
    assert np.isfinite(got).all()
    assert visited > 0 and (skipped > 0) == (T > 64)  # the skips are exercised
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * scale
    # the filler row: the uniform softmax over all T keys, as JAX gives it
    np.testing.assert_allclose(got[2], np.broadcast_to(x[2, :, p2].T.mean(0), (T, H)),
                               atol=1e-2 * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_matches_jax(dtype, residual):
    """The plain K8b against ``_layer_norm(p, x + a)``: the add rounded in
    the compute dtype, then the two-pass float32 statistics, on rows with a
    large common offset (where E[x^2] - mu^2 would cancel).

    bf16 is held against eager JAX, which computes the source's rounding
    points op by op.  Jitted on the CPU, XLA fuses the bf16 add into the
    LayerNorm's float32 cast and drops its rounding (the sum stays exact in
    float32); the port keeps the rounding the source writes."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(5, 7, 64)) * 3 + 100).astype(np.float32)
    a = rng.normal(size=(5, 7, 64)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    jx, ja = jnp.asarray(x).astype(jdt), jnp.asarray(a).astype(jdt)
    ln = lambda x_, a_: jtt._layer_norm(p, x_ + a_ if residual else x_, 1e-5)  # noqa: E731
    want = np.asarray((jax.jit(ln) if dtype == "f32" else ln)(jx, ja).astype(jnp.float32))
    tx, ta = torch.from_numpy(x).to(tdt), torch.from_numpy(a).to(tdt)
    got = k8b.add_layer_norm(tx, ta if residual else None, torch.from_numpy(p["scale"]),
                             torch.from_numpy(p["bias"]), 1e-5)
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    else:  # one bf16 step at most (|y| < 4: a step is at most 2^-6)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -6, rtol=0)


def _k8b_emulated(x, r, scale, bias, eps, bf16):
    """The CUDA K8b's algorithm in float32 numpy (x, r (N, H) values of the
    compute dtype as float32, r None without the residual): v = x + r
    (rounded to bf16 in bf16); lane l holds columns (c * 32 + l) * 8 + e of
    chunk c < H / 256; eight partial sums a lane over the chunks in order,
    the fixed tree ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), a
    butterfly over the 32 lanes; mu and the two-pass variance by true
    division by H; every product and sum rounded on its own."""
    f32 = np.float32
    N, H = x.shape
    v = x if r is None else (x + r).astype(f32)
    if bf16:
        v = _bf16_round(v)
    lanes = v.reshape(N, H // 256, 32, 8)

    def row_sum(vals):
        p = vals[:, 0]
        for c in range(1, vals.shape[1]):
            p = p + vals[:, c]
        s = ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + \
            ((p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7]))
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, np.arange(32) ^ o]
        assert s.dtype == f32 and (s == s[:, :1]).all()  # every lane holds the sum
        return s[:, 0]

    mu = row_sum(lanes) / f32(H)
    d = lanes - mu[:, None, None, None]
    var = row_sum(d * d) / f32(H)
    rs = (1.0 / np.sqrt((var + f32(eps)).astype(np.float64))).astype(f32)
    y = (d * rs[:, None, None, None]) * scale.reshape(-1, 32, 8) + bias.reshape(-1, 32, 8)
    assert y.dtype == f32
    y = y.reshape(N, H)
    return _bf16_round(y) if bf16 else y


@pytest.mark.parametrize("H", [256, 768, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_kernel_algorithm_matches_jax(H, dtype, residual):
    """K8b's reduction order (partial sums a lane, a tree, a butterfly over
    the warp), emulated in float32 on the CPU, against the eager JAX
    ``_layer_norm(p, x + a)`` on rows with a large common offset.  float32:
    within 2e-5 of JAX (rows of up to 1024 values near 100 sum to ~1e5,
    where JAX's own float32 result lies up to 9e-6 from the exact one and
    the plain K8b's up to 1.2e-5 from JAX's) and within 1e-5 (`TOL`) of the
    float64 LayerNorm of the same values; bf16: within one
    bf16 step at the largest |value| (2^-7 of it: a sum in another order
    can round an output to the neighbouring bf16 value)."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rng = np.random.default_rng(H + 2 * residual)
    x = (rng.normal(size=(35, H)) * 3 + 100).astype(np.float32)
    a = rng.normal(size=(35, H)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, H).astype(np.float32),
         "bias": rng.normal(size=H).astype(np.float32)}
    jx, ja = jnp.asarray(x).astype(jdt), jnp.asarray(a).astype(jdt)
    want = np.asarray(jtt._layer_norm(p, jx + ja if residual else jx, 1e-5).astype(jnp.float32))
    xs, as_ = (np.array(t.astype(jnp.float32)) for t in (jx, ja))
    got = _k8b_emulated(xs, as_ if residual else None, p["scale"], p["bias"], 1e-5,
                        dtype == "bf16")
    assert np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2 * TOL, rtol=0)
        v = (xs + as_ if residual else xs).astype(np.float64)
        d = v - v.mean(1, keepdims=True)
        exact = d / np.sqrt((d * d).mean(1, keepdims=True) + 1e-5) * p["scale"] + p["bias"]
        np.testing.assert_allclose(got, exact, atol=TOL, rtol=0)
    else:
        step = 2.0 ** -7 * np.abs(want).max()  # a bf16 step at the largest |value|, or more
        np.testing.assert_allclose(got, want, atol=step, rtol=0)


# ----------------------------------------------------------------------
# pooling


@pytest.mark.parametrize("method", ["mean", "last_token", "all"])
@pytest.mark.parametrize("account_for_sos", [True, False])
def test_pooling_matches_jax(method, account_for_sos):
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 9, 16)).astype(np.float32)
    mask = np.array([[1] * 9, [1] * 5 + [0] * 4, [1] + [0] * 8, [0] * 9], np.int32)
    want = np.asarray(jtt.pool_hidden_states_jnp(jnp.asarray(h), jnp.asarray(mask), method,
                                                 account_for_sos=account_for_sos))
    got = ttt.pool_hidden_states(torch.from_numpy(h), torch.from_numpy(mask), method,
                                 account_for_sos=account_for_sos).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np_pool(h, mask, method, account_for_sos), atol=1e-6)
    if method == "mean" and account_for_sos:
        # a row with only the SOS token, or none, pools to zeros, not 0/0
        assert np.isfinite(got).all() and not got[2:].any()


def test_pooling_unknown_method_raises():
    with pytest.raises(ValueError):
        ttt.pool_hidden_states(torch.zeros(1, 2, 3), torch.ones(1, 2), "max")


# ----------------------------------------------------------------------
# HF transformers checkpoints


def _hf_bert():
    from transformers import XLMRobertaConfig, XLMRobertaModel

    hf_cfg = XLMRobertaConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64,
                              max_position_embeddings=40, type_vocab_size=1, pad_token_id=1)
    torch.manual_seed(0)
    return hf_cfg, XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval(), 1, 2e-4


def _hf_plain_bert():
    from transformers import BertConfig, BertModel

    hf_cfg = BertConfig(vocab_size=90, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=24, type_vocab_size=2, pad_token_id=0)
    torch.manual_seed(1)
    return hf_cfg, BertModel(hf_cfg, add_pooling_layer=False).eval(), 0, 2e-4


def _hf_biogpt():
    from transformers import BioGptConfig, BioGptModel

    hf_cfg = BioGptConfig(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=40, pad_token_id=1, scale_embedding=True,
                          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                          activation_dropout=0.0)
    torch.manual_seed(0)
    return hf_cfg, BioGptModel(hf_cfg).eval(), 1, 2e-3


@pytest.mark.parametrize("make", [_hf_bert, _hf_plain_bert, _hf_biogpt],
                         ids=["xlm-roberta", "bert", "biogpt"])
def test_from_hf_state_dict_matches_transformers_and_jax(make):
    hf_cfg, model, pad, tol = make()
    cfg = ttt.config_from_hf(hf_cfg)
    jcfg = jtt.config_from_hf(hf_cfg)
    assert (cfg.arch, cfg.position_style, cfg.pad_token_id, cfg.num_layers) == \
        (jcfg.arch, jcfg.position_style, jcfg.pad_token_id, jcfg.num_layers)
    params = ttt.from_hf_state_dict(model.state_dict(), cfg)
    want_tree = jax.tree_util.tree_map(np.asarray, jtt.from_hf_state_dict(model.state_dict(),
                                                                          jcfg))
    for a, b in zip(jax.tree_util.tree_leaves(want_tree),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(),
                                                                     params))):
        np.testing.assert_array_equal(b, a)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, min(hf_cfg.vocab_size, 90), size=(3, 12)).astype(np.int64)
    mask = np.ones((3, 12), np.int64)
    mask[0, 8:] = 0
    mask[2, 5:] = 0
    ids[mask == 0] = pad
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids),
                    attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    got = ttt.text_encoder_forward(params, torch.tensor(ids), torch.tensor(mask), cfg).numpy()
    np.testing.assert_allclose(got[mask > 0], ref[mask > 0], rtol=tol, atol=tol)


def test_config_from_hf_refuses_other_models():
    class Cfg:
        model_type = "t5"

    with pytest.raises(ValueError, match="t5"):
        ttt.config_from_hf(Cfg())


def test_from_jax_tree_carries_text_and_lora_trees():
    """A text tree (a list of layers, 2-D kernels left as they are) and a
    LoRA tree (keyed by layer index) come across leaf for leaf."""
    jcfg, _ = _configs()
    params = _params(jcfg)
    lora = jax.tree_util.tree_map(np.asarray, jtt.init_lora(
        jax.random.PRNGKey(0), jcfg, rank=2, last_n_layers=1))
    out = from_jax_tree({"text_params": params, "trainable": {"lora": lora}})
    assert isinstance(out["text_params"]["layers"], list)
    assert set(out["trainable"]["lora"]) == {"1"}
    for tree, want in ((out["text_params"], params), (out["trainable"]["lora"], lora)):
        got = jax.tree_util.tree_map(lambda t: t.numpy(), tree)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(b, a)
