"""The label tower in float32 on the card (``MIXED_PRECISION False``, and the
native label-embedding generator): the float32 kernels of masked attention
(K8a, ``csrc/text_attention_f32.cu``), its backward (K8a-bwd, same file) and
the residual LayerNorm and its backward (K8b, K8b-bwd, the ``_f32`` entry
points of ``csrc/layer_norm.cu``), their orders of work emulated in numpy
against the JAX package on the CPU; the dispatch that picks them by dtype;
and ``NativeLabelEncoder.from_pretrained``'s float32 default.

The CUDA kernels cannot run here.  Each emulation computes what its kernel
computes, in its order.  Attention's products run on the tensor cores as
3xTF32: each operand split into tf32 pieces as ``cvt.rna`` rounds them,
a_lo b_hi + a_hi b_lo + a_hi b_hi over each 16-deep stage of the depth,
the stage's sum rounded to float32 (the tensor cores' own sum of a stage is
taken exactly here: theirs truncates, a few ulps of the stage, far below
the tolerance) and the stages added in order; a row's z and D as per-tile
sums (lane t adds its keys 8 j + 2 t, 8 j + 2 t + 1 in order, the four
lanes pairwise), the tiles added in order, and above 128 tokens z as the
running sum over 64-key tiles.  K8b: eight partial sums a lane over its
256-column chunks, a fixed tree, a butterfly, and dscale / dbias over the
rows in the backward grid's walk.

Tolerance: 1e-5 of each output's largest |value| against the JAX function
in float32 (the `TOL` of tests/test_reference_parity.py, relative): both
sides round at the same points and sum in other orders.  Sizes are small:
hd 64, 1-2 heads, 3 rows of ragged, full and all-masked keys, and rows of
q and k whose scores reach about +-27.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import text_transformer as jtt
from protnote_tpu.models.layers import gemm_precision as jax_gemm_precision
from protnote_tpu_torch.models import label_encoder as tle
from protnote_tpu_torch.models.text_transformer import TextEncoderConfig
from protnote_tpu_torch.ops import layer_norm as k8b
from protnote_tpu_torch.ops import text_attention as k8a
from protnote_tpu_torch.ops.kernels import CSRC_DIR

TOL = 1e-5
F32 = np.float32


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * float(np.abs(want).max()), f"{name}: {err} vs {np.abs(want).max()}"


# ----------------------------------------------------------------------
# the kernels' arithmetic


def _butterfly(p):
    """A warp's butterfly over its last axis of 32 lanes (xor 16 ... 1);
    every lane ends with the same bits."""
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., np.arange(32) ^ o]
    assert p.dtype == F32 and (p == p[..., :1]).all()
    return p[..., 0]


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 fraction bits, ties away from
    zero (the low 13 bits of the float32 pattern cleared)."""
    bits = np.asarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(x):
    """The kernels' 3xTF32 pieces: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32(x)
    return hi, _tf32((x - hi).astype(F32))


def _tc(a, b):
    """``out[..., m, n]`` = a[..., m, :] . b[..., n, :] as the kernels form it
    on the tensor cores: a_lo b_hi + a_hi b_lo + a_hi b_hi of the 3xTF32
    pieces, each 16-deep stage of the depth summed exactly (the tensor
    cores' own sum of a stage, exact here) and rounded to float32, the
    stages added in order in float32, from 0."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = np.zeros(a.shape[:-1] + (b.shape[-2],), F32)
    for d in range(0, a.shape[-1], 16):
        x = [t[..., d:d + 16].astype(np.float64) for t in (ah, al, bh, bl)]
        st = sum(np.einsum("...mk,...nk->...mn", u, w) for u, w in
                 ((x[1], x[2]), (x[0], x[3]), (x[0], x[2])))
        acc = (acc + st.astype(F32)).astype(F32)
    return acc


def _tile_sums(x):
    """A row's sum over its last axis (keys) as the kernels take it: in each
    64-key tile lane t adds keys 8 j + 2 t and 8 j + 2 t + 1 for j = 0..7 in
    order, from 0; the four lanes as (t0 + t1) + (t2 + t3); the tiles' sums
    in order, from 0."""
    T = x.shape[-1]
    n = -(-T // 64)
    xp = np.zeros(x.shape[:-1] + (64 * n,), F32)
    xp[..., :T] = x
    xp = xp.reshape(x.shape[:-1] + (n, 8, 4, 2))  # tile, j, lane t, pair e
    lane = np.zeros(x.shape[:-1] + (n, 4), F32)
    for j in range(8):
        for e in range(2):
            lane = lane + xp[..., j, :, e]
    tile = (lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3])
    total = np.zeros(x.shape[:-1], F32)
    for i in range(n):
        total = total + tile[..., i]
    assert total.dtype == F32
    return total[..., None]


def _softmax_rows(q, k, mask, causal):
    """The scores and the row statistics of the forward and of the backward
    at the same T: ``(y, z)`` with s = (q.k * scale) + bias, m the row max,
    y = exp(s - m); at T <= 128 z is the tiles' sum of y, above it the
    running sum over 64-key tiles (each step l * exp(m_old - m_new) + the
    tile's sum of exp(s - m_new))."""
    T, hd = q.shape[-2], q.shape[-1]
    keep = (mask > 0)[:, None, None, :]
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None, None]
    bias = np.where(keep, F32(0), F32(k8a.MASKED)).astype(F32)
    s = _tc(q, k) * F32(k8a.scale_for(hd)) + bias
    assert s.dtype == F32
    m = s.max(-1, keepdims=True)
    y = np.exp(s - m)
    if T <= k8a.ONE_PASS_T:
        return y, _tile_sums(y)
    mr = np.full(s.shape[:-1] + (1,), -np.inf, F32)
    z = np.zeros_like(mr)
    for t0 in range(0, T, 64):
        st = s[..., t0:t0 + 64]
        mn = np.maximum(mr, st.max(-1, keepdims=True))
        z = z * np.exp(mr - mn)
        mr = mn
        z = z + _tile_sums(np.exp(st - mr))
    assert (mr == m).all() and z.dtype == F32
    return y, z


def _k8a_f32(q, k, v, mask, causal):
    """``attn_fwd_f32``: p = y / z (a correctly rounded division), ctx = p . v
    on the tensor cores over the keys."""
    y, z = _softmax_rows(q, k, mask, causal)
    return _tc(y / z, np.swapaxes(v, -1, -2))


def _k8a_bwd_f32(q, k, v, mask, causal, g):
    """The backward's order of work (``attn_bwd_f32`` at T <= 128;
    ``attn_bwd_dq_f32`` and the key-block kernel above): dP = dctx . v^T, D
    the tiles' sum of (dP * (1 / (z * z))) * y, dS = ((dP / z) + (-D)) * y *
    scale; dQ = dS . k over the keys, dK = dS^T . q and dV = p^T . dctx over
    the queries, each on the tensor cores."""
    y, z = _softmax_rows(q, k, mask, causal)
    scale = F32(k8a.scale_for(q.shape[-1]))
    dp = _tc(g, v)
    rz2 = F32(1) / (z * z)
    D = _tile_sums((dp * rz2) * y)
    ds = ((dp / z) + (-D)) * y * scale
    assert ds.dtype == F32
    kT, qT, gT = (np.swapaxes(t, -1, -2) for t in (k, q, g))
    p = y / z
    return (_tc(ds, kT), _tc(np.swapaxes(ds, -1, -2), qT), _tc(np.swapaxes(p, -1, -2), gT))


def _jax_core(q, k, v, bias):
    """``protnote_tpu/models/text_transformer.py:_attention``, lines 182-190,
    in float32 (``Precision.HIGHEST``)."""
    hd = q.shape[-1]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32,
                        precision=jax_gemm_precision(q.dtype)) / math.sqrt(hd)
    probs = jax.nn.softmax(scores + bias, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v, preferred_element_type=jnp.float32,
                      precision=jax_gemm_precision(v.dtype)).astype(q.dtype)


def _attention_inputs(T, causal, seed, large=False):
    """hd 64, 2 heads (one at 512 tokens); rows: every key kept, the first
    keys masked and the rest ragged, all keys masked (a padded chunk's
    filler row).  ``large``: q and k rows of norm 15.4 drawn around eight
    shared directions (each key's sign at random), so that scores reach
    about +-27 and stay inside +-29.7, below the 32 past which -1e9 + s on
    a masked key would no longer round to -1e9."""
    rng = np.random.default_rng(seed)
    nh = 1 if T > 256 else 2
    q, k, v, g = (rng.normal(size=(3, nh, T, 64)).astype(F32) * s for s in (1.5, 1.5, 1.0, 0.5))
    if large:
        u = rng.normal(size=(8, 64))

        def rows(sign):
            x = u[rng.integers(0, 8, size=(3, nh, T))] * sign + \
                0.3 * rng.normal(size=(3, nh, T, 64))
            return (15.4 * x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(F32)

        q, k = rows(1.0), rows(rng.choice([-1.0, 1.0], size=(3, nh, T, 1)))
    mask = np.zeros((3, T), np.int32)
    mask[0] = 1
    mask[1, min(3, T - 1): max(T * 2 // 3, 4)] = 1
    keep = mask[:, None, None, :] > 0
    if causal:
        keep = keep & np.tril(np.ones((T, T), bool))[None, None]
    return q, k, v, g, mask, np.where(keep, 0.0, -1e9).astype(F32)


CASES = [(T, causal) for T in (16, 128, 200, 512) for causal in (False, True)]


def _check_forward(T, causal, seed, large=False):
    q, k, v, _, mask, bias = _attention_inputs(T, causal, seed, large)
    if large:
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / 8
        assert 25 < np.abs(s).max() < 30
    want = np.asarray(jax.jit(_jax_core)(*(jnp.asarray(t) for t in (q, k, v, bias))))
    got = _k8a_f32(q, k, v, mask, causal)
    _close(got, want, "ctx")
    _close(got[2], np.broadcast_to(v[2].mean(1, keepdims=True), v[2].shape), "filler row")


def _check_backward(T, causal, seed, large=False):
    q, k, v, g, mask, bias = _attention_inputs(T, causal, seed, large)
    _, vjp = jax.vjp(lambda a, b, c: _jax_core(a, b, c, jnp.asarray(bias)),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _k8a_bwd_f32(q, k, v, mask, causal, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, np.asarray(b), name)


@pytest.mark.parametrize("T,causal", CASES)
def test_attention_f32_kernel_algorithm_matches_jax(T, causal):
    """``attn_fwd_f32``'s order of work (one pass at T <= 128, the running
    sum above) against the JAX core in float32; the all-masked row is
    JAX's uniform softmax over all T keys."""
    _check_forward(T, causal, seed=T + causal)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_f32_kernel_algorithm_matches_jax_at_large_scores(causal):
    """The same at 128 tokens with scores of about +-27: the split's error in
    each score reaches expf at 27 times its size."""
    _check_forward(128, causal, seed=70 + causal, large=True)


@pytest.mark.parametrize("T,causal", CASES)
def test_attention_backward_f32_kernel_algorithm_matches_jax_vjp(T, causal):
    """The backward's order of work (one kernel at T <= 128 with the row
    statistics from its two key halves; above 128 the dQ kernel's three
    passes and the key-block kernel) against ``jax.vjp`` of the JAX core in
    float32."""
    _check_backward(T, causal, seed=3 * T + causal)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_backward_f32_kernel_algorithm_matches_jax_vjp_at_large_scores(causal):
    """The same at 128 tokens with scores of about +-27."""
    _check_backward(128, causal, seed=80 + causal, large=True)


def _k8b_f32(x, r, scale, bias, eps):
    """The float32 K8b: v = x + r; lane l's columns (c * 32 + l) * 8 + e of
    chunk c; eight partial sums a lane over the chunks, ((p0 + p1) + (p2 +
    p3)) + ((p4 + p5) + (p6 + p7)), the butterfly; two-pass moments.
    Returns y, the lanes' view of v, mu and rstd."""
    N, H = x.shape
    v = x if r is None else x + r
    lanes = v.reshape(N, H // 256, 32, 8)
    mu = _row_sum(lanes) / F32(H)
    d = lanes - mu[:, None, None, None]
    rs = (1.0 / np.sqrt((_row_sum(d * d) / F32(H) + F32(eps)).astype(np.float64))).astype(F32)
    y = (d * rs[:, None, None, None]) * scale.reshape(-1, 32, 8) + bias.reshape(-1, 32, 8)
    assert y.dtype == F32
    return y.reshape(N, H), lanes, mu, rs


def _row_sum(vals):
    """(N, chunks, 32, 8): K8b's row sum (the lanes' eight partial sums over
    the chunks in order, the tree, the butterfly)."""
    p = vals[:, 0]
    for c in range(1, vals.shape[1]):
        p = p + vals[:, c]
    s = ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])) + \
        ((p[..., 4] + p[..., 5]) + (p[..., 6] + p[..., 7]))
    return _butterfly(s)


def _k8b_bwd_f32(lanes, mu, rs, scale, g, blocks):
    """The float32 K8b-bwd from the forward's mu and rstd: xh = (v - mu) *
    rstd, gh = g * scale, dx = ((gh - mean(gh)) - xh * mean(gh * xh)) *
    rstd with K8b's row sums; dscale and dbias in the grid's order: warp w
    of block b walks rows b * 4 + w + k * (4 * blocks), a block adds its 4
    warps in order, then the blocks are added in order."""
    N, H = g.shape
    xh = (lanes - mu[:, None, None, None]) * rs[:, None, None, None]
    gl = g.reshape(lanes.shape)
    gh = gl * scale.reshape(-1, 32, 8)
    ma = _row_sum(gh) / F32(H)
    mb = _row_sum(gh * xh) / F32(H)
    dx = ((gh - ma[:, None, None, None]) - xh * mb[:, None, None, None]) * rs[:, None, None, None]
    sums = []
    for term in (gl * xh, gl):
        term = term.reshape(N, H)
        total = np.zeros(H, F32)
        for b in range(blocks):
            block = None
            for w in range(4):
                acc = np.zeros(H, F32)
                for row in range(b * 4 + w, N, 4 * blocks):
                    acc = acc + term[row]
                block = acc if block is None else block + acc
            total = total + block
        sums.append(total)
    return dx.reshape(N, H), sums[0], sums[1]


@pytest.mark.parametrize("H", [256, 1024])
@pytest.mark.parametrize("residual", [True, False])
def test_layer_norm_f32_kernel_algorithm_matches_jax_and_vjp(H, residual):
    """K8b f32's lane-chunked two-pass moments against the JAX
    ``_layer_norm(p, x + a)`` in float32, and K8b-bwd f32 (the row kernel's
    sums, dscale and dbias over 515 rows walked by a grid of 16 blocks and
    by the wrapper's grid on 132 SMs) against ``jax.vjp`` of it: dx (also
    the residual's gradient), dscale and dbias."""
    rng = np.random.default_rng(H + residual)
    N = 515
    x = (rng.normal(size=(N, H)) * 2 + 5).astype(F32)
    a = rng.normal(size=(N, H)).astype(F32)
    g = rng.normal(size=(N, H)).astype(F32)
    p = {"scale": rng.uniform(0.5, 1.5, H).astype(F32), "bias": rng.normal(size=H).astype(F32)}

    def jax_ln(x_, a_, scale, bias):
        return jtt._layer_norm({"scale": scale, "bias": bias}, x_ + a_ if residual else x_, 1e-5)

    y_want, vjp = jax.vjp(jax_ln, *(jnp.asarray(t) for t in (x, a, p["scale"], p["bias"])))
    dx_want, da_want, ds_want, db_want = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    y, lanes, mu, rs = _k8b_f32(x, a if residual else None, p["scale"], p["bias"], 1e-5)
    _close(y, np.asarray(y_want), "y")
    rows_blocks = max(1, min(-(-N // 4), k8b._BWD_BLOCKS_PER_SM * 132))
    for blocks in (16, rows_blocks):
        dx, dscale, dbias = _k8b_bwd_f32(lanes, mu, rs, p["scale"], g, blocks)
        _close(dx, dx_want, "dx")
        if residual:
            _close(dx, da_want, "d residual")
        _close(dscale, ds_want, "dscale")
        _close(dbias, db_want, "dbias")


# ----------------------------------------------------------------------
# the dispatch by dtype


def _exported(library: str) -> dict:
    """The C entry points of ``csrc/<library>.cu``: name -> parameter count."""
    src = (CSRC_DIR / f"{library}.cu").read_text()
    return {name: len(params.split(","))
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}


def test_attention_dispatch_picks_the_f32_kernels_by_dtype():
    """float32 q, k, v take ``csrc/text_attention_f32.cu``'s forward and
    backward (one kernel up to 128 tokens, two above), bf16 its own (the
    same counts); the entry points exist in the sources with as many
    parameters as the wrappers' ctypes signatures; float16 and mixed dtypes
    raise before the device is looked at."""
    f32 = k8a.entry_points(torch.float32)
    assert f32 == {"forward": ("text_attention_f32", "masked_attention_f32"),
                   "backward": ("text_attention_f32", "masked_attention_backward_f32")}
    bf16 = k8a.entry_points(torch.bfloat16)
    assert bf16 == {"forward": ("text_attention", "masked_attention"),
                    "backward": ("text_attention_bwd", "masked_attention_backward")}
    for lib, symbol in f32.values():  # the wrappers' ctypes signatures fit the sources
        assert symbol in _exported(lib), (lib, symbol)
    assert _exported("text_attention_f32") == {"masked_attention_f32": len(k8a._FWD_ARGS),
                                               "masked_attention_backward_f32":
                                                   len(k8a._BWD_ARGS)}
    assert _exported("text_attention")["masked_attention"] == len(k8a._FWD_ARGS)
    assert _exported("text_attention_bwd")["masked_attention_backward"] == len(k8a._BWD_ARGS)
    assert [k8a.backward_launches(T, torch.float32) for T in (1, 16, 128, 129, 512)] == \
        [1, 1, 1, 2, 2]
    assert [k8a.backward_launches(T) for T in (16, 128, 129, 512)] == [1, 1, 2, 2]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k8a.entry_points(torch.float16)
    mask = torch.ones(1, 8, dtype=torch.int32)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="share a dtype"):
        k8a._check_cuda(q, q.to(torch.bfloat16), q, mask)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k8a._check_cuda(q.half(), q.half(), q.half(), mask)
    for dtype in (torch.float32, torch.bfloat16):  # taken: only the device is refused here
        t = q.to(dtype)
        with pytest.raises(ValueError, match="CUDA tensors"):
            k8a._check_cuda(t, t, t, mask)
    with pytest.raises(ValueError, match="bfloat16"):
        k8a.two_kernel_backward_cuda(q, q, q, mask, False, q)


def test_layer_norm_dispatch_picks_the_f32_kernels_by_dtype():
    """float32 x takes the ``_f32`` entry points of ``csrc/layer_norm.cu``
    forward and backward, whose parameters match the bf16 ones and the
    wrappers' ctypes signatures; the residual and x must share the dtype;
    float16 raises."""
    assert k8b.entry_points(torch.float32) == ("add_layer_norm_f32",
                                               "add_layer_norm_backward_f32")
    assert k8b.entry_points(torch.bfloat16) == ("add_layer_norm", "add_layer_norm_backward")
    forward, backward = len(k8b._ARGS), len(k8b._BWD_ARGS)
    assert _exported("layer_norm") == {"add_layer_norm": forward, "add_layer_norm_f32": forward,
                                       "add_layer_norm_backward": backward,
                                       "add_layer_norm_backward_f32": backward}
    x, ones = torch.zeros(4, 256), torch.ones(256)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        k8b._check_cuda(x.half(), None, ones, ones)
    with pytest.raises(ValueError, match="residual"):
        k8b._check_cuda(x, x.to(torch.bfloat16), ones, ones)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensors"):
            k8b._check_cuda(x.to(dtype), x.to(dtype), ones, ones)


# ----------------------------------------------------------------------
# the native label-embedding generator


@pytest.mark.parametrize("dtype,want", [(None, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_native_label_encoder_computes_in_float32_on_the_card(dtype, want, monkeypatch):
    """``NativeLabelEncoder.from_pretrained(device="cuda")`` with ``dtype``
    None builds a float32 tower, as ``JaxLabelEncoder`` computes; bf16 only
    when asked for.  So does ``build_label_encoder(..., backend="native")``,
    which ``cli/generate_label_embeddings.py`` calls.  (The checkpoint reader
    and the move to the card are patched out.)"""
    asked = []

    def load(checkpoint, dtype_, local_files_only=True):
        asked.append(dtype_)
        cfg = TextEncoderConfig(vocab_size=10, hidden_size=256, num_layers=1, num_heads=4,
                                intermediate_size=8, dtype=dtype_)
        return cfg, {"word_embeddings": torch.zeros(10, 256)}, None

    monkeypatch.setattr(tle, "load_pretrained_tower", load)
    monkeypatch.setattr(tle, "tree_to", lambda tree, device: tree)
    enc = tle.NativeLabelEncoder.from_pretrained("ckpt", dtype=dtype, device="cuda")
    assert enc.cfg.dtype == want and enc.device.type == "cuda"
    assert enc.params["word_embeddings"].dtype == want
    if dtype is None:
        enc = tle.build_label_encoder("ckpt", device="cuda", allow_fallback=False,
                                      backend="native")
        assert enc.cfg.dtype == torch.float32
    assert asked == [want] * len(asked) and asked
