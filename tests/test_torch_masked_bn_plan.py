"""K7-BN's kernels (protnote_tpu_torch/csrc/masked_bn.cu) on the CPU: their
order of work emulated in numpy against the JAX ``batchnorm_apply`` + ReLU
under the encoder's count rule, their chunk plans, the statistics kernel's
walk over the valid rows, and the wrapper's pitch rule on the plain path.

The emulation follows the kernels: the statistics in equal runs of the
valid rows (``bn_plan(...).stat_chunks`` of them, some empty where there
are fewer rows than chunks), each run's moments about its first row's x,
turned into (S, M2, n) and combined in the kernels' fixed order (thread q
of a column adds runs q, q + 4, ..., then the 4 threads in order: each
apply and dx block's combine); y written chunk by chunk in the reverse
order; the gradient sums G, Gx over every
row in chunks of ``sum_rows``, added in the same order; dx in blocks that
take each sums chunk from its end, the ends of all chunks first.  It runs
in float32 (the kernels' arithmetic; bf16 rounding is the card tests'
business).

Inputs are drawn with numpy from fixed seeds: 4 sequences at T 40 with
lengths 40, 23, 7 and 0, with and without an example mask that drops a
row, C 110, 550 and 1,100 (the encoder's widths), activations centred at
0.4 and at 8 (where a variance from raw sums would lose its digits).
Tolerances: float32 within 1e-5 of each tensor's largest |value| of JAX's
float32 result and of a float64 computation, as F32_REL in
tests/test_torch_masked_conv.py (only the summation order differs);
layouts and plans exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import layers as jlayers
from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.ops import masked_conv as k7

B, T = 4, 40
LENGTHS = np.array([40, 23, 7, 0], np.int32)
EM = np.array([1, 0, 1, 1], np.float32)
F32_REL = 1e-5
EPS, MOMENTUM = jpi.BN_EPS, jpi.BN_MOMENTUM
ROW_LANES = 32  # rows a kernel block walks at once (csrc/masked_bn.cu)
SPLIT = 4  # a combining block's threads on one column (csrc/masked_bn.cu)


def _combine(terms):
    """float32 sum of per-chunk terms in a combine's order: thread q adds
    chunks q, q + SPLIT, ..., then the threads' sums in q order."""
    per_thread = [np.sum([terms[k] for k in range(q, len(terms), SPLIT)], axis=0,
                         dtype=np.float32) if q < len(terms) else np.float32(0)
                  for q in range(SPLIT)]
    total = per_thread[0]
    for v in per_thread[1:]:
        total = total + v
    return total


def _close(got, want, rel=F32_REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


def _count_rule(em):
    """The (B, T) mask m and the JAX count n."""
    m = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)
    if em is None:
        return m, max(float(B) * float(LENGTHS.max()), 1.0)
    return m * em[:, None], max(float(em.sum()) * float((LENGTHS * em).max()), 1.0)


def _jax_bn_relu(p, s, x, em):
    lengths = jnp.asarray(LENGTHS)
    mask = jpi.length_mask(lengths, T)
    lengths_f = lengths.astype(jnp.float32)
    if em is None:
        bn_mask, rows, t_ref = mask, jnp.float32(B), jnp.max(lengths_f)
    else:
        e = jnp.asarray(em)
        bn_mask, rows, t_ref = mask * e[:, None, None], jnp.sum(e), jnp.max(lengths_f * e)
    y, new = jlayers.batchnorm_apply(p, s, x, True, eps=EPS, momentum=MOMENTUM,
                                     reduce_axes=(0, 1), mask=bn_mask,
                                     count=jnp.maximum(rows * t_ref, 1.0))
    return jax.nn.relu(y), new


def _valid_table(em):
    """The statistics kernel's table: each sequence's rows that count and
    their prefix sums."""
    e = np.ones(B, np.float32) if em is None else em
    lens = np.where(e != 0, np.clip(LENGTHS, 0, T), 0)
    return lens, np.concatenate([[0], np.cumsum(lens)]), e


def _walk(lens, start, j0, j1, rl):
    """The rows (b, t) row lane ``rl`` visits in a statistics block of valid
    rows [j0, j1): ``locate`` then steps of 32, as the kernel's loop."""
    out, j = [], j0 + rl
    if j >= j1:
        return out
    b = int(np.searchsorted(start, j, side="right")) - 1
    t = j - start[b]
    while j < j1:
        out.append((b, t))
        j, t = j + ROW_LANES, t + ROW_LANES
        while b < B and t >= lens[b]:
            t -= lens[b]
            b += 1
    return out


def _emulate_forward(x, p, s, em):
    """The statistics kernel (chunks of valid rows, moments about each
    chunk's first row, the ordered combine) and the apply (chunks
    reversed), in float32: ``(y, new_mean, new_var, mean, inv, shift, n)``."""
    C = x.shape[2]
    f = np.float32
    lens, start, e = _valid_table(em)
    plan = k7.bn_plan(B * T, C)
    rows = [(b, t) for b in range(B) for t in range(lens[b])]
    parts = []
    for j0, j1 in k7.chunk_ranges(len(rows), plan.stat_chunks):
        visited = sorted(r for rl in range(ROW_LANES) for r in _walk(lens, start, j0, j1, rl))
        assert visited == sorted(rows[j0:j1])  # each valid row of the run once
        if j0 == j1:
            parts.append((f(0), np.zeros(C, f), np.zeros(C, f)))
            continue
        xs = np.stack([x[b, t] for b, t in rows[j0:j1]])
        w = np.array([e[b] for b, _ in rows[j0:j1]], f)[:, None]
        K = xs[0]
        d = xs - K
        S, D, Q, nk = (w * xs).sum(0), (w * d).sum(0), (w * d * d).sum(0), w.sum(dtype=f)
        parts.append((nk, S, np.maximum(Q - D * (D / nk), f(0))))
    m, n = _count_rule(em)
    n, nv = f(n), f(max(m.sum(), 1.0))
    assert len(parts) <= 8 * SPLIT
    mean = _combine([Sk for _, Sk, _ in parts]) / n
    terms = []
    for nk, Sk, M2 in parts:
        dm = Sk / nk - mean if nk > 0 else np.zeros(C, f)
        terms.append(M2 + nk * dm * dm if nk > 0 else np.zeros(C, f))
    v = _combine(terms)
    var = (v + (n - nv) * mean * mean) / n
    rstd = f(1) / np.sqrt(var + f(EPS))
    inv = rstd * p["scale"]
    shift = p["bias"] - mean * inv
    y = np.full((B * T, C), np.nan, f)
    flat = x.reshape(B * T, C)
    for r0, r1 in reversed(k7.chunk_ranges(B * T, plan.apply_chunks)):
        assert np.isnan(y[r0:r1]).all()  # no row written twice
        y[r0:r1] = np.maximum(flat[r0:r1] * inv + shift, f(0))
    unbiased = var * (n / max(n - f(1), f(1)))
    new_mean = f(1 - MOMENTUM) * s["mean"] + f(MOMENTUM) * mean
    new_var = f(1 - MOMENTUM) * s["var"] + f(MOMENTUM) * unbiased
    return y.reshape(B, T, C), new_mean, new_var, mean, rstd, inv, shift, n


def _emulate_backward(x, g, p, fwd, em):
    """The gradient sums (gate from x, chunks of every row, added in order)
    and dx (chunks reversed), in float32: ``(dx, dscale, dbias)``."""
    _, _, _, mean, rstd, inv, shift, n = fwd
    C = x.shape[2]
    f = np.float32
    plan = k7.bn_plan(B * T, C)
    flat, gf = x.reshape(B * T, C), g.reshape(B * T, C)
    gz = np.where(flat * inv + shift > 0, gf, f(0))
    ranges = _sum_chunks(B * T, plan)
    assert all(r1 > r0 for r0, r1 in ranges) and len(ranges) <= 8 * SPLIT
    G = _combine([gz[r0:r1].sum(0) for r0, r1 in ranges])
    Gx = _combine([(gz[r0:r1] * (flat[r0:r1] - mean)).sum(0) for r0, r1 in ranges])
    k2 = -(inv * G) / n
    k3 = -(p["scale"] * (rstd * rstd * rstd) * Gx) / n
    m, _ = _count_rule(em)
    m = m.reshape(B * T, 1)
    dx = np.full_like(flat, np.nan)
    for r0, r1 in _dx_blocks(B * T, plan.sum_rows, plan.apply_rows):
        assert np.isnan(dx[r0:r1]).all()  # no row written twice
        dx[r0:r1] = inv * gz[r0:r1] + m[r0:r1] * (k2 + k3 * (flat[r0:r1] - mean))
    return dx.reshape(B, T, C), Gx * rstd, G


def _sum_chunks(rows, plan):
    """The backward blocks' rows: chunk k is [k sum_rows, (k + 1) sum_rows)."""
    return [(k * plan.sum_rows, min(rows, (k + 1) * plan.sum_rows))
            for k in range(plan.sum_chunks)]


def _dx_blocks(rows, sum_rows, per_block):
    """The rows [r0, r1) of dx's blocks in launch order: block j takes the
    (j // sum_chunks)-th run of ``per_block`` rows from the end of sums chunk
    j % sum_chunks (``bn_dx_kernel``); empty blocks left out."""
    sum_chunks = -(-rows // sum_rows)
    out = []
    for j in range(sum_chunks * -(-sum_rows // per_block)):
        k, run = j % sum_chunks, j // sum_chunks
        r1 = min(rows, (k + 1) * sum_rows) - run * per_block
        r0 = max(k * sum_rows, r1 - per_block)
        if r1 > r0:
            out.append((r0, r1))
    return out


def _inputs(rng, C, centre):
    p = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": rng.normal(0, 0.3, C).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.2, C).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    valid = np.arange(T)[None, :, None] < LENGTHS[:, None, None]
    x = ((rng.normal(0, 0.7, (B, T, C)) + centre) * valid).astype(np.float32)
    return p, s, x, rng.normal(0, 1, (B, T, C)).astype(np.float32)


def _float64(x, g, p, em):
    """The same function in float64: (y, mean, var, dx, dscale, dbias)."""
    m, n = _count_rule(em)
    m = m[..., None].astype(np.float64)
    xf = x.astype(np.float64)
    nv = max(m.sum(), 1.0)
    mean = (xf * m).sum((0, 1)) / n
    var = (((xf - mean) ** 2 * m).sum((0, 1)) + (n - nv) * mean ** 2) / n
    rstd = 1.0 / np.sqrt(var + EPS)
    inv = rstd * p["scale"]
    pre = xf * inv + (p["bias"] - mean * inv)
    gz = np.where(pre > 0, g, 0.0)
    G, Gx = gz.sum((0, 1)), (gz * (xf - mean)).sum((0, 1))
    dx = inv * gz + m / n * (-inv * G - p["scale"] * rstd ** 3 * Gx * (xf - mean))
    return np.maximum(pre, 0.0), mean, var, dx, Gx * rstd, G


@pytest.mark.parametrize("C", [110, 550, 1100])
@pytest.mark.parametrize("em", [None, EM], ids=["no_mask", "example_mask"])
@pytest.mark.parametrize("centre", [0.4, 8.0])
def test_kernel_order_matches_jax_and_float64(C, em, centre):
    """y, the running statistics, dx, dscale and dbias of the emulated
    kernels against JAX's float32 forward and autodiff and against float64,
    each within 1e-5 of the tensor's largest |value|."""
    rng = np.random.default_rng(C + int(centre * 10) + (0 if em is None else 1))
    p, s, x, g = _inputs(rng, C, centre)
    jp, js = (jax.tree_util.tree_map(jnp.asarray, t) for t in (p, s))

    def f(x, p):
        y, new = _jax_bn_relu(p, js, x, em)
        return jnp.sum(y * jnp.asarray(g)), (y, new)

    (_, (want_y, want_new)), (dx_w, dp_w) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jp)
    fwd = _emulate_forward(x, p, s, em)
    y, new_mean, new_var = fwd[:3]
    dx, dscale, dbias = _emulate_backward(x, g, p, fwd, em)
    y64, mean64, var64, dx64, ds64, db64 = _float64(x, g, p, em)
    _close(y, want_y, name="y")
    _close(y, y64, name="y f64")
    _close(new_mean, want_new["mean"], name="mean")
    _close(new_var, want_new["var"], name="var")
    _close(fwd[3], mean64, name="batch mean f64")
    _close((fwd[5] / p["scale"]) ** -2 - EPS, var64, name="batch var f64")
    _close(dx, dx_w, name="dx")
    _close(dx, dx64, name="dx f64")
    _close(dscale, dp_w["scale"], name="dscale")
    _close(dscale, ds64, name="dscale f64")
    _close(dbias, dp_w["bias"], name="dbias")
    _close(dbias, db64, name="dbias f64")
    assert 0.2 < float((y > 0).mean()) < 0.9


def test_statistics_walk_leaves_no_valid_row_out_with_empty_chunks():
    """C 110 has 2 slices and 32 statistics chunks over the 70 valid rows:
    runs of 3, the 24th of one row, the last 8 empty; the row lanes' walks
    cover each row once, across sequence ends and the empty one."""
    lens, start, _ = _valid_table(None)
    plan = k7.bn_plan(B * T, 110)
    assert plan.stat_chunks == 32 and start[-1] == 70
    ranges = k7.chunk_ranges(int(start[-1]), plan.stat_chunks)
    assert [r1 - r0 for r0, r1 in ranges] == [3] * 23 + [1] + [0] * 8
    seen = [r for j0, j1 in ranges for rl in range(ROW_LANES) for r in _walk(lens, start, j0, j1, rl)]
    assert seen == [(b, t) for b in range(B) for t in range(lens[b])]


@pytest.mark.parametrize("rows,chunks", [(32 * 512, 14), (32 * 512, 29), (32 * 1024, 14),
                                         (32 * 1024, 29), (32 * 512, 64), (32 * 1024, 128),
                                         (1, 14), (13, 29), (1009, 14), (9797, 29), (0, 3)])
def test_chunk_ranges_put_every_row_in_exactly_one_chunk(rows, chunks):
    ranges = k7.chunk_ranges(rows, chunks)
    assert len(ranges) == chunks
    covered = np.zeros(rows, np.int64)
    for r0, r1 in ranges:
        assert 0 <= r0 <= r1 <= rows
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert [r0 for r0, _ in ranges] == sorted(r0 for r0, _ in ranges)


@pytest.mark.parametrize("rows,C", [(32 * 512, 1100), (32 * 512, 550), (32 * 1024, 1100),
                                    (32 * 1024, 550), (160, 110), (21, 13)])
def test_dx_blocks_take_every_row_once_the_sums_chunks_ends_first(rows, C):
    plan = k7.bn_plan(rows, C)
    blocks = _dx_blocks(rows, plan.sum_rows, plan.apply_rows)
    covered = np.zeros(rows, np.int64)
    for r0, r1 in blocks:
        covered[r0:r1] += 1
    assert (covered == 1).all()
    ends = [min(rows, (k + 1) * plan.sum_rows) for k in range(plan.sum_chunks)]
    assert [r1 for _, r1 in blocks[:plan.sum_chunks]] == ends


@pytest.mark.parametrize("B_,T_,C", [(32, 512, 1100), (32, 512, 550), (32, 1024, 1100),
                                     (32, 1024, 550), (5, 200, 110), (3, 7, 13)])
def test_bn_plan_grids_cover_every_row_and_channel(B_, T_, C):
    plan = k7.bn_plan(B_ * T_, C)
    assert plan.slices * k7.BN_SLICE >= k7.row_pitch(C) > (plan.slices - 1) * k7.BN_SLICE
    ranges = _sum_chunks(B_ * T_, plan)
    assert ranges[-1][1] == B_ * T_ and all(0 < r1 - r0 <= plan.sum_rows for r0, r1 in ranges)
    for chunks, per in ((plan.sum_chunks, plan.sum_rows), (plan.apply_chunks, plan.apply_rows)):
        assert chunks * per >= B_ * T_ > (chunks - 1) * per


@pytest.mark.parametrize("em", [None, EM], ids=["no_mask", "example_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_on_a_padded_pitch_gives_the_contiguous_bits(em, dtype):
    """``masked_bn_relu_train`` on the CPU: an input at the padded pitch (a
    view of a wider buffer whose extra channels hold NaN) gives the same
    bits, running statistics and gradients as its contiguous copy, and its
    output lies at ``row_pitch(C)``."""
    rng = np.random.default_rng(5)
    C = 110
    p, s, x, g = _inputs(rng, C, 0.4)
    wide = torch.full((B, T, k7.row_pitch(C)), float("nan"), dtype=dtype)
    wide[..., :C] = torch.from_numpy(x).to(dtype)
    outs = []
    for xin in (wide[..., :C], wide[..., :C].contiguous()):
        xg = xin.detach().requires_grad_(True)
        tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
        y, new = k7.masked_bn_relu_train(xg, tp, {k: torch.from_numpy(v) for k, v in s.items()},
                                         torch.from_numpy(LENGTHS),
                                         None if em is None else torch.from_numpy(em), EPS,
                                         MOMENTUM)
        (y.float() * torch.from_numpy(g)).sum().backward()
        assert k7.pitch_of(y) == k7.row_pitch(C)
        outs.append((y.detach(), new["mean"], new["var"], xg.grad, tp["scale"].grad,
                     tp["bias"].grad))
    assert k7.pitch_of(outs[0][0]) == k7.pitch_of(outs[1][0])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
