"""K7's masked mean pool (``csrc/masked_pool.cu``) and K9's threshold-sweep
update (``csrc/threshold_sweep.cu``) on the CPU: their launch plans and
their order of work, emulated in numpy, against the JAX package and the
port's plain versions.  The kernels themselves run only on a card
(``tests/test_torch_kernels_cuda.py``).

* The pool's plan (``ops/masked_conv.py:pool_plan``): the forward's
  channel groups x row slots x lanes cover each valid (sequence, row,
  channel) once and no row past a length; the backward's blocks write each
  row of the padded pitch once.  Its order of sums (a row slot's rows in
  order, then the 32 slots in order, then ``__fdiv_rn``) in float32 is
  within 1e-5 of JAX's ``jnp.sum(...) / denom`` and of
  ``masked_mean_pool_reference`` (the tolerance of ``chip_smoke.py``'s
  ``K7_F32_REL_TOL``: float32 sums in other orders).
* The pool's transpose (``masked_mean_pool_backward_reference``) is bit for
  bit the bf16 vjp of the JAX pool and the plain pool's autograd.
* K9's update: each batch's slot codes (k through the bucket table and a
  search inside its range) into a ring of ``RING_ROWS`` rows, flushed when
  full and at the end (mid-evaluation for the larger batches): byte counts
  a (slot, column) of a 128-column block over chunks of 255 rows, slot
  ranges of ``flush_plan``, the nonzero counts added to the histogram;
  bit-equal to the histogram of
  ``tests/test_torch_threshold_sweep.py:_emulated_update`` and, through
  ``finalize_reference``, to the JAX ``Trainer._sweep_count_fn``'s counts
  (probabilities drawn 1e-6 from every threshold, as there).
* The constants and ctypes signatures of both wrappers against the C
  sources.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models.proteinfer import length_mask
from protnote_tpu.train.trainer import Trainer as JaxTrainer
from protnote_tpu_torch.ops import kernels
from protnote_tpu_torch.ops import masked_conv as k7
from protnote_tpu_torch.ops import threshold_sweep as k9
from tests import test_torch_threshold_sweep as sweep_tests

F32_REL = 1e-5  # chip_smoke.py K7_F32_REL_TOL


def _lengths(T, B=6, seed=0):
    """Lengths 0, 1, T, T + 5 (past the bucket) and ragged ones."""
    rng = np.random.default_rng(seed + T)
    ragged = rng.integers(1, T + 1, size=B - 4)
    return np.array([0, 1, T, T + 5, *ragged], np.int32)[:B]


def _bf16(rng, *shape):
    """bf16-representable float32 values and their bf16 tensor."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
    return x.float().numpy(), x


# ----------------------------------------------------------------------
# the pool


@pytest.mark.parametrize("C", [110, 1100])
@pytest.mark.parametrize("T", [1, 7, 512, 1024])
def test_pool_plan_covers_each_valid_element_once(T, C):
    lens = _lengths(T)
    B = len(lens)
    plan = k7.pool_plan(T, C, k7.row_pitch(C))
    assert plan.width == 8 and plan.lanes * plan.slots == k7.POOL_THREADS
    # forward: block (group, b); thread i: slot i // lanes, lane i % lanes;
    # rows slot + slots * j below the length, channels below C
    cover = np.zeros((B, T, C), np.int32)
    i = np.arange(k7.POOL_THREADS)
    slot, lane = i // plan.lanes, i % plan.lanes
    j = np.arange(k7.POOL_LANE)
    for b, n in enumerate(np.minimum(np.maximum(lens, 0), T)):
        for group in range(plan.groups):
            t = slot[:, None] + plan.slots * np.arange(-(-T // plan.slots))[None, :]
            c = k7.POOL_GROUP_CHANNELS * group + k7.POOL_LANE * lane[:, None] + j[None, :]
            tt = np.broadcast_to(t[:, :, None], (len(i), t.shape[1], len(j)))
            cc = np.broadcast_to(c[:, None, :], tt.shape)
            hit = (tt < n) & (cc < C)
            np.add.at(cover, (b, tt[hit], cc[hit]), 1)
    valid = np.arange(T)[None, :, None] < np.minimum(lens, T)[:, None, None]
    np.testing.assert_array_equal(cover, np.broadcast_to(valid, cover.shape).astype(np.int32))
    # backward: block (chunk, b), every row and channel of the padded pitch once
    P = k7.row_pitch(C)
    lanes = P // k7.POOL_LANE
    assert plan.bwd_threads >= k7.POOL_BWD_GROUPS * lanes and plan.bwd_threads % 32 == 0
    assert plan.bwd_threads <= k7.POOL_BWD_GROUPS * k7.POOL_MAX_CHANNELS // k7.POOL_LANE
    rows = k7.POOL_BWD_ROWS // k7.POOL_BWD_GROUPS
    written = np.zeros((T, P), np.int32)
    for chunk in range(-(-T // k7.POOL_BWD_ROWS)):
        t = chunk * k7.POOL_BWD_ROWS + np.arange(k7.POOL_BWD_GROUPS)[:, None] * rows + \
            np.arange(rows)
        c = k7.POOL_LANE * np.arange(lanes)[:, None] + np.arange(k7.POOL_LANE)
        tt, cc = np.broadcast_arrays(t.reshape(-1)[:, None], c.reshape(-1)[None, :])
        keep = tt < T
        np.add.at(written, (tt[keep], cc[keep]), 1)
    assert (written == 1).all()


@pytest.mark.parametrize("pitch,base,width", [(1104, 0, 8), (1100, 0, 4), (1100, 8, 4),
                                              (1102, 0, 2), (1101, 0, 1), (1104, 4, 2),
                                              (1104, 2, 1)])
def test_pool_plan_load_width_follows_pitch_and_base(pitch, base, width):
    """16-byte loads at the padded pitch; a contiguous 1,100-channel tensor
    (rows 2,200 bytes apart, on 8 bytes) takes 8-byte loads; narrower
    pitches and bases narrower loads."""
    assert k7.pool_plan(5, 1100, pitch, base).width == width


def _pool_emulated(x, lens):
    """The kernel's order of sums in float32: each row slot's rows (slot,
    slot + 32, ...) in order, then the 32 slots in order from 0, then the
    division by max(length, 1)."""
    B, T, C = x.shape
    slots = k7.POOL_THREADS // (k7.POOL_GROUP_CHANNELS // k7.POOL_LANE)
    out = np.zeros((B, C), np.float32)
    for b in range(B):
        n = min(max(int(lens[b]), 0), T)
        total = np.zeros(C, np.float32)
        for slot in range(slots):
            acc = np.zeros(C, np.float32)
            for t in range(slot, n, slots):
                acc = acc + x[b, t]
            total = total + acc
        out[b] = total / np.float32(max(int(lens[b]), 1))
    return out


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-30))


@pytest.mark.parametrize("C", [110, 1100])
@pytest.mark.parametrize("T", [7, 512, 1024])
def test_pool_order_matches_jax_and_plain(T, C):
    rng = np.random.default_rng(T + C)
    lens = _lengths(T, B=5)
    x, xt = _bf16(rng, len(lens), T, C)
    got = _pool_emulated(x, lens)
    feats = jnp.asarray(x, jnp.bfloat16)
    masked = feats * length_mask(jnp.asarray(lens), T).astype(feats.dtype)
    denom = jnp.maximum(jnp.asarray(lens)[:, None].astype(jnp.float32), 1.0)
    want = np.asarray(jnp.sum(masked.astype(jnp.float32), axis=1) / denom)
    plain = k7.masked_mean_pool_reference(xt, torch.from_numpy(lens)).numpy()
    assert _rel(got, want) <= F32_REL
    assert _rel(got, plain) <= F32_REL
    assert np.all(got[0] == 0) and np.isfinite(got).all()  # length 0: 0, not NaN


def _bits(t):
    return np.asarray(t).view(np.uint16) if isinstance(t, np.ndarray) else \
        t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("C", [110, 1100])
@pytest.mark.parametrize("T", [7, 512])
def test_pool_backward_reference_is_the_jax_vjp(T, C):
    """``masked_mean_pool_backward_reference`` against ``jax.vjp`` of the
    JAX pool's three lines on bf16 features, bit for bit (signed zeros
    included: a negative gradient times the mask's 0 is -0), and against
    the plain pool's autograd and the CPU path's ``_MaskedPool``."""
    rng = np.random.default_rng(3 * T + C)
    lens = _lengths(T, B=5)
    x, xt = _bf16(rng, len(lens), T, C)
    g = rng.normal(size=(len(lens), C)).astype(np.float32)

    def pool(feats):
        feats = feats * length_mask(jnp.asarray(lens), T).astype(feats.dtype)
        denom = jnp.maximum(jnp.asarray(lens)[:, None].astype(jnp.float32), 1.0)
        return jnp.sum(feats.astype(jnp.float32), axis=1) / denom

    _, vjp = jax.vjp(pool, jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    lengths = torch.from_numpy(lens)
    got = k7.masked_mean_pool_backward_reference(torch.from_numpy(g), lengths, T, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (len(lens), T, C)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0x8000).any()  # the signed zeros are there to compare
    for path in ("plain", "dispatch"):
        xg = xt.clone().requires_grad_(True)
        y = (k7.masked_mean_pool_reference(xg, lengths) if path == "plain"
             else k7.masked_mean_pool(xg, lengths))
        (dx,) = torch.autograd.grad(y, [xg], torch.from_numpy(g))
        np.testing.assert_array_equal(_bits(dx), _bits(got), err_msg=path)


# ----------------------------------------------------------------------
# K9's update


def test_flush_plan_covers_every_slot_in_a_block_budget():
    for T in range(1, k9.MAX_THRESHOLDS + 1):
        size, ranges = k9.flush_plan(T)
        slots = 2 * (T + 1)
        assert size * ranges >= slots > size * (ranges - 1)  # every slot, no empty range
        assert size <= k9.FLUSH_MAX_SLOTS
        assert 128 * size <= 227 * 1024  # the counts within an SM's shared memory
        assert 2 * T + 1 < k9.NO_SLOT  # every slot has a code
    assert k9.flush_plan(99) == (200, 1)
    assert k9.flush_plan(383) == (768, 1) and k9.flush_plan(384)[1] == 2
    assert k9.flush_plan(1024) == (684, 3)
    assert k9.code_pitch(32102) == 32104 and k9.code_pitch(8) == 8


def _codes_emulated(lg, labels, mask, s, L):
    """The codes kernel: k through the bucket table (tab[i] = #{th < i /
    1024}, tab[1025] = T) and a search inside [tab[i], tab[i + 1]), the
    slot past T + 1 for a negative, NO_SLOT for a masked row."""
    T, nb = len(s), k9.CODE_BUCKETS
    tab = np.append(np.searchsorted(s, np.arange(nb + 1, dtype=np.float32) / np.float32(nb),
                                    side="left"), T)
    x = lg[:, :L]
    with np.errstate(over="ignore"):
        p = np.float32(1) / (np.float32(1) + np.exp(-x))
    assert np.nanmin(p) >= 0 and np.nanmax(p) <= 1
    i = np.minimum(np.nan_to_num(p * np.float32(nb)).astype(np.int64), nb)
    lo, hi = tab[i], tab[i + 1]
    # a search inside [lo, hi) only: a wrong table would move k
    k = lo + np.clip(np.searchsorted(s, p, side="right") - lo, 0, hi - lo)
    slot = np.where(labels[:, :L] > 0, 0, T + 1) + np.where(np.isnan(p), 0, k)
    return np.where(mask[:, None] > 0, slot, k9.NO_SLOT)


def _flush_emulated(hist, codes, T, L):
    """The flush kernel: block (column block, slot range), rows in chunks of
    255 counted as bytes (word = lane, byte = 32-column group), then each
    nonzero byte added to its (slot, column) of the histogram."""
    size, ranges = k9.flush_plan(T)
    cols = k9.FLUSH_COLS
    for cb in range(-(-L // cols)):
        c = np.arange(cb * cols, min(cb * cols + cols, L))
        group, lane = (c - cb * cols) // 32, (c - cb * cols) % 32
        for y in range(ranges):
            s0 = y * size
            n_slots = min(size, 2 * (T + 1) - s0)
            for r0 in range(0, len(codes), k9.FLUSH_CHUNK_ROWS):
                rows = np.arange(r0, min(len(codes), r0 + k9.FLUSH_CHUNK_ROWS))
                counts = np.zeros((n_slots, 4, 32), np.int64)  # (slot, byte, word)
                sl = codes[np.ix_(rows, c)] - s0
                ok = (sl >= 0) & (sl < n_slots)  # NO_SLOT lies past every range
                gg, ll = np.broadcast_arrays(group[None, :], lane[None, :], sl)[:2]
                np.add.at(counts, (sl[ok], gg[ok], ll[ok]), 1)
                assert counts.max(initial=0) <= 255  # a byte a count
                for j in range(4):
                    cols_j = cb * cols + 32 * j + np.arange(32)
                    keep = cols_j < L
                    hist[s0:s0 + n_slots, cols_j[keep]] += counts[:, j, keep]


def _update_emulated(batches, thresholds, L):
    """``SweepCounter``'s CUDA path in numpy: each batch's codes into a ring
    of ``RING_ROWS`` rows (grown to a larger batch), flushed when the next
    batch does not fit and at the end.  Returns (hist, order, flushes)."""
    T = len(thresholds)
    order = np.argsort(thresholds, kind="stable")
    s = thresholds[order]
    hist = np.zeros((2 * (T + 1), L), np.int64)
    ring, capacity, flushes = [], 0, 0
    for lg, labels, mask in batches:
        B = lg.shape[0]
        if B > capacity or sum(len(r) for r in ring) + B > capacity:
            if ring:
                _flush_emulated(hist, np.concatenate(ring), T, L)
                flushes += 1
            ring, capacity = [], max(capacity, k9.RING_ROWS, B)
        ring.append(_codes_emulated(lg, labels, mask, s, L))
    if ring:
        _flush_emulated(hist, np.concatenate(ring), T, L)
        flushes += 1
    return hist.reshape(2, T + 1, L).astype(np.int32), order, flushes


def _sweep_batches(rng, thresholds, B, L, n=3):
    """``n`` batches of B rows over L + 5 columns (label padding past L):
    probabilities 1e-6 from every threshold, ~20% positives, NaN logits,
    1-3 masked rows where B allows."""
    out = []
    for i in range(n):
        p = rng.uniform(1e-4, 1 - 1e-4, size=(B, L + 5))
        for _ in range(100):
            bad = np.abs(p[..., None] - thresholds).min(-1) < 1e-6
            if not bad.any():
                break
            p[bad] = rng.uniform(1e-4, 1 - 1e-4, size=int(bad.sum()))
        lg = np.log(p / (1 - p)).astype(np.float32)
        lg[(i + 1) % B, 2 * i] = 100.0  # p = 1 exactly, the table's last bucket
        lg[(i + 2) % B, 2 * i + 1] = -100.0  # p = 0 (exp overflows)
        lg[i % B, i] = lg[(i + 3) % B, L - 1 - i] = np.nan
        labels = (rng.random(lg.shape) < 0.2).astype(np.float32)
        mask = np.ones(B, np.float32)
        if B > 3:
            mask[B - 1 - i % 3:] = 0
        out.append((lg, labels, mask))
    return out


THRESHOLD_SETS = {
    "one": np.array([0.5], np.float32),
    "cli_99": sweep_tests.CLI_THRESHOLDS,
    "unsorted_duplicates": sweep_tests.ODD_THRESHOLDS,
    "t1024": np.concatenate([np.random.default_rng(5).uniform(0, 1, 1023),
                             [0.25]]).astype(np.float32),
}


@pytest.mark.parametrize("thresholds", list(THRESHOLD_SETS.values()), ids=list(THRESHOLD_SETS))
@pytest.mark.parametrize("B", [1, 5, 32, 65, 300])
def test_update_emulation_matches_first_design_and_jax(monkeypatch, B, thresholds):
    """The new update's histogram equals the first design's
    (``_emulated_update``: one add an element) exactly, and its counts
    through ``finalize_reference`` equal JAX's."""
    L = 300  # three column blocks, the last ragged
    if len(thresholds) == 1024:
        thresholds = thresholds.copy()
        thresholds[7] = thresholds[900]  # a duplicate among 1,024
    rng = np.random.default_rng(B + len(thresholds))
    batches = _sweep_batches(rng, thresholds, B, L, n=12 if B == 32 else 3)
    got, order, flushes = _update_emulated(batches, thresholds, L)
    # 12 batches of 32: a flush after 8 (the ring's 256 rows), one at the
    # end; 65 rows: three batches fit; 300: a batch over the ring and a flush
    # before each next
    assert flushes == {1: 1, 5: 1, 32: 2, 65: 1, 300: 3}[B]
    monkeypatch.setattr(sweep_tests, "L", L)
    with np.errstate(over="ignore"):  # exp(100) in float32: p = 0, as on the card
        want, want_order = sweep_tests._emulated_update(batches, thresholds)
    np.testing.assert_array_equal(order, want_order)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == sum(int((m > 0).sum()) * L for _, _, m in batches)
    count = JaxTrainer._sweep_count_fn(None, thresholds)
    acc = tuple(jnp.zeros((len(thresholds), L), jnp.int32) for _ in range(3))
    for lg, labels, mask in batches:
        acc = count(acc, jnp.asarray(lg), jnp.asarray(labels), jnp.asarray(mask))
    counts = k9.finalize_reference(torch.from_numpy(got.reshape(-1)),
                                   torch.from_numpy(order.astype(np.int32)), L, len(thresholds))
    for name, c, w in zip(("tp", "fp", "fn"), counts, acc):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("thresholds", [sweep_tests.CLI_THRESHOLDS, sweep_tests.ODD_THRESHOLDS],
                         ids=["cli_99", "unsorted_duplicates"])
def test_codes_and_flush_plain_versions_match_the_emulation(thresholds):
    """``codes_reference`` gives the codes kernel's codes (the emulation's)
    and ``flush_reference`` on them the emulated flush's histogram."""
    L = 300
    batches = _sweep_batches(np.random.default_rng(len(thresholds)), thresholds, 32, L, n=3)
    order = np.argsort(thresholds, kind="stable")
    s = thresholds[order]
    hist = torch.zeros(2 * (len(s) + 1) * L, dtype=torch.int32)
    want = np.zeros((2 * (len(s) + 1), L), np.int64)
    for lg, labels, mask in batches:
        codes = k9.codes_reference(*(torch.from_numpy(a) for a in (lg, labels, mask)),
                                   torch.from_numpy(s), L)
        emulated = _codes_emulated(lg, labels, mask, s, L)
        np.testing.assert_array_equal(codes.numpy(), emulated)
        k9.flush_reference(hist, codes.to(torch.int16), L)  # the ring's uint16 bits
        _flush_emulated(want, emulated, len(s), L)
    np.testing.assert_array_equal(hist.numpy().reshape(want.shape), want)


# ----------------------------------------------------------------------
# the wrappers against the C sources


def _constant(source: str, name: str) -> int:
    text = (kernels.CSRC_DIR / source).read_text()
    (value,) = re.findall(rf"constexpr (?:int|uint32_t) {name} = ([^;]+);", text)
    return int(eval(value, {}, {}))  # a literal or a product of literals


@pytest.mark.parametrize("source,name,value", [
    ("masked_pool.cu", "GROUP_CHANNELS", k7.POOL_GROUP_CHANNELS),
    ("masked_pool.cu", "POOL_THREADS", k7.POOL_THREADS),
    ("masked_pool.cu", "IN_FLIGHT", k7.POOL_IN_FLIGHT),
    ("masked_pool.cu", "GROUPS", k7.POOL_BWD_GROUPS),
    ("masked_pool.cu", "LANE_CHANNELS", k7.POOL_LANE),
    ("masked_pool.cu", "BWD_ROWS", k7.POOL_BWD_ROWS),
    ("masked_pool.cu", "MAX_LANES", k7.POOL_MAX_CHANNELS // k7.POOL_LANE),
    ("threshold_sweep.cu", "COLS", k9.FLUSH_COLS),
    ("threshold_sweep.cu", "CHUNK_ROWS", k9.FLUSH_CHUNK_ROWS),
    ("threshold_sweep.cu", "MAX_THRESHOLDS", k9.MAX_THRESHOLDS),
    ("threshold_sweep.cu", "BUCKETS", k9.CODE_BUCKETS),
    ("threshold_sweep.cu", "NO_SLOT", k9.NO_SLOT),
])
def test_wrapper_constants_match_the_sources(source, name, value):
    assert _constant(source, name) == value
    if name == "COLS":
        assert _constant(source, "SLOT_BYTES") == 128 * k9.FLUSH_MAX_SLOTS


def _prototypes(source: str) -> dict:
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    text = (kernels.CSRC_DIR / source).read_text()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        out[name] = [kinds[" ".join(p.replace("const ", "").split()[:-1]).replace(" *", "*")]
                     for p in params.split(",") if p.strip()]
    return out


@pytest.mark.parametrize("source,tables", [
    ("masked_pool.cu", {n: k7._ARGS[("masked_pool", n)]
                        for n in ("masked_mean_pool", "masked_mean_pool_backward",
                                  "masked_mean_pool_f32", "masked_mean_pool_backward_f32")}),
    ("threshold_sweep.cu", {"threshold_sweep_codes": k9._CODES_ARGS,
                            "threshold_sweep_flush": k9._FLUSH_ARGS,
                            "threshold_sweep_finalize": k9._FINALIZE_ARGS}),
    ("masked_conv_f32.cu", {n: k7._ARGS[("masked_conv_f32", n)]
                            for n in ("masked_conv_forward_f32", "masked_conv_dx_f32",
                                      "masked_conv_dw_f32")}),
    ("masked_bn.cu", {n: k7._ARGS[("masked_bn", n)]
                      for n in ("masked_bn_relu_forward", "masked_bn_relu_forward_f32",
                                "masked_bn_relu_backward", "masked_bn_relu_backward_f32",
                                "masked_bn_kernels_launched")}),
])
def test_wrapper_signatures_match_the_c_entry_points(source, tables):
    """Each ctypes table against its ``extern "C"`` prototype, parameter by
    parameter (a pointer passed as an int would be cut to 32 bits)."""
    assert _prototypes(source) == tables
