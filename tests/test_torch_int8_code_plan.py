"""K2's code passes (``protnote_tpu_torch/csrc/pair_scorer_int8.cu``) on the
CPU: their tiling and their order of work emulated in numpy.

The kernels cannot run here, so these tests hold what surrounds them and
the arithmetic they do in another order than the plain version:

* the tiling: layer 1's codes kernel takes work items of (sequence tile x
  label group x 64-column slice) from ``code_plan``; its scale kernel, one
  launch for every chunk of a call, items of the same sequence tile x
  ``scale_labels`` padded labels with each row split over its threads'
  parts; the later layers' kernel one warp a row in pieces of 384 16-byte
  vectors; each covers every (row, column) exactly once, for B 1, 5, 32, 65
  and 256, H 128 to 3072, and ragged chunks;
* the emulation follows the kernels' index arithmetic: ``a``'s slice staged
  in the permuted shared-memory layout and read back by each thread, ``c``
  in the thread's registers, the bf16 round by integer arithmetic, the
  rounding as ``q + 1.5 * 2^23`` and its low byte, four bytes packed as the
  byte permutes do (or, where every quotient is >= 0, with the upper clip
  only and pairs packed by a multiply-add); the scales from ``bf16(max(0, max(a + c)))`` over the
  sampled columns (layer 1) and from an integer maximum of the bf16 bits
  (each vector's first element at stride 8, every element at stride 1); the
  division correctly rounded (numpy's float32 division: what the kernels'
  one-step division ``div_bf16`` gives for bf16 numerators, checked at every
  near-tie in exact arithmetic).  It must give ``int8_codes_reference``'s and
  ``int8_row_scale_reference``'s bits exactly;
* through the GEMM, the emulated layer-1 codes give the rows
  ``int8_carry_reference`` carries and the JAX ``pair_logits_tiled_int8``
  chain's carry, run as ``tests/test_torch_pair_scorer_int8.py`` runs it
  (inputs on a dyadic grid, so ``a`` and ``c`` are exact on both sides).

Everything compared here is exact: no tolerance.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protnote_tpu.ops import pair_scorer as jps
from protnote_tpu_torch.ops import pair_scorer as tps
from tests.test_torch_pair_scorer_int8 import _folded, _inputs, _jax_carry, _weights

MAGIC = np.float32(12582912.0)  # 1.5 * 2^23
ROW_VECS = 12


# ---- the kernels' index arithmetic ---------------------------------------


def _code_threads(p: tps.CodePlan, B: int, nl_pad: int):
    """Every (block, thread) of layer 1's codes kernel: the sequence tile's
    first sequence and length, the label, the first column, the thread's
    sequence group and unit, as the kernel decodes them."""
    blk = np.arange(p.grid)[:, None]
    tid = np.arange(tps.CODE_THREADS)[None, :]
    item = blk // p.slices
    b0 = item // p.label_groups * p.seq_tile
    bt = np.minimum(p.seq_tile, B - b0)
    k0 = blk % p.slices * tps.CODE_UNIT * p.units
    u = tid % p.units
    li = tid // p.units % p.labels
    sg = tid // (p.units * p.labels)
    lab = item % p.label_groups * p.labels + li
    return np.broadcast_arrays(b0, bt, lab, k0 + tps.CODE_UNIT * u, sg, u, blk)


def _code_rows(p, B, nl_pad):
    """(thread index, row, first column, sequence-in-tile) of every 16-code
    store of the codes kernel, in the loop order of each thread."""
    b0, bt, lab, col, sg, _, _ = (x.ravel() for x in _code_threads(p, B, nl_pad))
    out = []
    for j in range(-(-p.seq_tile // p.seq_groups)):
        b = sg + j * p.seq_groups
        keep = b < bt
        t = np.flatnonzero(keep)
        out.append((t, (b0[t] + b[t]) * nl_pad + lab[t], col[t], b[t]))
    return [np.concatenate(x) for x in zip(*out)]


def _scale_rows(B, plan, K):
    """Layer 1's scale kernel over every chunk of ``plan``: the row of the
    call's scale buffer, the padded label and the sequence each row's
    combining thread writes, as the kernel decodes its work items (a
    sequence tile x ``scale_labels`` padded labels); and the threads a row
    (``parts``)."""
    seq_tile = tps.code_plan(B, plan.chunks[0].nl_pad, K).seq_tile
    lam_end = sum(ch.nl_pad for ch in plan.chunks)
    lgs = tps.scale_labels(seq_tile)
    groups = -(-lam_end // lgs)
    item = np.arange(-(-B // seq_tile) * groups)[:, None]
    t = np.arange(seq_tile * lgs)[None, :]
    b0, lg = item // groups * seq_tile, item % groups * lgs
    b, lam = b0 + t % seq_tile, lg + t // seq_tile
    keep = (b < np.minimum(b0 + seq_tile, B)) & (lam < lam_end)
    k = lam // plan.chunk
    nl_pad = np.minimum(plan.chunk, lam_end - k * plan.chunk)
    row = B * k * plan.chunk + b * nl_pad + lam - k * plan.chunk
    return row[keep], lam[keep], b[keep], tps.CODE_THREADS // (seq_tile * lgs)


def _parts_of(ns, parts):
    """The part (thread) of a row that takes sampled column i: rounds of
    SCALE_ROUND columns, float4s i4 = q, q + parts, ... of each round."""
    return (np.arange(ns) % tps.SCALE_ROUND) // 4 % parts


def _later_vectors(K):
    """(lane, vector) pairs of a later layer's row in the kernel's pieces:
    vector p0 + lane + 32 k for k < ROW_VECS."""
    nv, piece = K // 8, 32 * ROW_VECS
    lane, k = np.meshgrid(np.arange(32), np.arange(ROW_VECS), indexing="ij")
    idx = np.concatenate([(p0 + lane + 32 * k).ravel() for p0 in range(0, nv, piece)])
    return idx[idx < nv]


def _chunks(B, H):
    """The first and last chunk of a launch plan whose last chunk is ragged
    (77 labels past the last whole one)."""
    chunk = tps.launch_plan(B, 10 ** 6, H, 2).chunk
    plan = tps.launch_plan(B, chunk + 77, H, 2)
    assert plan.chunks[-1].nl == 77 and plan.chunks[-1].nl_pad == 128
    return plan.chunks[0], plan.chunks[-1]


@pytest.mark.parametrize("H", [128, 384, 1024, 3072])
@pytest.mark.parametrize("B", [1, 5, 32, 65, 256])
def test_code_passes_cover_every_row_and_column_once(B, H):
    for ch in _chunks(B, H):
        p = tps.code_plan(B, ch.nl_pad, H)
        assert p.units * p.labels * p.seq_groups == tps.CODE_THREADS
        assert p.label_groups * p.labels == ch.nl_pad
        assert p.slices * tps.CODE_UNIT * p.units == H
        assert (p.seq_tiles - 1) * p.seq_tile < B <= p.seq_tiles * p.seq_tile
        assert p.seq_tile <= tps.CODE_SEQ_TILE and p.seq_tile * 64 * p.units <= 40 * 1024
        assert p.seq_tile * p.labels <= 8 * tps.CODE_THREADS  # the rows' scales staged
        M, units = B * ch.nl_pad, H // tps.CODE_UNIT
        _, rows, col, _ = _code_rows(p, B, ch.nl_pad)
        count = np.bincount(rows * units + col // tps.CODE_UNIT, minlength=M * units)
        assert count.shape == (M * units,) and (count == 1).all()
    # the scale kernel: every row of every chunk of the plan, once, each
    # row's sampled columns split over its parts
    plan = tps.launch_plan(B, _chunks(B, H)[1].l0 + 77, H, 2)
    rows, _, _, parts = _scale_rows(B, plan, H)
    total = B * sum(ch.nl_pad for ch in plan.chunks)
    assert np.array_equal(np.bincount(rows, minlength=total), np.ones(total, np.int64))
    ns = H // (8 if H >= 1024 else 1)
    assert parts >= 1 and set(_parts_of(ns, parts)) == set(range(min(parts, ns // 4)))
    vecs = np.sort(_later_vectors(H))
    assert np.array_equal(vecs, np.arange(H // 8))
    wide = np.sort(_later_vectors(4096))  # two pieces: the row is read twice
    assert np.array_equal(wide, np.arange(512))


def test_code_plan_at_the_serving_width():
    """32 sequences x 256 labels at H 3072: 384 blocks, each a 32-label
    group and 64 columns; a leaves L2 8 times a chunk."""
    p = tps.code_plan(32, 256, 3072)
    assert p == tps.CodePlan(units=4, labels=32, seq_groups=2, seq_tile=32, label_groups=8,
                             seq_tiles=1, slices=48)
    assert p.grid == 384 and p.args == (4, 32, 2, 32)
    assert tps.code_plan(1, 8192, 3072).labels == 64
    assert tps.code_plan(65, 128, 3072).seq_tile == 22
    with pytest.raises(ValueError):
        tps.code_plan(4, 100, 3072)


# ---- the kernels' arithmetic ---------------------------------------------


def _bf16_bits(x):
    """float32 -> bf16 bits, rounded to nearest even by integer arithmetic
    (finite inputs)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _from_bf16(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _code_words(q):
    """code_byte: clip to +-127, then + 1.5 * 2^23: the word whose low
    byte is the code."""
    return (np.clip(q.astype(np.float32), -127, 127) + MAGIC).astype(np.float32).view(np.uint32)


def _byte_perm(x, y, s):
    """CUDA's __byte_perm: byte n of the result is byte (s >> 4 n) & 7 of
    the 8 bytes y:x."""
    both = (y.astype(np.uint64) << 32) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & 0xFF) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _packed_codes(words):
    """pack_low_bytes over groups of four words (last axis), then the
    packed words' bytes in memory order (little-endian) as int8."""
    w = words.reshape(*words.shape[:-1], -1, 4)
    lo = _byte_perm(w[..., 0], w[..., 1], 0x0040)
    hi = _byte_perm(w[..., 2], w[..., 3], 0x0040)
    packed = np.ascontiguousarray(_byte_perm(lo, hi, 0x5410)).astype("<u4")
    return packed.view(np.int8).reshape(words.shape)


def _packed_codes_pos(q):
    """codes4_pos, for quotients >= 0: the upper clip, + 1.5 * 2^23, two
    words packed by a multiply-add (their second bytes are 0), the pairs by
    a byte permute; bytes in memory order as int8."""
    w = (np.minimum(q.astype(np.float32), 127) + MAGIC).astype(np.float32).view(np.uint32)
    w = w.reshape(*w.shape[:-1], -1, 4).astype(np.uint64)
    p01 = ((w[..., 1] * 256 + w[..., 0]) & 0xFFFFFFFF).astype(np.uint32)
    p23 = ((w[..., 3] * 256 + w[..., 2]) & 0xFFFFFFFF).astype(np.uint32)
    packed = np.ascontiguousarray(_byte_perm(p01, p23, 0x5410)).astype("<u4")
    return packed.view(np.int8).reshape(q.shape)


def _scale_of(m, margin):
    """row_scale_of: max(m * margin, 1e-12) * float32(1 / 127)."""
    m = np.maximum((m * np.float32(margin)).astype(np.float32), np.float32(1e-12))
    return (m * (np.float32(1) / np.float32(127))).astype(np.float32)


def _first_scales(a_sub, c, plan, B, K, stride, margin):
    """Layer 1's scale kernel over every chunk of ``plan``: each row's parts
    take their maxima of max(0, a + c) over their sampled columns, combined
    in order, rounded to bf16, then the scale; the call's scale buffer."""
    rows, lam, b, parts = _scale_rows(B, plan, K)
    l00 = plan.chunks[0].l0
    n_labels = plan.chunks[-1].l0 + plan.chunks[-1].nl - l00
    cs = np.zeros((sum(ch.nl_pad for ch in plan.chunks), K // stride), np.float32)
    cs[:n_labels] = c[l00 : l00 + n_labels, ::stride]
    sums = (a_sub[b] + cs[lam]).astype(np.float32)
    part = _parts_of(K // stride, parts)
    m = np.zeros(len(rows), np.float32)
    for q in range(parts):
        m = np.maximum(m, sums[:, part == q].max(1, initial=0))
    out = np.full(B * len(cs), np.nan, np.float32)
    out[rows] = _scale_of(_from_bf16(_bf16_bits(m)), margin)
    return out


def _chunk_scales(scales, plan, ch, B):
    """Chunk ``ch``'s rows of the call's scale buffer."""
    start = B * (ch.l0 - plan.chunks[0].l0)
    return scales[start : start + B * ch.nl_pad]


def _first_codes(a, c, ch, B, K, scale=None, row_scale=None):
    """Layer 1's codes kernel, block by block: a's slice staged in the
    shared-memory layout [b][k][u] (float4s) and read back by each thread,
    the thread's c slice, x = bf16(relu(a + c)), q = x * scale (static) or
    x / row_scale[r] (dynamic), 16 codes a store."""
    p = tps.code_plan(B, ch.nl_pad, K)
    w4 = 4 * p.units
    blk = np.arange(p.grid)
    b0 = blk // p.slices // p.label_groups * p.seq_tile
    bt = np.minimum(p.seq_tile, B - b0)
    k0 = blk % p.slices * tps.CODE_UNIT * p.units
    a4 = a.reshape(B, K // 4, 4)
    a_s = np.full((p.grid, p.seq_tile * w4, 4), np.nan, np.float32)
    f = np.arange(p.seq_tile * w4)
    bf, j = f // w4, f % w4
    for g in range(p.grid):
        keep = bf < bt[g]
        a_s[g, ((4 * bf + (j & 3)) * p.units + (j >> 2))[keep]] = \
            a4[b0[g] + bf[keep], k0[g] // 4 + j[keep]]
    t, rows, cols, b = _code_rows(p, B, ch.nl_pad)
    g, u = t // tps.CODE_THREADS, t % tps.CODE_THREADS % p.units
    cpad = np.zeros((ch.nl_pad, K), np.float32)
    cpad[: ch.nl] = c[ch.l0 : ch.l0 + ch.nl]
    out = np.full((B * ch.nl_pad, K), 99, np.int8)
    for k in range(4):
        av = a_s[g, (4 * b + k) * p.units + u]  # (stores, 4)
        idx = cols[:, None] + 4 * k + np.arange(4)
        x = _from_bf16(_bf16_bits(np.maximum((av + cpad[rows[:, None] % ch.nl_pad, idx])
                                             .astype(np.float32), 0)))
        if row_scale is None:
            q = (x * np.float32(scale)).astype(np.float32)
        else:
            q = (x / row_scale[rows][:, None]).astype(np.float32)
        # the kernel's path for quotients >= 0 (a positive finite scale),
        # else the general clip
        pos = row_scale is not None or 0 < scale < np.inf
        out[rows[:, None], idx] = _packed_codes_pos(q) if pos else _packed_codes(_code_words(q))
    return out


def _later(xbits, stride, margin):
    """A later layer's kernel: the row's vectors of 8 bf16, the maximum of
    the bits (sign cleared) of each vector's first element (stride 8) or of
    every element (stride 1), the scale, then x / scale per vector."""
    M, K = xbits.shape
    v = (xbits & 0x7FFF).reshape(M, K // 8, 8)
    sampled = v[:, :, 0] if stride == 8 else v.reshape(M, -1)
    mb = sampled.max(1).astype(np.uint32)
    s = _scale_of((mb << 16).view(np.float32), margin)
    q = (_from_bf16(xbits) / s[:, None]).astype(np.float32)
    return s, _packed_codes(_code_words(q))


def test_rounding_by_the_magic_add_is_round_half_even_and_clip():
    """code_byte's word: its low byte is clip(rint(q), -127, 127) for every
    q (ties, the clip bounds, huge and tiny values, -0), and the byte
    permutes pack four of them in memory order."""
    q = np.concatenate([np.arange(-300, 300, 0.25), np.arange(-3, 3, 0.5) + 1e-7,
                        [-0.0, 1e-30, -1e-30, 127.5, -127.5, 126.5, -126.5, 1e30, -1e30,
                         np.inf, -np.inf, 0.49999997, 0.5, 1.5, 2.5]]).astype(np.float32)
    q = q[: len(q) // 4 * 4]
    want = torch.clamp(torch.round(torch.from_numpy(q)), -127, 127).to(torch.int8).numpy()
    assert np.array_equal(_packed_codes(_code_words(q)), want)
    assert np.array_equal((_code_words(q) & 0xFF).astype(np.uint8).view(np.int8), want)
    pos = np.abs(q)  # codes4_pos, for quotients >= 0
    want = torch.clamp(torch.round(torch.from_numpy(pos)), 0, 127).to(torch.int8).numpy()
    assert np.array_equal(_packed_codes_pos(pos), want)


def _rn32(v: Fraction) -> Fraction:
    """``v`` rounded to the nearest float32, half to even (normal range)."""
    if v == 0:
        return Fraction(0)
    if v < 0:
        return -_rn32(-v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    if Fraction(2) ** e > v:
        e -= 1
    scale = Fraction(2) ** (23 - e)
    n, rem = divmod(v.numerator * scale.numerator, v.denominator * scale.denominator)
    twice = 2 * rem
    den = v.denominator * scale.denominator
    if twice > den or (twice == den and n % 2):
        n += 1
    return n / scale


def _rint_clip(q: Fraction) -> int:
    q = min(q, Fraction(127))
    n = math.floor(q)
    rem = q - n
    return n + (rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2 == 1))


@pytest.mark.parametrize("group", range(8))
def test_one_step_division_of_bf16_is_the_correctly_rounded_quotient(group):
    """div_bf16: q0 = x * r, then one correction q0 + fma(-q0, s, x) * r
    (r = float32(1 / s)).  Its error before the last rounding is below 2^-22
    of an ulp, so it can differ from x / s correctly rounded only where x / s
    lies that close to a float midpoint, and a code only where that midpoint
    borders a half-integer.  x is bf16 (8 significant bits) and every step
    scales with x and s, so those cases are: each bf16 significand x, each
    half-integer n + 0.5 up to 127.5 and the midpoint on either side of it,
    and the float32 s within 4 ulps of x over that midpoint, all of them
    here, in exact arithmetic (16 significands a group).  The quotient equals
    the correctly rounded one in each, so the codes do."""
    cases = 0
    for m in range(128 + 16 * group, 128 + 16 * (group + 1)):
        x = Fraction(m, 128)
        for n in range(128):
            h = np.float32(n + 0.5)
            for side in (np.float32(0), np.float32(np.inf)):
                mid = (Fraction(float(h)) + Fraction(float(np.nextafter(h, side)))) / 2
                s0 = np.float32(float(x / mid))
                for k in range(-4, 5):
                    s = s0
                    for _ in range(abs(k)):
                        s = np.nextafter(s, np.float32(np.inf if k > 0 else 0))
                    sf = Fraction(float(s))
                    r = _rn32(1 / sf)
                    q0 = _rn32(x * r)
                    q1 = _rn32(q0 + _rn32(x - sf * q0) * r)
                    want = _rn32(x / sf)
                    assert q1 == want and _rint_clip(q1) == _rint_clip(want), (m, n, float(s))
                    cases += 1
    assert cases == 16 * 128 * 2 * 9


def _chunk_inputs(rng, B, H, L):
    a = rng.normal(scale=0.6, size=(B, H)).astype(np.float32)
    c = rng.normal(scale=0.6, size=(L, H)).astype(np.float32)
    return a, c


@pytest.mark.parametrize("H", [384, 1024])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_static_codes_emulation_matches_plain(B, H):
    """Layer 1's static codes, block by block, on a chunk ending mid-tile
    (labels [30, 180), padded to 256), bit-equal to
    ``int8_codes_reference``; a scale of 1/64 puts many codes on ties."""
    rng = np.random.default_rng(B + H)
    a, c = _chunk_inputs(rng, B, H, 200)
    a[:, :8] = np.round(a[:, :8] * 64) / 64  # exact ties of x * 64 after relu
    c[:, :8] = np.round(c[:, :8] * 64) / 64 + 1 / 128
    ch = tps.single_chunk_plan(B, H, 2, 30, 150).chunks[0]
    for s0 in (1 / 64, 0.0123):
        inv = float(tps._inv(s0, "cpu"))
        got = _first_codes(a, c, ch, B, H, scale=inv)
        want = tps.int8_codes_reference(torch.from_numpy(a), torch.from_numpy(c), ch, s0)
        assert np.array_equal(got, want.numpy())
    assert len(np.unique(got)) > 100  # the codes spread over the range


@pytest.mark.parametrize("H", [384, 768, 1024])
@pytest.mark.parametrize("B", [1, 5, 32])
def test_dynamic_first_form_emulation_matches_plain(B, H):
    """Layer 1's dynamic scales (from a's compacted samples and c's sampled
    columns, max(0, max(a + c)) then bf16) and codes (x / s per row),
    bit-equal to ``int8_row_scale_reference`` of the chunk's bf16 inputs;
    H 1024 samples every 8th column with the 1.3 margin; at H 768 (every
    column) the scale kernel stages them in two rounds."""
    rng = np.random.default_rng(10 * B + H)
    a, c = _chunk_inputs(rng, B, H, 200)
    c[7] = -5.0  # a label whose every sum is negative: the row's scale is 1e-12 / 127
    stride = 8 if H >= 1024 else 1
    margin = 1.3 if stride > 1 else 1.0
    a_sub = np.ascontiguousarray(a[:, ::stride])
    # one chunk, and a plan of two (the second ragged) whose scales come
    # from one walk over both
    for plan in (tps.single_chunk_plan(B, H, 2, 0, 150), tps.launch_plan(B, 150, H, 2, 128 * B)):
        scales = _first_scales(a_sub, c, plan, B, H, stride, margin)
        assert not np.isnan(scales).any()
        for ch in plan.chunks:
            s = _chunk_scales(scales, plan, ch, B)
            got = _first_codes(a, c, ch, B, H, row_scale=s)
            x = tps._chunk_inputs(torch.from_numpy(a), torch.from_numpy(c), ch).to(torch.bfloat16)
            want_s, want = tps.int8_row_scale_reference(x)
            assert np.array_equal(s, want_s.numpy()) and np.array_equal(got, want.numpy())
        tiny = np.float32(np.float32(1e-12) * (np.float32(1) / np.float32(127)))
        assert (scales == tiny).sum() >= B


@pytest.mark.parametrize("H", [128, 1024, 3072, 4096])
def test_later_form_emulation_matches_plain(H):
    """A later layer's rows read once: the scales from the vectors' first
    elements (every element below H 1024) and the codes, bit-equal to
    ``int8_row_scale_reference`` on bf16 rows of both signs, with a zero
    row and rows whose largest |x| sits off the sampled columns."""
    rng = np.random.default_rng(H)
    x = torch.from_numpy(rng.normal(size=(40, H)).astype(np.float32)).to(torch.bfloat16)
    x[3] = 0
    x[5, 1] = 40.0  # off the stride-8 samples: clipped to 127 there
    x[6, 8] = -40.0
    xbits = x.view(torch.int16).numpy().view(np.uint16)
    stride = 8 if H >= 1024 else 1
    s, got = _later(xbits, stride, 1.3 if stride > 1 else 1.0)
    want_s, want = tps.int8_row_scale_reference(x)
    assert np.array_equal(s, want_s.numpy()) and np.array_equal(got, want.numpy())
    assert got.min() == -127 and got.max() == 127


@pytest.mark.parametrize("H", [256, 1024])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_emulated_layer1_codes_carry_as_jax(mode, H):
    """The emulated layer-1 codes through the int32 GEMM and the layer's
    epilogue, on the chunk layout, carry exactly ``int8_carry_reference``'s
    rows and the JAX chain's (``pair_logits_tiled_int8``'s first layer, as
    XLA compiles it), for every 8-label chunk of 21 labels (the last ragged)
    and one that starts mid-tile."""
    jf, tf = _folded(_weights(H), "bf16")
    P, Lm = _inputs()
    B = P.shape[0]
    scales = jps.calibrate_act_scales(jf, jnp.asarray(P), jnp.asarray(Lm), 8) \
        if mode == "static" else None
    jq = jps.quantize_folded(jf, act_scales=scales)
    tq = tps.quantize_folded(tf, act_scales=scales)
    P_e, L_e = torch.from_numpy(P), torch.from_numpy(Lm)
    a, c = (t.numpy() for t in tps._side_partials(tq, P_e, L_e, torch.bfloat16))
    Wq, s_w, b = tq.hidden_q[0]
    stride = 8 if H >= 1024 else 1
    for l0, nl in ((0, 8), (8, 8), (16, 5), (3, 11)):
        ch = tps.single_chunk_plan(B, H, 2, l0, nl).chunks[0]
        if mode == "static":
            hq = _first_codes(a, c, ch, B, H, scale=float(tps._inv(scales[0], "cpu")))
            alpha = (tps._f32(scales[0], "cpu") * s_w)[None, :]
        else:
            plan = tps.single_chunk_plan(B, H, 2, l0, nl)
            s = _first_scales(np.ascontiguousarray(a[:, ::stride]), c, plan, B, H, stride,
                              1.3 if stride > 1 else 1.0)
            hq = _first_codes(a, c, ch, B, H, row_scale=s)
            alpha = torch.from_numpy(s)[:, None] * s_w[None, :]
        y = tps._int_product(torch.from_numpy(hq), Wq).float()
        h = torch.relu(y * alpha + b).to(torch.bfloat16)
        carry = tps._codes(h.float() * tps._inv(scales[1], "cpu"), 0) if scales else h
        mine = tps.chunk_rows(carry, B, ch)
        assert torch.equal(mine, tps.int8_carry_reference(tq, P_e, L_e, l0, nl))
        theirs = _jax_carry(jq, P, Lm, l0, nl, jnp.bfloat16)
        assert np.array_equal(mine.float().numpy(), theirs)
