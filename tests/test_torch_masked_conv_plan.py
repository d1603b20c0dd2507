"""What surrounds K7's TMA + wgmma conv kernels (protnote_tpu_torch/ops/
masked_conv.py), on the CPU: the padded row pitch of the chain's
activations, the weights re-laid for the kernels' B operand, the tile plan,
dW's K-step plan (``dw_step_plan``) and split counts, the kernel's order of
work at its own 128 x 184 tile, and the encoder chain run on padded-pitch
buffers against the contiguous chain and JAX's ``proteinfer_embed``.

Inputs are drawn with numpy from fixed seeds.  Tolerances:
* layouts, pitches and plans: exact (they move or count, nothing is summed);
* the pitched chain against the contiguous one: the same bits (the same
  operations on the same values; the plain pool and BatchNorm sum a
  row-major copy, so the layout does not change their order);
* float32 against JAX: 1e-5 of each tensor's largest |value|, as
  tests/test_torch_masked_conv.py (only the summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import proteinfer as jpi
from protnote_tpu_torch.models import proteinfer as tpi
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import masked_conv as k7
from test_torch_masked_conv import _emulate_conv_rows, _tap_range

F32_REL = 1e-5


def _close(got, want, rel=F32_REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


# ----------------------------------------------------------------------
# the row pitch


@pytest.mark.parametrize("c,pitch", [(1100, 1104), (550, 552), (20, 24), (21, 24), (8, 8),
                                     (1, 8)])
def test_row_pitch_rounds_up_to_16_bytes(c, pitch):
    assert k7.row_pitch(c) == pitch
    x = k7.padded_empty(3, 5, c, torch.bfloat16, "cpu")
    assert x.shape == (3, 5, c) and x.stride() == (5 * pitch, pitch, 1)
    assert k7.pitch_of(x) == pitch and x._base is None  # strided, not a view


def test_pad_pitch_keeps_a_padded_tensor_and_copies_any_other():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 7, 21)).astype(np.float32)).to(torch.bfloat16)
    p = k7.pad_pitch(x)
    assert p.stride() == (7 * 24, 24, 1) and torch.equal(p, x)
    assert k7.pad_pitch(p) is p
    wide = torch.zeros(2, 7, 32, dtype=torch.bfloat16)
    assert k7.pad_pitch(wide[..., :21]).data_ptr() == wide.data_ptr()  # pitch 32 is taken
    assert k7.pitch_of(x.transpose(1, 2)) is None
    t = k7.pad_pitch(x.transpose(0, 1).contiguous().transpose(0, 1))  # rows not one pitch apart
    assert t.stride(1) == 24 and torch.equal(t, x)


def test_one_hot_rows_lie_at_the_padded_pitch():
    ids = torch.tensor([[0, 19, 20, 23, 27, -1, 5]])
    onehot = tpi.one_hot_sequences(ids, 20)
    assert onehot.shape == (1, 7, 20) and onehot.stride(1) == 24
    want = torch.zeros(1, 7, 20)
    want[0, 0, 0] = want[0, 1, 19] = want[0, 6, 5] = 1.0
    assert torch.equal(onehot, want)
    assert float(onehot._base[..., 20:].abs().max()) == 0.0  # the padding classes match no id


# ----------------------------------------------------------------------
# the weights' layout


@pytest.mark.parametrize("taps,cin,cout", [(9, 24, 16), (9, 20, 1100), (9, 1100, 550),
                                           (1, 550, 1100), (3, 185, 64)])
@pytest.mark.parametrize("dx", [False, True])
def test_weight_layout_is_zero_padded_and_round_trips(taps, cin, cout, dx):
    rng = np.random.default_rng(taps + cin + cout)
    w = torch.from_numpy(rng.normal(size=(taps, cin, cout)).astype(np.float32)).to(torch.bfloat16)
    lay = k7.conv_weight_layout(w, dx)
    n, k = (cin, cout) if dx else (cout, cin)
    assert lay.shape == (taps, -(-n // 184) * 184, -(-k // 64) * 64) and lay.dtype == w.dtype
    assert lay.is_contiguous()
    back = lay[:, :cin, :cout] if dx else lay[:, :cout, :cin].transpose(1, 2)
    assert torch.equal(back, w)  # back to the JAX (taps, C_in, C_out)
    assert float(lay[:, n:].abs().sum()) == 0.0 and float(lay[:, :, k:].abs().sum()) == 0.0


def test_weight_layout_is_cached_per_version_and_storage():
    w = torch.randn(3, 24, 16)
    a = k7.weight_layout(w, torch.bfloat16, dx=False)
    assert k7.weight_layout(w, torch.bfloat16, dx=False) is a
    d = k7.weight_layout(w, torch.bfloat16, dx=True)
    assert d.shape == (3, 184, 64) and d is not a
    w.add_(1.0)  # an optimizer's in-place update
    b = k7.weight_layout(w, torch.bfloat16, dx=False)
    assert b is not a and torch.equal(b[:, :16, :24].transpose(1, 2), w.to(torch.bfloat16))
    with torch.inference_mode():
        v = torch.randn(3, 24, 16)
        assert k7.weight_layout(v, torch.bfloat16, dx=False) is \
            k7.weight_layout(v, torch.bfloat16, dx=False)


# ----------------------------------------------------------------------
# the tile plan


@pytest.mark.parametrize("lengths", [[0, 0], [1, 0, 1], [300, 300], [300, 1, 0, 129, 257, 40],
                                     [128, 129, 256, 255]])
@pytest.mark.parametrize("taps,dilation,n,dx", [(9, 1, 1100, False), (9, 81, 550, False),
                                                (9, 27, 1100, True), (1, 1, 550, True),
                                                (9, 3, 20, False)])
def test_tile_plan_covers_the_nonempty_tiles_once_longest_first(lengths, taps, dilation, n, dx):
    T = 300
    codes = k7.conv_tile_plan(np.asarray(lengths, np.int32), T, taps, dilation, n, dx)
    assert codes.dtype == np.int32
    mtiles, ntiles = -(-T // 128), -(-n // 184)
    want = {(b, mt, nt) for b, L in enumerate(lengths) for mt in range(mtiles)
            for nt in range(ntiles) if mt * 128 < min(L, T)}
    got = [(int(c) // ntiles // mtiles, int(c) // ntiles % mtiles, int(c) % ntiles)
           for c in codes]
    assert len(got) == len(set(got)) and set(got) == want
    work = []
    for b, mt, _ in got:
        jlo, jhi = _tap_range(min(lengths[b], T), mt * 128, taps, dilation, dx)
        assert jhi >= jlo
        work.append(jhi - jlo + 1)
    assert work == sorted(work, reverse=True)


def test_tile_plan_skips_the_dilation_81_taps_beyond_a_short_sequence():
    codes = k7.conv_tile_plan(np.array([30, 512], np.int32), 512, 9, 81, 550, False)
    ntiles = 3
    by_tile = {(int(c) // ntiles // 4, int(c) // ntiles % 4) for c in codes}
    assert by_tile == {(0, 0), (1, 0), (1, 1), (1, 2), (1, 3)}
    # rows t - 81 of the first 128 meet [0, 30), rows t + 81 never do
    assert _tap_range(30, 0, 9, 81, False) == (3, 4)
    # at t0 128 the tap at -324 reads only rows below 0
    assert _tap_range(512, 128, 9, 81, False) == (1, 8)
    assert _tap_range(512, 384, 9, 81, False) == (0, 5)
    assert _tap_range(5, 128, 9, 81, False) == (9, -1)
    assert [int(c) // ntiles for c in codes[:3]] == [5, 5, 5]  # (b 1, tile 1): 8 taps, first


# ----------------------------------------------------------------------
# dW's K-step plan


def _dw_parts(plan, n_items, taps, splits):
    """(items, offsets, steps (n, 2)) of a ``dw_step_plan``."""
    offsets = plan[n_items:n_items + taps * splits + 1]
    return plan[:n_items], offsets, plan[n_items + taps * splits + 1:].reshape(-1, 2)


@pytest.mark.parametrize("lengths", [[0, 0], [1, 0, 1], [300, 300], [300, 1, 0, 129, 257, 40],
                                     [64, 65, 128, 63, 330]])
@pytest.mark.parametrize("taps,dilation,cin,cout,sms", [
    (9, 1, 20, 1100, 132), (9, 81, 1100, 550, 132), (9, 27, 1100, 550, 132),
    (1, 1, 550, 1100, 132), (9, 3, 70, 130, 40), (5, 2, 64, 64, 25)])
def test_dw_plan_covers_each_valid_position_once_in_split_order(lengths, taps, dilation, cin,
                                                                cout, sms):
    """Tap j (shift s) needs every (b, t) with t < L and 0 <= t + s < L: the
    plan's steps of that tap, read split after split, list each exactly once
    in (b, t) order; a step holds 1-64 positions of one sequence; the splits
    of a tap differ by at most one step.  Lengths 0, 1, T and past T."""
    T = 300
    plan, splits, n_items = k7.dw_step_plan(np.asarray(lengths, np.int32), T, taps, dilation,
                                            cin, cout, sms)
    assert plan.dtype == np.int32 and splits == k7.dw_splits(taps, cin, cout, sms)
    items, offsets, steps = _dw_parts(plan, n_items, taps, splits)
    assert offsets[0] == 0 and offsets[-1] == len(steps) and (np.diff(offsets) >= 0).all()
    half = (taps - 1) // 2
    for j in range(taps):
        s = dilation * (j - half)
        want = [(b, t) for b, n in enumerate(lengths) for L in [min(n, T)]
                for t in range(max(0, -s), min(L, L - s))]
        got, counts = [], []
        for sp in range(splits):
            seg = steps[offsets[j * splits + sp]:offsets[j * splits + sp + 1]]
            counts.append(len(seg))
            for b, w in seg:
                t0, rows = int(w) & 0xFFFF, int(w) >> 16
                assert 1 <= rows <= k7.DW_STEP  # one sequence a step, 64 positions at most
                got += [(int(b), t) for t in range(t0, t0 + rows)]
        assert got == want, j
        assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("sms", [132, 40, 7])
def test_dw_plan_items_cover_every_tile_once_longest_first_by_waves(sms):
    """Each (tap, split, row tile, column tile) is one item; the items run
    the most K steps first, every other wave of ``sms`` items reversed (the
    persistent blocks take items i, i + sms, ...)."""
    lengths = np.array([300, 1, 0, 129, 257, 40, 300, 77], np.int32)
    taps, cin, cout = 9, 1100, 550
    plan, splits, n_items = k7.dw_step_plan(lengths, 300, taps, 81, cin, cout, sms)
    items, offsets, _ = _dw_parts(plan, n_items, taps, splits)
    tiles = -(-cin // k7.DW_BLOCK_M) * -(-cout // k7.DW_BLOCK_N)
    assert n_items == taps * splits * tiles == len(items)
    assert sorted(items.tolist()) == list(range(n_items))
    work = np.diff(offsets)[items // tiles]
    for w0 in range(sms, n_items, 2 * sms):
        work[w0:w0 + sms] = work[w0:w0 + sms][::-1].copy()
    assert (np.diff(work) <= 0).all()


def test_dw_split_counts_of_a_full_width_step():
    """The 11 convs of a step at the default widths: conv1 (9 taps, 20 ->
    1,100), five dilated convs (9 taps, 1,100 -> 550) and five 1 x 1 convs
    (550 -> 1,100) on an H100's 132 SMs: 54, 243 and 30 tiles, so 2, 1 and
    4 splits (243 tiles fill 1.84 waves already; float32 partials only where
    the items would leave most of the card idle)."""
    cfg = tpi.ProteInferConfig()
    cb = cfg.bottleneck_channels
    shapes = ([(cfg.kernel_size, cfg.input_channels, cfg.output_channels)]
              + [(cfg.kernel_size, cfg.output_channels, cb)] * cfg.num_resnet_blocks
              + [(1, cb, cfg.output_channels)] * cfg.num_resnet_blocks)
    assert len(shapes) == 11
    assert [k7.dw_tiles(*sh) for sh in shapes] == [54] + [243] * 5 + [30] * 5
    assert [k7.dw_splits(*sh) for sh in shapes] == [2] + [1] * 5 + [4] * 5
    lens = np.full(32, 512, np.int32)
    for taps, cin, cout in shapes[:2] + shapes[-1:]:
        _, splits, n_items = k7.dw_step_plan(lens, 512, taps, 3, cin, cout)
        assert n_items == splits * k7.dw_tiles(taps, cin, cout)


def test_dw_plan_refuses_positions_past_16_bits():
    with pytest.raises(ValueError, match="16 bits"):
        k7.dw_step_plan(np.array([5], np.int32), 70000, 1, 1, 8, 8)


def test_dw_kernel_algorithm_at_the_kernel_tile_matches_jax():
    """``conv_dw_kernel``'s order of work emulated in float64 at its own
    tile (128 input x 192 output channels; 200 and 230 channels: two row and
    two column tiles, the second zero-padded, a warpgroup past C_in issuing
    nothing) over the plan's K steps (64 positions, those past the step's
    valid count zeroed), each item's partial added in split order, against
    JAX's vjp in float32: T 300, lengths T, 0, 1, T - 1, 129, dilation 81
    (the outer taps reach past every sequence), two splits."""
    T, cin, cout, taps, dilation = 300, 200, 230, 9, 81
    lengths = np.array([T, 0, 1, T - 1, 129], np.int32)
    rng = np.random.default_rng(5)
    bound = 1.0 / np.sqrt(cin * taps)
    w = rng.uniform(-bound, bound, (taps, cin, cout)).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    x = rng.normal(size=(5, T, cin)).astype(np.float32)
    g = rng.normal(size=(5, T, cout)).astype(np.float32)
    mask = jpi.length_mask(jnp.asarray(lengths), T)
    _, vjp = jax.vjp(lambda w: jpi._masked_conv(
        {"kernel": w, "bias": jnp.asarray(bias)}, jnp.asarray(x), mask, dilation), jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    tiles = k7.dw_tiles(taps, cin, cout)
    sms = 2 * tiles  # two splits
    plan, splits, n_items = k7.dw_step_plan(lengths, T, taps, dilation, cin, cout, sms)
    assert splits == 2
    items, offsets, steps = _dw_parts(plan, n_items, taps, splits)
    bm, bn, mt_n, nt_n = k7.DW_BLOCK_M, k7.DW_BLOCK_N, -(-cin // 128), -(-cout // 192)
    xp = np.zeros((5, T, mt_n * bm))
    xp[..., :cin] = x
    gp = np.zeros((5, T, nt_n * bn))
    gp[..., :cout] = g
    partial = np.zeros((splits, taps, mt_n * bm, nt_n * bn))
    written = np.zeros(partial.shape, np.int64)
    for code in items:
        u, nt = divmod(int(code), nt_n)
        v, mt = divmod(u, mt_n)
        j, sp = divmod(v, splits)
        s = dilation * (j - (taps - 1) // 2)
        rows_m, cols_n = slice(mt * bm, (mt + 1) * bm), slice(nt * bn, (nt + 1) * bn)
        for b, word in steps[offsets[v]:offsets[v + 1]]:
            t0, rows = int(word) & 0xFFFF, int(word) >> 16
            t = np.arange(t0, t0 + k7.DW_STEP)
            ok = (t - t0 < rows)[:, None]
            # the select, not a multiply
            a = np.where(ok, xp[b, np.clip(t + s, 0, T - 1), rows_m], 0.0)
            partial[sp, j, rows_m, cols_n] += a.T @ gp[b, np.clip(t, 0, T - 1), cols_n]
        written[sp, j, rows_m, cols_n] += 1
    assert (written == 1).all()
    _close(partial.sum(0)[:, :cin, :cout], want, name="dw")


@pytest.mark.parametrize("dilation", [1, 27, 81])
def test_kernel_algorithm_at_the_kernel_tile_matches_jax(dilation):
    """The emulation of tests/test_torch_masked_conv.py at the kernel's own
    tile (128 rows x 184 columns, 64-channel K steps: 72 input channels are
    two, the second zero-padded) against JAX in float32, forward and dX, at
    T 300 with lengths T, 0, 1, T - 1 and 129 (T < 324: at dilation 81 the
    outer taps reach past every sequence)."""
    T, cin, cout, taps = 300, 72, 40, 9
    lengths = np.array([T, 0, 1, T - 1, 129], np.int32)
    rng = np.random.default_rng(dilation)
    bound = 1.0 / np.sqrt(cin * taps)
    w = rng.uniform(-bound, bound, (taps, cin, cout)).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, cout).astype(np.float32)
    x = rng.normal(size=(5, T, cin)).astype(np.float32)
    g = rng.normal(size=(5, T, cout)).astype(np.float32)
    mask = jpi.length_mask(jnp.asarray(lengths), T)
    want_y, vjp = jax.vjp(lambda x: jpi._masked_conv(
        {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}, x, mask, dilation), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    valid = np.arange(T)[None, :, None] < lengths[:, None, None]
    y = _emulate_conv_rows(x, w, lengths, dilation) + bias * valid
    _close(y, want_y, name="y")
    _close(_emulate_conv_rows(g, w, lengths, dilation, dx=True), want_dx, name="dx")


# ----------------------------------------------------------------------
# the chain on padded-pitch buffers


def _encoder(n_blocks=2, seed=0):
    cfg = jpi.ProteInferConfig(output_channels=20, kernel_size=5,
                               num_resnet_blocks=n_blocks, num_labels=5)
    params, state = jpi.init_proteinfer(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)
    for bs in state["blocks"]:
        for name in ("bn1", "bn2"):
            n = bs[name]["mean"].shape[0]
            bs[name] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    enc = {k: v for k, v in params.items() if k != "output"}
    tcfg = tpi.ProteInferConfig(output_channels=20, kernel_size=5, num_resnet_blocks=n_blocks,
                                num_labels=5)
    return cfg, tcfg, enc, state


@pytest.mark.parametrize("train", [False, True])
def test_chain_on_padded_pitch_buffers_matches_contiguous_chain_and_jax(monkeypatch, train):
    """``embed_from_ids`` on the CPU keeps the one-hot and every conv output
    at a row pitch of 24 (20 channels; 10 in the bottleneck: 16), which the
    convs read; its embedding (and in train mode the new running
    statistics) equals the contiguous plain chain's bit for bit and JAX's
    ``proteinfer_embed`` within 1e-5."""
    cfg, tcfg, enc, state = _encoder()
    rng = np.random.default_rng(7)
    lengths = np.array([40, 23, 7, 0], np.int32)
    ids = rng.integers(0, 20, size=(4, 40)).astype(np.int8)
    for r, n in enumerate(lengths):
        ids[r, n:] = 20
    want, want_state = jpi.embed_from_ids(
        jax.tree_util.tree_map(jnp.asarray, enc), jax.tree_util.tree_map(jnp.asarray, state),
        jnp.asarray(ids), jnp.asarray(lengths), cfg, train=train)
    tree = from_jax_tree({"p": enc, "s": state})
    onehot = tpi.one_hot_sequences(torch.from_numpy(ids), 20)
    plain, plain_state = tpi.proteinfer_embed_reference(
        tree["p"], tree["s"], onehot.contiguous(), torch.from_numpy(lengths), tcfg, train)
    pitches, conv = [], k7.masked_conv_reference

    def spy(x, *args, **kwargs):
        pitches.append((x.shape[2], k7.pitch_of(x)))
        return conv(x, *args, **kwargs)

    monkeypatch.setattr(k7, "masked_conv_reference", spy)
    got, got_state = tpi.embed_from_ids(tree["p"], tree["s"], torch.from_numpy(ids),
                                        torch.from_numpy(lengths), tcfg, train)
    # eval: the one-hot, then each block's input (20 channels) and bottleneck
    # (10) at pitches 24 and 16; train: the BN outputs in front of the block
    # convs are contiguous (on the card the conv copies them to the pitch)
    assert [p for _, p in pitches] == ([24, 20, 10, 20, 10] if train else [24, 24, 16, 24, 16])
    assert torch.equal(got, plain)
    _close(got.numpy(), want, name="pooled")
    if train:
        for i, (bs, ps, ws) in enumerate(zip(got_state["blocks"], plain_state["blocks"],
                                             want_state["blocks"])):
            for n in ("bn1", "bn2"):
                for k in ("mean", "var"):
                    assert torch.equal(bs[n][k], ps[n][k])
                    _close(bs[n][k].numpy(), ws[n][k], name=f"{i}.{n}.{k}")
