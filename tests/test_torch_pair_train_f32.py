"""The float32 forms of the training scorer's kernels (MIXED_PRECISION False)
against the JAX package on the CPU: K4 (``pair_scorer_f32.cu:
pair_train_hidden_f32``), K4-bwd (``pair_train_bwd_f32.cu``: dX with the gate
and the side sums, dW) and K5 (``bn_relu.cu``'s float32 entry points).

The kernels cannot run here, so their arithmetic is emulated in their order
of work: every product through the split of a float32 value into three bf16
pieces (``split_bf16x3``, the six products of ``bf16x3_product_emulation``),
stages 64 deep whose sums are added in float32; dX's gate the forward's own
float32 ``a2 + c2``, dc2's sums over the sequences in order, da2's over each
128-label tile (two rows a thread, a butterfly over a warp's 8 row groups,
the 8 warps in order) and then over the tiles in order; dW as ``dz^T @ x1``
64 pair rows a step (label block outermost, every sequence inside), on
``pair_dw_plan``'s 128-column tiles, the cut tiles' pieces added in order;
K5's column sums a warp every 8th row of a row chunk, the 8 warps in order,
then the chunks in order, every product and sum rounded on its own.  The
tensor cores' own additions inside a stage are not modelled (the kernels
keep them to a stage).

Tolerances: the emulation within 1e-5 of each tensor's largest |value| of
JAX's float32 function at Precision.HIGHEST (z, da2, dc2, dW; y, the
moments, dz, dscale, dbias; the decomposed scorer's logits, new running
statistics and every gradient): the split leaves out terms below 2^-24 of
each product, and the rest is float32 summation in other orders.  dW at a
pair depth of 65,536 against a float64 truth within 2 x 2^-24 x
sqrt(rows / 64) of its largest |value|: the float32 additions of its 1,024
stage sums are a random walk whose error grows with the square root of
their count (read: 7.8e-7 against the bound's 3.8e-6).  The card's tests
and ``chip_smoke.py`` read the same figure at their depths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models import layers as jlayers
from protnote_tpu.models.fusion import ProtNoteConfig as JaxConfig
from protnote_tpu.models.fusion import init_protnote as jax_init
from protnote_tpu.ops import streaming_train as jst
from protnote_tpu_torch.models.convert import from_jax_tree
from protnote_tpu_torch.ops import streaming_train as tst
from protnote_tpu_torch.ops.pair_scorer import bf16x3_product_emulation, stacked_pieces

REL_TOL = 1e-5
EPS = np.float32(1e-5)
TILE = tst.F32_TILE  # a dX label tile, a dW output tile
STEP = 64  # pair rows of a dW step


def dw_depth_tol(rows: int) -> float:
    """dW's figure at a pair depth of ``rows`` (see the module docstring)."""
    return 2 * 2.0 ** -24 * float(np.sqrt(rows / STEP))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ----------------------------------------------------------------------
# the kernels' arithmetic, emulated


def k4_forward(a2, c2, w):
    """``pair_train_hidden_f32``: relu(a2[b] + c2[l]) (one float32 add) times
    W through the split, rows b * L + l."""
    B, L = a2.shape[0], c2.shape[0]
    x1 = torch.relu(a2[:, None, :] + c2[None, :, :]).reshape(B * L, -1)
    return bf16x3_product_emulation(x1, w)


def _warp_tree(x):
    """A 128-row tile's column sums as the dX epilogue takes them: rows g and
    g + 8 of each warp's 16 added in the thread, a butterfly over the 8 row
    groups, then the 8 warps in order.  ``x`` (128, K) float32."""
    v = x.view(8, 2, 8, -1)  # (warp, row half, g, K)
    v = v[:, 0] + v[:, 1]  # (warp, g, K)
    for bit in (1, 2, 4):
        v = v + v[:, torch.arange(8) ^ bit]
    t = torch.zeros_like(v[0, 0])
    for w in range(8):
        t = t + v[w, 0]
    return t


def k4_dx(a2, c2, w, dz):
    """``pair_train_dx_f32``: dx1 = dz @ W^T through the split (stages over
    N), gated by a2 + c2 > 0; dc2 summed over the sequences in order, da2 a
    label tile at a time (:func:`_warp_tree`) and then over the tiles."""
    B, L, K = a2.shape[0], c2.shape[0], a2.shape[1]
    dx1 = bf16x3_product_emulation(dz, w.t()).view(B, L, K)
    v = torch.where(a2[:, None, :] + c2[None, :, :] > 0, dx1, torch.zeros(()))
    dc2 = torch.zeros(L, K)
    for b in range(B):
        dc2 = dc2 + v[b]
    tiles = -(-L // TILE)
    padded = torch.zeros(B, tiles * TILE, K)
    padded[:, :L] = v
    da2 = torch.zeros(B, K)
    for lt in range(tiles):
        part = torch.stack([_warp_tree(padded[b, lt * TILE:(lt + 1) * TILE]) for b in range(B)])
        da2 = da2 + part
    return da2, dc2


def _pair_relu(a, c):
    return torch.relu(a + c)


def k4_dw(a2, c2, dz, plan, x1_of=_pair_relu):
    """``pair_train_dw_f32`` on ``plan`` (``pair_dw_plan`` with 128-column
    tiles): each item's tile of dW^T = dz^T @ x1 over its label blocks, 64
    pair rows a step (every sequence inside a label block; rows past L read
    dz and c2 as zeros), each step's split product added in float32; whole
    tiles stored, cut tiles' pieces added in order by the second pass.
    ``x1_of(a2[b], c2 rows)`` forms x1 (``pair_train_dw_prod_f32``: the
    product)."""
    B, K = a2.shape
    L, N = c2.shape[0], dz.shape[1]
    lblocks = -(-L // STEP)
    rows = lblocks * STEP
    dzp = torch.zeros(B, rows, N)
    dzp[:, :L] = dz.view(B, L, N)
    cp = torch.zeros(rows, K)
    cp[:L] = c2
    dw = torch.empty(K, N)
    slots = {}
    for t in range(plan.items):
        k0, n0, lb0, lb1, slot = plan.item(t)
        acc = torch.zeros(TILE, TILE)  # (n, k)
        for lb in range(lb0, lb1):
            ls = slice(lb * STEP, (lb + 1) * STEP)
            for b in range(B):
                x1 = x1_of(a2[b, k0:k0 + TILE], cp[ls, k0:k0 + TILE])
                acc = acc + bf16x3_product_emulation(dzp[b, ls, n0:n0 + TILE].t(), x1)
        if slot is None:
            dw[k0:k0 + TILE, n0:n0 + TILE] = acc.t()
        else:
            slots[slot] = acc.t()
    for tt in range(plan.tail if plan.slots else 0):
        k0, n0, _, _, _ = plan.item(plan.full + tt)
        tot = torch.zeros(TILE, TILE)
        for p in range(plan.pieces):
            tot = tot + slots[p * plan.tail + tt]
        dw[k0:k0 + TILE, n0:n0 + TILE] = tot
    return dw


def k4_backward(a2, c2, w, dz, num_sms=3):
    da2, dc2 = k4_dx(a2, c2, w, dz)
    plan = tst.pair_dw_plan(a2.shape[0], c2.shape[0], a2.shape[1], w.shape[1], num_sms,
                            block_n=TILE)
    return da2, dc2, k4_dw(a2, c2, dz, plan)


def _kernel_sums(parts, N):
    """K5's column sums of each (N, H) float32 array of ``parts``: per row
    chunk (``_chunks``) a warp walks every 8th row adding in order, the 8
    warps added in order, then the chunks in order."""
    chunks, per = tst._chunks(N)
    per8 = -(-per // 8) * 8
    out = []
    for x in parts:
        H = x.shape[1]
        pad = np.zeros((chunks * per, H), np.float32)
        pad[:N] = x
        blocks = np.zeros((chunks, per8, H), np.float32)
        blocks[:, :per] = pad.reshape(chunks, per, H)
        blocks = blocks.reshape(chunks, per8 // 8, 8, H)
        acc = np.zeros((chunks, 8, H), np.float32)
        for i in range(per8 // 8):
            acc = acc + blocks[:, i]
        t = np.zeros((chunks, H), np.float32)
        for w in range(8):
            t = t + acc[:, w]
        tot = np.zeros(H, np.float32)
        for c in range(chunks):
            tot = tot + t[c]
        out.append(tot)
    return out


def k5_forward(z, rows, n, scale, bias, running):
    """``bn_relu_forward_f32``: (y, mean, var, istd, inv, shift)."""
    z, m = z.numpy(), rows.numpy()
    r = running.detach().numpy().astype(np.float32)
    zc = z - r
    zm = zc * m
    t1, t2 = _kernel_sums([zm, zm * zc], z.shape[0])
    n = np.float32(n)
    s1, s2 = t1 / n, t2 / n
    mean = s1 + r
    var = np.maximum(s2 - s1 * s1, np.float32(0))
    istd = np.float32(1) / np.sqrt(var + EPS)
    inv = istd * scale.detach().numpy()
    shift = bias.detach().numpy() - mean * inv
    y = np.maximum(z * inv + shift, np.float32(0))
    return tuple(torch.from_numpy(np.ascontiguousarray(t)) for t in
                 (y, mean, var, istd, inv, shift))


def k5_grads(z, dy, rows, n, scale, mean, istd, inv, shift):
    """``bn_relu_backward_f32``: (dz, dscale, dbias)."""
    z, dy, m = z.numpy(), dy.float().numpy(), rows.numpy()
    mean, istd, inv, shift = (t.numpy() for t in (mean, istd, inv, shift))
    g = np.where(z * inv + shift > 0, dy, np.float32(0))
    xhat = (z - mean) * istd
    G1, G2 = _kernel_sums([g, g * xhat], z.shape[0])
    mn = m / np.float32(n)
    coef = istd * scale.detach().numpy()
    dz = coef * (g - mn * (G1 + G2 * xhat))
    return (torch.from_numpy(np.ascontiguousarray(dz)), torch.from_numpy(G2),
            torch.from_numpy(G1))


def emulated_pair_hidden(a2, c2, w):
    return tst._PairHidden.apply(a2, c2, w, k4_forward, k4_backward)


def emulated_bn_relu(z, rows, n, scale, bias, running):
    return tst._BnRelu.apply(z, rows, n, scale, bias, running, k5_forward, k5_grads)


# ----------------------------------------------------------------------
# each kernel against JAX


def _jax_k4(a2, c2, w, dz):
    """JAX's first hidden GEMM of the decomposed scorer
    (protnote_tpu/ops/streaming_train.py:238-240) in float32 and its vjp."""
    B, L, K = a2.shape[0], c2.shape[0], a2.shape[1]

    def f(a2_, c2_, w_):
        h = jax.nn.relu(a2_[:, None, :] + c2_[None, :, :]).reshape(B * L, K)
        return jlayers.linear({"kernel": w_}, h)

    z, vjp = jax.vjp(f, jnp.asarray(a2), jnp.asarray(c2), jnp.asarray(w))
    return np.asarray(z), [np.asarray(g) for g in vjp(jnp.asarray(dz))]


@pytest.mark.parametrize("B,L,K,N", [(5, 150, 128, 128), (3, 301, 128, 256), (2, 1, 256, 128)])
def test_k4_f32_emulation_matches_jax(B, L, K, N):
    """K4's float32 forward and K4-bwd's two kernels, emulated, against JAX's
    float32 GEMM and its vjp: L not a multiple of 128 (a ragged last label
    tile; 301 labels: three tiles), one label, dz zero at masked pairs, dW's
    tiles cut into pieces (3 SMs)."""
    rng = np.random.default_rng(B * 100 + L)
    a2, c2 = _f32(rng, B, K), _f32(rng, L, K)
    w = _f32(rng, K, N, scale=(2.0 / K) ** 0.5)
    rows = (rng.random((B * L, 1)) < 0.8).astype(np.float32)
    dz = _f32(rng, B * L, N) * rows
    want_z, (want_da2, want_dc2, want_dw) = _jax_k4(a2, c2, w, dz)
    t = [torch.from_numpy(x) for x in (a2, c2, w, dz)]
    z = k4_forward(*t[:3])
    assert z.dtype == torch.float32 and z.shape == (B * L, N)
    assert _rel(z, want_z) <= REL_TOL
    got = k4_backward(*t)
    for name, g, w_ in zip(("da2", "dc2", "dw"), got, (want_da2, want_dc2, want_dw)):
        assert g.shape == w_.shape and np.abs(w_).max() > 0
        assert _rel(g, w_) <= REL_TOL, (name, _rel(g, w_))


def test_k4_f32_gate_is_the_forward_expression():
    """dX's gate is the forward's float32 a2 + c2 > 0: at sums that round to
    0 or just past it (a2 = -c2, a2 = -c2 +- an ulp) the gradient reaches
    exactly the pairs whose x1 is positive."""
    K = 128
    c2 = np.full((3, K), 0.1, np.float32)
    a2 = np.stack([-c2[0], np.nextafter(-c2[0], np.float32(1)),
                   np.nextafter(-c2[0], np.float32(-1))]).astype(np.float32)
    w = np.eye(K, dtype=np.float32)
    dz = np.ones((9, K), np.float32)
    t = [torch.from_numpy(x) for x in (a2, c2, w, dz)]
    x1 = torch.relu(t[0][:, None] + t[1][None]).reshape(9, K)
    da2, dc2 = k4_dx(*t)
    assert torch.equal(da2, (x1 > 0).float().view(3, 3, K).sum(1))
    assert torch.equal(da2[:, 0], torch.tensor([0.0, 3.0, 0.0]))
    _, (want_da2, _, _) = _jax_k4(a2, c2, w, dz)
    np.testing.assert_array_equal(da2.numpy(), want_da2)


def test_k4_dw_emulation_at_depth_against_float64():
    """dW at a pair depth of 65,536 (2 sequences x 32,768 labels, one tile,
    1,024 steps added in float32) against float64: within the depth's
    figure, which the plain float32 product also meets."""
    B, L, K = 2, 32768, 128
    rng = np.random.default_rng(5)
    a2, c2 = _f32(rng, B, K), _f32(rng, L, K)
    dz = _f32(rng, B * L, K, scale=1e-3)
    plan = tst.pair_dw_plan(B, L, K, K, 1, block_n=TILE)
    assert (plan.full, plan.items) == (1, 1)
    got = k4_dw(torch.from_numpy(a2), torch.from_numpy(c2), torch.from_numpy(dz), plan)
    x1 = np.maximum(a2.astype(np.float64)[:, None] + c2[None], 0).reshape(B * L, K)
    truth = x1.T @ dz.astype(np.float64)
    tol = dw_depth_tol(B * L)
    assert 3e-6 < tol < 4e-6
    assert _rel(got, truth) <= tol
    plain = (torch.from_numpy(x1.astype(np.float32)).t() @ torch.from_numpy(dz)).numpy()
    assert _rel(plain, truth) <= tol


def _jax_bn(z, rows, n, scale, bias, running, dy):
    out, vjp = jax.vjp(lambda z_, s_, b_: jst._bn_relu(z_, jnp.asarray(rows), jnp.float32(n),
                                                       s_, b_, jnp.asarray(running)),
                       jnp.asarray(z), jnp.asarray(scale), jnp.asarray(bias))
    dz, ds, db = vjp((jnp.asarray(dy), jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    return [np.asarray(x) for x in (*out, dz, ds, db)]


@pytest.mark.parametrize("N,H", [(3001, 256), (700, 512)])
def test_k5_f32_emulation_matches_jax(N, H):
    """K5's float32 kernels, emulated (the column sums in their chunk and
    warp order over 4 or 1 row chunks), against JAX's ``_bn_relu`` custom
    VJP in float32: y, mean, var, dz, dscale, dbias, with masked rows and a
    running mean far from the batch mean."""
    rng = np.random.default_rng(N)
    z = _f32(rng, N, H) + np.float32(3.0)
    rows = (rng.random((N, 1)) < 0.85).astype(np.float32)
    n = np.float32(rows.sum())
    scale = rng.uniform(0.5, 1.5, H).astype(np.float32)
    bias = rng.normal(0, 0.2, H).astype(np.float32)
    running = np.full(H, 2.5, np.float32)
    dy = _f32(rng, N, H) * rows
    want = _jax_bn(z, rows, n, scale, bias, running, dy)
    t = {k: torch.from_numpy(v) for k, v in dict(z=z, rows=rows, scale=scale, bias=bias,
                                                 running=running, dy=dy).items()}
    y, mean, var, istd, inv, shift = k5_forward(t["z"], t["rows"], n, t["scale"], t["bias"],
                                                t["running"])
    dz, ds, db = k5_grads(t["z"], t["dy"], t["rows"], n, t["scale"], mean, istd, inv, shift)
    assert tst._chunks(N)[0] == (4 if N > 3000 else 1)
    for name, g, w in zip(("y", "mean", "var", "dz", "dscale", "dbias"),
                          (y, mean, var, dz, ds, db), want):
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))
    assert float((y > 0).float().mean()) > 0.2


# ----------------------------------------------------------------------
# the decomposed scorer through the emulated kernels against JAX

CB, CL, CD = 5, 150, 64  # 150 labels: two label tiles, the second ragged


def _chain_weights(fusion, seed=0):
    cfg = JaxConfig(protein_embedding_dim=20, label_embedding_dim=20, latent_dim=CD,
                    projection_head_num_layers=2, output_mlp_num_layers=3,
                    output_mlp_hidden_dim_scale_factor=2, feature_fusion=fusion)
    params, state = jax_init(jax.random.PRNGKey(seed), cfg)
    p = jax.tree_util.tree_map(np.asarray, params["output_mlp"])
    s = jax.tree_util.tree_map(np.asarray, state["output_mlp"])
    rng = np.random.default_rng(seed)
    for i, st in enumerate(s["bns"]):
        n = st["mean"].shape[0]
        p["bns"][i] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                       "bias": rng.normal(0, 0.2, n).astype(np.float32)}
        s["bns"][i] = {"mean": rng.normal(0, 0.3, n).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    for lin in p["layers"] + [p["out"]]:
        lin["kernel"] = lin["kernel"] * np.float32(6 ** 0.5)
    return p, s


def _chain_inputs(seed=1):
    rng = np.random.default_rng(seed)
    em = np.ones(CB, np.float32)
    em[-1] = 0
    lm = (rng.random(CL) < 0.9).astype(np.float32)
    return (_f32(rng, CB, CD), _f32(rng, CL, CD), em, lm,
            rng.normal(size=(CB, CL)).astype(np.float32))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("fusion", ["concatenation", "concatenation_diff"])
def test_decomposed_f32_through_emulated_kernels_matches_jax(fusion, remat):
    """``pair_logits_dense_decomposed``'s float32 chain with K4, K4-bwd and
    K5 replaced by their emulations (the card's launches: K4 and K4-bwd for
    the first hidden GEMM, K5 for both BatchNorms after it) against JAX's
    float32 function and its gradients, masked sequences and labels, H 128:
    the logits, the new running statistics, and the gradients of P_e, L_e
    and every output-MLP parameter, each within 1e-5 of its largest
    |value|."""
    p, s = _chain_weights(fusion)
    P_e, L_e, em, lm, wts = _chain_inputs()
    w = wts * em[:, None] * lm[None, :]

    def f(p_, P_, L_):
        lg, new = jst.pair_logits_dense_decomposed(
            p_, jax.tree_util.tree_map(jnp.asarray, s), P_, L_, fusion,
            example_mask=jnp.asarray(em), label_mask=jnp.asarray(lm),
            compute_dtype=jnp.float32, remat=remat)
        return jnp.sum(jax.nn.sigmoid(lg) * jnp.asarray(w)), (lg, new)

    (_, (want_lg, want_new)), want_g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(P_e), jnp.asarray(L_e))

    t = from_jax_tree({"p": p, "s": s})
    leaves = []

    def track(x):
        x = x.clone().requires_grad_(True)
        leaves.append(x)
        return x

    tp = jax.tree_util.tree_map(track, t["p"])
    Pg, Lg = track(torch.from_numpy(P_e)), track(torch.from_numpy(L_e))
    lg, new = tst._decomposed(tp, t["s"], Pg, Lg, fusion, torch.from_numpy(em),
                              torch.from_numpy(lm), torch.float32, remat,
                              emulated_pair_hidden, emulated_bn_relu)
    (torch.sigmoid(lg) * torch.from_numpy(w)).sum().backward()
    assert lg.dtype == torch.float32 and float(np.std(np.asarray(want_lg))) > 0.5
    assert _rel(lg.detach(), want_lg) <= REL_TOL
    got_new = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda x: x.numpy(), new))
    for a, b in zip(got_new, jax.tree_util.tree_leaves(want_new)):
        assert _rel(a, b) <= REL_TOL
    got_g = jax.tree_util.tree_leaves((jax.tree_util.tree_map(lambda x: x.grad.numpy(), tp),
                                       Pg.grad.numpy(), Lg.grad.numpy()))
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(got_g) == len(want_leaves) == 13
    for a, b in zip(got_g, want_leaves):
        assert _rel(a, b) <= REL_TOL


# ----------------------------------------------------------------------
# the launch plans


@pytest.mark.parametrize("B,L,N", [(3, 301, 256), (2, 128, 128), (4, 1, 384), (1, 129, 128)])
def test_f32_forward_plan_writes_every_element_once(B, L, N):
    """The float32 K4 forward's tiles (rows padded to 128 a sequence) and
    their clipped store boxes write each (sequence, label, column) of z once
    and nothing past L; the tiles stay in one sequence."""
    plan = tst.pair_train_f32_plan(B, L, 128, N, num_sms=7)
    assert plan.grid == min(7, plan.tiles) and plan.nl_pad % 128 == 0 and plan.nl_pad >= L
    count = np.zeros((B, L, N), np.int32)
    for t in range(plan.tiles):
        b, l0, n0 = plan.tile(t)
        assert 0 <= b < B and l0 < plan.nl_pad and n0 < N
        for bb, ls, le, ns, ne in plan.stores(t):
            assert bb == b and l0 <= ls < le <= min(l0 + 128, L)
            count[bb, ls:le, ns:ne] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("B,L,K", [(3, 301, 256), (32, 40, 512), (1, 1, 128)])
def test_f32_dx_plan_covers_every_unit_once(B, L, K):
    """dX's units cover each (label, input column) once, column tiles
    fastest; da2's partials are one a label tile."""
    plan = tst.pair_dx_f32_plan(B, L, K, 256, num_sms=132)
    assert plan.tiles_l == -(-L // 128) and plan.grid == min(132, plan.units)
    count = np.zeros((plan.tiles_l * 128, K), np.int32)
    for u in range(plan.units):
        l0, k0 = plan.unit(u)
        count[l0:l0 + 128, k0:k0 + tst.F32_DX_COLS] += 1
    assert (count == 1).all()
    assert plan.unit(1) == ((0, tst.F32_DX_COLS) if K > tst.F32_DX_COLS else (128, 0))


@pytest.mark.parametrize("B,L,K,N,sms", [(32, 32102, 3072, 3072, 132), (2, 130, 256, 384, 7),
                                         (5, 150, 128, 128, 3)])
def test_f32_dw_plan_covers_every_pair_row_once(B, L, K, N, sms):
    """dW's 128-column tiles: every output element's reduction covers every
    label block once, whole or over its pieces; at the training shape 528
    tiles whole and 48 cut into 2."""
    plan = tst.pair_dw_plan(B, L, K, N, sms, block_n=TILE)
    assert plan.block_n == TILE and plan.tiles == (K // TILE) * (N // TILE)
    cover = np.zeros((K // TILE, N // TILE, plan.lblocks), np.int32)
    slots = set()
    for t in range(plan.items):
        k0, n0, lb0, lb1, slot = plan.item(t)
        cover[k0 // TILE, n0 // TILE, lb0:lb1] += 1
        if slot is not None:
            slots.add(slot)
    assert (cover == 1).all() and slots == set(range(plan.slots))
    if (B, L) == (32, 32102):
        assert (plan.full, plan.pieces, plan.items, plan.slots) == (528, 2, 624, 96)


def test_f32_shared_memory_within_a_block():
    """The shared memory of each float32 launch, as the sources lay it out,
    within the 227 KB a block may use: the forward's two 80 KB stages and
    store boxes, dX's three 56 KB stages, dW's two 64 KB stages and two
    piece buffers."""
    smem = tst.f32_train_smem_bytes()
    assert smem == {"forward": 198176, "dx": 177200, "dw": 230432}
    assert max(smem.values()) <= tst.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("K,N", [(64, 256), (128, 200), (0, 128)])
def test_f32_plans_refuse_widths(K, N):
    with pytest.raises(ValueError, match="multiples of 128"):
        tst.pair_train_f32_plan(5, 301, K, N)
    if K % 128 or not K:
        with pytest.raises(ValueError, match="multiples of 128"):
            tst.pair_dx_f32_plan(5, 301, K, N)


def test_stacked_pieces_layouts():
    """W's pieces as the float32 kernels load them: (3N, K) transposed for
    the forward, (3K, N) W's own rows for dX; each sums back to W exactly."""
    rng = np.random.default_rng(3)
    W = torch.from_numpy(_f32(rng, 256, 384))
    t, r = stacked_pieces(W, transpose=True), stacked_pieces(W, transpose=False)
    assert t.shape == (3 * 384, 256) and r.shape == (3 * 256, 384)
    assert t.dtype == r.dtype == torch.bfloat16 and t.is_contiguous() and r.is_contiguous()
    assert torch.equal(sum(t[p * 384:(p + 1) * 384].double().t() for p in range(3)), W.double())
    assert torch.equal(sum(r[p * 256:(p + 1) * 256].double() for p in range(3)), W.double())


# ----------------------------------------------------------------------
# the scorer the dispatch takes, and what the card refuses


SCORER_SETTINGS = [
    ({}, "decomposed"),
    ({"FEATURE_FUSION": "concatenation_diff"}, "decomposed"),
    ({"PAIR_BACKEND": "tiled_int8"}, "decomposed"),
    ({"GRADIENT_CHECKPOINTING": True}, "decomposed"),
    ({"TRAIN_STREAMING_LABEL_TILE": 8}, "streamed"),
    ({"TRAIN_STREAMING_LABEL_TILE": 8, "PAIR_BACKEND": "tiled"}, "streamed"),
    ({"TRAIN_STREAMING_LABEL_TILE": 8, "PAIR_BACKEND": "dense"}, "dense"),
    ({"PAIR_BACKEND": "tiled"}, "dense"),
    ({"PAIR_BACKEND": "dense"}, "dense"),
    ({"OUTPUT_MLP_DROPOUT": 0.1}, "dense"),
    ({"OUTPUT_MLP_BATCHNORM": False}, "dense"),
    ({"FEATURE_FUSION": "concatenation_prod"}, "dense"),
    ({"FEATURE_FUSION": "similarity"}, "similarity"),
]


@pytest.mark.parametrize("params,scorer", SCORER_SETTINGS)
def test_train_scorer_is_the_dispatch(params, scorer, monkeypatch):
    """``train_scorer`` names the scorer ``protnote_forward`` trains
    through (each scorer patched to record its call), and float32 training
    on the card passes the check whichever scorer it takes (each has its
    float32 kernels), as do the encoder trained beside it (K7's float32
    training kernels, item 16c) and the label tower (K8a, K8b and their
    backward in float32, item 16d)."""
    from protnote_tpu_torch.cli import main as tmain
    from protnote_tpu_torch.models import fusion

    cfg = fusion.ProtNoteConfig.from_params(
        params, protein_embedding_dim=16, label_embedding_dim=16, latent_dim=16,
        projection_head_num_layers=2, output_mlp_hidden_dim_scale_factor=1)
    assert fusion.train_scorer(cfg) == scorer
    calls = []

    def record(name):
        def fn(p, s, P_e, L_e, *args, **kwargs):
            calls.append(name)
            B, L = P_e.shape[0], L_e.shape[0]
            return torch.zeros(B, L), s

        return fn

    for name, attr in (("streamed", "pair_logits_streaming_train"),
                       ("decomposed", "pair_logits_dense_decomposed"),
                       ("dense", "pair_logits_dense")):
        monkeypatch.setattr(fusion, attr, record(name))
    params_t, state = fusion.init_protnote(torch.Generator().manual_seed(0), cfg)
    fusion.protnote_forward(params_t, state, torch.randn(3, 16), torch.randn(4, 16), cfg,
                            train=True, generator=torch.Generator().manual_seed(1))
    assert calls == ([] if scorer == "similarity" else [scorer])
    args = tmain.build_argparser().parse_args(["--train-path-name", "TRAIN_DATA_PATH",
                                               "--device", "cuda"])
    card = dict(params, MIXED_PRECISION=False)
    tmain.refuse_unported(args, card)
    for encoder in ("TRAIN_SEQUENCE_ENCODER", "ENCODER_BN_TRAIN_MODE"):
        tmain.refuse_unported(args, dict(card, **{encoder: True}))
    tmain.refuse_unported(args, dict(card, TRAIN_SEQUENCE_ENCODER=True,
                                     LABEL_ENCODER_NUM_TRAINABLE_LAYERS=2))
