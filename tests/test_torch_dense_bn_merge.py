"""The dense BatchNorm forward's one-read moments against JAX on the CPU.

``protnote_tpu_torch/ops/dense_scorer.py:dense_moments_emulation`` performs
``csrc/bn_relu.cu``'s moment kernel and tail (``bn_relu_dropout_forward``)
operation for operation in float32: the row chunks of ``_chunks``, tiles of
MOM_ROWS rows a lane in warp order, each lane's first valid tile centred
about its first valid row and each later tile about the lane's running mean,
Chan's merge with a compensated mean (hi + lo), the warps merged in order,
then the chunks in order; a column walked row by row in that order in plain
loops gives the same bits.  The card tests hold the kernel to it bit for bit.
Here it is held to JAX's ``batchnorm_apply(train=True, mask=...)`` (two
centred passes over the masked rows) on inputs made with numpy: the mean
within 1e-5 of JAX's largest |mean| and each column's var within 1e-5 of
JAX's, also where one-pass moments lose their bits: columns offset to
|mean| / std = 1e4 either way, an outlier first row, masked rows holding
values 1e6 times the rest, tiles and whole row chunks with no valid row,
and every row masked (n clamped to 1: mean and var exactly 0).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protnote_tpu.models.layers import batchnorm_apply
from protnote_tpu_torch.ops import dense_scorer as ds
from protnote_tpu_torch.ops.streaming_train import _chunks

TOL = 1e-5
N, H = 3001, 128  # four row chunks of 751 rows, 12 tile steps of 8 warps


def _jax_moments(z: np.ndarray, m: np.ndarray):
    """JAX's train-mode mean and biased var: with momentum 1 the new state
    is the batch mean and the unbiased var, var * n / max(n - 1, 1)."""
    p = {"scale": jnp.ones(H), "bias": jnp.zeros(H)}
    s = {"mean": jnp.zeros(H), "var": jnp.ones(H)}
    _, new = batchnorm_apply(p, s, jnp.asarray(z), True, momentum=1.0, mask=jnp.asarray(m))
    n = max(float(m.sum()), 1.0)
    return (np.asarray(new["mean"], np.float64),
            np.asarray(new["var"], np.float64) * max(n - 1.0, 1.0) / n)


def _emulated(z: np.ndarray, m: np.ndarray):
    n = torch.tensor(max(float(m.sum()), 1.0))
    mean, var = ds.dense_moments_emulation(torch.from_numpy(z), torch.from_numpy(m), n)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == var.shape == (H,)
    return mean.double().numpy(), var.double().numpy()


def _inputs(case: str, rng, rows: int = N):
    z = rng.standard_normal((rows, H)).astype(np.float32)
    m = (rng.random((rows, 1)) < 0.9).astype(np.float32)
    if case == "offset":  # |mean| / std = 1e4, both signs, spreads 1e-2 to 1e2
        spread = 10.0 ** rng.uniform(-2, 2, H)
        sign = np.where(np.arange(H) % 2, 1.0, -1.0)
        z = (z * spread + 1e4 * spread * sign).astype(np.float32)
    elif case == "outlier_first_row":
        m[0] = 1.0
        z[0] = 1e6
    elif case == "masked_outliers":
        big = rng.random(rows) < 0.2
        m[big] = 0.0
        z[big] = (1e6 * rng.standard_normal((int(big.sum()), H))).astype(np.float32)
    elif case == "empty_tiles_and_chunks":
        chunks, per = _chunks(rows)
        m[:per] = 0.0  # the first row chunk: every block of it has no valid row
        m[2 * per + 8 : 2 * per + 200] = 0.0  # whole tiles of the third chunk
        m[-5:] = 0.0  # the last rows of the last tile
        z[m[:, 0] == 0] *= 1e3
    elif case == "bf16":
        z = (z + 3.0).astype(np.float32)
        z = torch.from_numpy(z).to(torch.bfloat16).float().numpy()
    return z, m


@pytest.mark.parametrize("case", ["random", "offset", "outlier_first_row", "masked_outliers",
                                  "empty_tiles_and_chunks", "bf16"])
def test_moment_merge_matches_jax(case):
    rng = np.random.default_rng(["random", "offset", "outlier_first_row", "masked_outliers",
                                 "empty_tiles_and_chunks", "bf16"].index(case))
    z, m = _inputs(case, rng)
    mean, var = _emulated(z, m)
    want_mean, want_var = _jax_moments(z, m)
    assert np.isfinite(mean).all() and np.isfinite(var).all()
    assert np.abs(mean - want_mean).max() <= TOL * np.abs(want_mean).max()
    assert (np.abs(var - want_var) <= TOL * want_var).all(), \
        float((np.abs(var - want_var) / want_var).max())


def test_moment_merge_every_row_masked():
    """No valid row anywhere: JAX's n is clamped to 1, so mean and var are
    0; the emulation skips every tile and gives the same zeros."""
    rng = np.random.default_rng(7)
    z = (1e3 * rng.standard_normal((N, H))).astype(np.float32)
    m = np.zeros((N, 1), np.float32)
    mean, var = _emulated(z, m)
    want_mean, want_var = _jax_moments(z, m)
    assert (want_mean == 0).all() and (want_var == 0).all()
    assert (mean == 0).all() and (var == 0).all()


def _kernel_walk(z: np.ndarray, m: np.ndarray, n: float, col: int):
    """One column's mean and var as the kernel's threads compute them,
    written as plain loops over numpy float32 scalars (each operation
    rounded, as the kernel's __fadd_rn / __fmul_rn / __fdiv_rn): each
    chunk's warps walk their tiles, then warp 0 merges warps 1-7; the tail's
    lane j merges chunks j, j + TAIL_LANES, ..., then the lanes merge in a
    tree."""
    f = np.float32
    chunks, per = _chunks(len(z))
    R, W = ds.MOM_ROWS, ds.RED_WARPS

    def merge(na, hi, lo, m2, nb, d, mb):
        a = f(nb / f(na + nb))
        b = f(na * a)
        t = f(d * a)
        s = f(hi + t)
        v = f(s - hi)
        e = f(f(hi - f(s - v)) + f(t - v))
        return s, f(lo + e), f(f(m2 + mb) + f(f(d * d) * b))

    def merge_state(x, y):
        if y[0] == 0:
            return x
        if x[0] == 0:
            return y
        (na, hi, lo, m2), (nb, hb, lb, mb) = x, y
        d = f(f(hb - hi) + f(lb - lo))
        return (f(na + nb), *merge(na, hi, lo, m2, nb, d, mb))

    lanes = [(f(0), f(0), f(0), f(0)) for _ in range(ds.TAIL_LANES)]
    for k in range(chunks):
        first, last = k * per, min(k * per + per, len(z))
        states = []
        for w in range(W):
            cnt, hi, lo, m2 = f(0), f(0), f(0), f(0)
            for r0 in range(first + w * R, last, W * R):
                rows = [r for r in range(r0, r0 + R) if r < last]
                wt = f(0)
                for r in rows:
                    wt = f(wt + m[r, 0])
                if wt == 0:
                    continue
                p = next(z[r, col] for r in rows if m[r, 0] != 0) if cnt == 0 else hi
                u = [f(z[r, col] - p) for r in rows]
                total = f(0)
                for r, ur in zip(rows, u):
                    total = f(total + f(m[r, 0] * ur))
                c = f(total * f(f(1) / wt))
                q = f(0)
                for r, ur in zip(rows, u):
                    v = f(ur - c)
                    q = f(q + f(f(v * v) * m[r, 0]))
                if cnt == 0:
                    s = f(p + c)
                    v = f(s - p)
                    hi, lo, m2 = s, f(f(p - f(s - v)) + f(c - v)), q
                else:
                    hi, lo, m2 = merge(cnt, hi, lo, m2, wt, f(c - lo), q)
                cnt = f(cnt + wt)
            states.append((cnt, hi, lo, m2))
        block = states[0]
        for st in states[1:]:
            block = merge_state(block, st)
        lanes[k % ds.TAIL_LANES] = merge_state(lanes[k % ds.TAIL_LANES], block)
    h = ds.TAIL_LANES // 2
    while h:
        for j in range(h):
            lanes[j] = merge_state(lanes[j], lanes[j + h])
        h //= 2
    return f(lanes[0][1] + lanes[0][2]), f(lanes[0][3] / f(n))


@pytest.mark.parametrize("case", ["random", "offset", "empty_tiles_and_chunks"])
def test_emulation_follows_the_kernels_order(case):
    """The vectorised emulation gives the bits of a column walked row by
    row in the kernel's order (lanes' tiles, warps in order, the tail's
    lanes and tree), on 17,011 rows (18 chunks: two of the tail's lanes
    merge two; the last tiles ragged)."""
    z, m = _inputs(case, np.random.default_rng(11), rows=17011)
    n = max(float(m.sum()), 1.0)
    mean, var = ds.dense_moments_emulation(torch.from_numpy(z), torch.from_numpy(m),
                                           torch.tensor(n))
    for col in (0, H - 1):
        want = _kernel_walk(z, m, n, col)
        assert (float(mean[col]), float(var[col])) == (float(want[0]), float(want[1]))


def test_moment_merge_single_valid_row():
    """A single valid row in the last chunk's last tile: its values are the
    mean and the var is 0, exactly."""
    z = np.random.default_rng(3).standard_normal((N, H)).astype(np.float32)
    m = np.zeros((N, 1), np.float32)
    m[N - 3] = 1.0
    mean, var = _emulated(z, m)
    assert (mean == z[N - 3]).all() and (var == 0).all()
