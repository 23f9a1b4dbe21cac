"""Kernel 5 (the wide-table aggregate, ops.gcn.aggregate) through its plain
PyTorch version (what the wrapper runs for CPU tensors) against the JAX
package, seeded numpy inputs:

  gcn_aggregate (the XLA path the JAX package runs off the TPU): D = 3 and
      9, fp32 at rtol = atol = 1e-5; bf16 tables at 1e-2 * max(1, max|ref|)
      (the port rounds each eager bf16 op, XLA fuses some of them); the
      theta-only form (no table) at 1e-5, since both compute it in bf16
      the same way;
  the TPU kernel itself, pallas_gcn._gcn_aggregate_fwd_pallas in
      interpret mode, on the table gathered as gcn_aggregate gathers it:
      fp32 tables of bf16-representable values at 1e-5 (the TPU kernel
      reads its table in bf16 and computes in fp32); theta-only at
      1e-2 * max(1, max|ref|), the gap between its fp32 and the bf16 of
      the XLA path;
  the autograd.Function's backward (its forward fed by the plain version,
      since the kernel runs only on a card) against jax.vjp of the XLA
      path at 1e-5; idx gets no gradient;
  NaN and inf (an inf table row, which a theta of 0 turns into NaN; a NaN
      nd entry; a NaN direction column): the plain versions of kernels 5
      and 1 give NaN where the XLA gcn_aggregate and gcn_aggregate_linear
      do, and agree elsewhere at the tolerances above;
  kernel 5's order written in PyTorch (16-byte column chunks, relu as a
      max with 0, the maxima staged in the table's dtype, the supports
      summed in order with a rounding per add) against aggregate_plain,
      bit for bit, NaN included.
The kernel itself runs only on a CUDA card: tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_estimation_tpu.ops import pallas_gcn as pg
from pose_estimation_tpu_torch.ops import gcn

torch.set_num_threads(1)


def _case(seed, b=2, n=40, m=56, k=5, d=3, s=3, o=16, bf16_table=False):
    rng = np.random.RandomState(seed)
    nd = rng.randn(b, n, k, d).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    dirs = rng.randn(d, s * o).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    feats = rng.randn(b, m, s * o).astype(np.float32)
    if bf16_table:
        feats = np.asarray(jnp.asarray(feats, jnp.bfloat16), np.float32)
    idx = rng.randint(0, m, (b, n, k)).astype(np.int32)
    return nd, dirs, feats, idx, s


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _close(got, ref, rtol):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    tol = rtol * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("d", [3, 9])
@pytest.mark.parametrize("n,m,k", [(40, 56, 5), (67, 30, 8)])
def test_aggregate_fp32_matches_xla(d, n, m, k):
    nd, dirs, feats, idx, s = _case(d + n, n=n, m=m, k=k, d=d)
    ref = pg.gcn_aggregate(*map(jnp.asarray, (nd, dirs, feats, idx)), s)
    got = gcn.aggregate(*_t(nd, dirs, feats, idx), s)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [3, 9])
def test_aggregate_bf16_matches_xla(d):
    nd, dirs, feats, idx, s = _case(10 + d, d=d)
    ref = pg.gcn_aggregate(jnp.asarray(nd), jnp.asarray(dirs),
                           jnp.asarray(feats, jnp.bfloat16),
                           jnp.asarray(idx), s)
    tnd, tdirs, tf, tidx = _t(nd, dirs, feats, idx)
    got = gcn.aggregate(tnd, tdirs, tf.to(torch.bfloat16), tidx, s)
    assert got.dtype == torch.float32
    _close(got, ref, 1e-2)


def test_aggregate_theta_only_matches_xla():
    nd, dirs, _, idx, s = _case(20)
    ref = pg.gcn_aggregate(jnp.asarray(nd), jnp.asarray(dirs), None,
                           jnp.asarray(idx), s)
    got = gcn.aggregate(*_t(nd, dirs), None, torch.from_numpy(idx), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _gathered(feats, idx):
    """The [B, N, K, S*O] table gcn_aggregate hands the TPU kernel
    (pallas_gcn.py:66-67)."""
    return jnp.take_along_axis(jnp.asarray(feats)[:, :, None, :],
                               jnp.asarray(idx)[..., None], axis=1)


@pytest.mark.parametrize("d", [3, 9])
@pytest.mark.parametrize("n", [64, 70])
def test_aggregate_matches_pallas_interpret(d, n):
    """N=70 pads to the TPU kernel's 64-point tile."""
    nd, dirs, feats, idx, s = _case(30 + d + n, n=n, d=d, bf16_table=True)
    ref = pg._gcn_aggregate_fwd_pallas(jnp.asarray(nd), jnp.asarray(dirs),
                                       _gathered(feats, idx), s,
                                       interpret=True)
    got = gcn.aggregate(*_t(nd, dirs, feats, idx), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_aggregate_theta_only_matches_pallas_interpret():
    nd, dirs, _, idx, s = _case(40, n=64)
    ref = pg._gcn_aggregate_fwd_pallas(jnp.asarray(nd), jnp.asarray(dirs),
                                       None, s, interpret=True)
    got = gcn.aggregate(*_t(nd, dirs), None, torch.from_numpy(idx), s)
    _close(got, ref, 1e-2)


def test_aggregate_theta_only_takes_3d_directions_only():
    nd, dirs, _, idx, s = _case(41, d=9)
    with pytest.raises(ValueError):
        gcn.aggregate(*_t(nd, dirs), None, torch.from_numpy(idx), s)
    with pytest.raises(ValueError):
        gcn.aggregate_plain(*_t(nd, dirs), None, torch.from_numpy(idx), s)


@pytest.mark.parametrize("through", ["plain", "function"])
@pytest.mark.parametrize("d", [3, 9])
def test_aggregate_grad_matches_jax_vjp(through, d, monkeypatch):
    nd, dirs, feats, idx, s = _case(50 + d, d=d)
    cot = np.random.RandomState(51).randn(2, 40, 16).astype(np.float32)
    f = lambda a, b, c: pg.gcn_aggregate(a, b, c, jnp.asarray(idx), s)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (nd, dirs, feats)))
    ref = vjp(jnp.asarray(cot))
    leaves = [t.requires_grad_() for t in _t(nd, dirs, feats)]
    tidx = torch.from_numpy(idx)
    if through == "plain":
        out = gcn.aggregate(*leaves, tidx, s)
    else:
        monkeypatch.setattr(gcn, "_aggregate_launch",
                            lambda *a: gcn.aggregate_plain(*a))
        out = gcn._Aggregate.apply(s, *leaves, tidx)
    out.backward(torch.from_numpy(cot))
    for t, r in zip(leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_aggregate_function_gives_idx_no_gradient(monkeypatch):
    nd, dirs, feats, idx, s = _case(60)
    monkeypatch.setattr(gcn, "_aggregate_launch",
                        lambda *a: gcn.aggregate_plain(*a))
    tnd, tdirs, tf, tidx = _t(nd, dirs, feats, idx)
    tf.requires_grad_()
    gcn._Aggregate.apply(s, tnd, tdirs, tf, tidx).sum().backward()
    ref = _t(feats)[0].requires_grad_()
    gcn.aggregate_plain(tnd, tdirs, ref, tidx, s).sum().backward()
    assert torch.equal(tf.grad, ref.grad)
    assert tidx.grad is None


def test_aggregate_has_no_fallback():
    """A tensor neither on the CPU nor on a card raises; it is not quietly
    computed by the plain version."""
    meta = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt,
                                                        device="meta")
    with pytest.raises(ValueError):
        gcn.aggregate(meta(1, 8, 2, 3), meta(3, 4), meta(1, 8, 4),
                      meta(1, 8, 2, dt=torch.int32), 2)


def _clear_cols(nd, dirs, idx, b, r):
    """Columns of table row r of batch element b where every neighbour
    slot that reads the row has |theta| >= 0.05: an infinite entry there
    gives inf or NaN by theta's sign alone, whatever the bf16 rounding of
    theta (the XLA path rounds the dot once, the port per operation)."""
    th = np.abs(np.einsum("kd,dc->kc", nd[b][idx[b] == r], dirs)).min(0)
    cols = th >= 0.05
    assert cols.sum() >= 4
    return cols


def _poisoned(seed, d=3, s=3, o=16, n=40, m=56, k=5):
    """_case's inputs with inf in table row idx[0, 3, 2] and -inf in row
    idx[1, 7, 0] (where _clear_cols allows), a NaN nd entry and a NaN
    direction column."""
    nd, dirs, feats, idx, s = _case(seed, n=n, m=m, k=k, d=d, s=s, o=o)
    for b, r, v in ((0, idx[0, 3, 2], np.inf), (1, idx[1, 7, 0], -np.inf)):
        feats[b, r, _clear_cols(nd, dirs, idx, b, r)] = v
    nd[1, 11, 3, d - 1] = np.nan
    dirs[0, o + 5] = np.nan
    return nd, dirs, feats, idx, s


def _same_nans(got, ref, rtol):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    live = np.isfinite(ref)
    tol = rtol * max(1.0, float(np.abs(ref[live]).max()))
    assert float(np.abs(got[live] - ref[live]).max()) <= tol


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3, 9])
def test_aggregate_nan_positions_match_xla(d, dt):
    nd, dirs, feats, idx, s = _poisoned(70 + d, d=d)
    ref = pg.gcn_aggregate(jnp.asarray(nd), jnp.asarray(dirs),
                           jnp.asarray(feats, getattr(jnp, dt)),
                           jnp.asarray(idx), s)
    tnd, tdirs, tf, tidx = _t(nd, dirs, feats, idx)
    got = gcn.aggregate(tnd, tdirs, tf.to(getattr(torch, dt)), tidx, s)
    # bf16: up to two ulps of the largest finite output (per-op rounding
    # against XLA's fused dot)
    _same_nans(got, ref, 1e-5 if dt == "float32" else 2e-2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_linear_nan_positions_match_xla(dt):
    """Kernel 1's plain version (one stream of linear_multi): an inf in an
    input row makes that neighbour's table row infinite."""
    nd, dirs, _, idx, s = _poisoned(80)
    rng = np.random.RandomState(81)
    x = rng.randn(2, 56, 12).astype(np.float32)
    w = (rng.randn(12, s * 16) * 0.2).astype(np.float32)
    b = (rng.randn(s * 16) * 0.1).astype(np.float32)
    r = idx[0, 3, 2]
    x[0, r, 4] = np.inf     # table row r: +-inf, or NaN where w[4] is 0
    w[4, ~_clear_cols(nd, dirs, idx, 0, r)] = 0.0
    jdt = getattr(jnp, dt)
    ref = pg.gcn_aggregate_linear(jnp.asarray(nd), jnp.asarray(dirs),
                                  jnp.asarray(x, jdt), jnp.asarray(w),
                                  jnp.asarray(b), jnp.asarray(idx), s)
    tnd, tdirs, tx, tw, tb, tidx = _t(nd, dirs, x, w, b, idx)
    got = gcn.linear_multi([tnd], [tdirs], [tx.to(getattr(torch, dt))], [tw],
                           [tb], tidx, s)[0]
    _same_nans(got, ref, 1e-5 if dt == "float32" else 2e-2)


def _kernel5_order(nd, dirs, feats, idx, s):
    """csrc/gcn.cu:wide_agg_kernel's order in PyTorch: each 16 bytes of
    columns of the S*O row on its own (8 bf16 or 4 fp32), theta summed
    from the first term on, relu as a max with +0, the column maxima over
    k staged in the table's dtype, then the supports summed in order,
    ((m0 + m1) + m2) + ..., each add in fp32 rounded to that dtype."""
    dt = feats.dtype
    b, n, k, d = nd.shape
    so = feats.shape[-1]
    o = so // s
    c = 16 // feats.element_size()
    nd, dirs = nd.to(dt), dirs.to(dt)
    zero = torch.zeros((), dtype=dt)
    staged = torch.empty((b, n, so), dtype=dt)
    for c0 in range(0, so, c):
        cols = slice(c0, min(c0 + c, so))
        m = None
        for kk in range(k):
            th = nd[:, :, kk, 0:1] * dirs[0, cols]
            for i in range(1, d):
                th = th + nd[:, :, kk, i:i + 1] * dirs[i, cols]
            v = torch.maximum(th, zero) * gcn._rows(feats[..., cols],
                                                   idx[..., kk])
            m = v if m is None else torch.maximum(m, v)
        staged[..., cols] = m
    acc = staged[..., :o].float()
    for j in range(1, s):
        acc = (acc + staged[..., j * o:(j + 1) * o].float()).to(dt).float()
    return acc


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,s,o", [(3, 3, 16), (9, 2, 20), (3, 5, 3)])
def test_kernel5_order_is_bit_exact(d, s, o, dt):
    """O = 20 and 3: a chunk of columns spans two supports; S*O = 15, not
    a multiple of the chunk: a short last chunk."""
    for nd, dirs, feats, idx, _ in (_case(90 + d + o, d=d, s=s, o=o),
                                    _poisoned(91 + d + o, d=d, s=s, o=o)):
        tnd, tdirs, tf, tidx = _t(nd, dirs, feats, idx)
        tf = tf.to(dt)
        torch.testing.assert_close(_kernel5_order(tnd, tdirs, tf, tidx, s),
                                   gcn.aggregate_plain(tnd, tdirs, tf, tidx,
                                                       s),
                                   rtol=0, atol=0, equal_nan=True)
