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
      path at 1e-5; idx gets no gradient.
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
