"""The Ranger kernel (csrc/ranger.cu through ops/optim.py:ranger_apply) on
a card, against its plain version, the train step's leaf path (the guard,
Ranger.update and the add, leaf by leaf, run on the card).

Every test here needs a CUDA card and skips without one. The file imports
no JAX; on the machine with the card:

  python -m pytest --noconftest -p no:cacheprovider -m gpu \\
      tests/test_torch_ranger_gpu.py -q

The kernel's only departure from the plain chain is the order in which it
sums the two reductions (the global norm, centralisation's group means):
on numpy-made gradients over 8 steps (RAdam's threshold, a Lookahead
sync, two clipped steps, a NaN gradient, a non-finite loss) the
parameters, mu, nu and slow are held within 1e-6 of their largest
magnitude in the model and the norm within 1e-6; where those sums are
exact (gradients of a few bits, no clip) every bit agrees.
"""

import numpy as np
import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import optim as ops_optim
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.transparent_trainer import build_model

pytestmark = pytest.mark.gpu

TINY_KRRN = schema.override(schema.Config(), **{
    "module.num_cls": 2, "data.num_regions": 8, "data.num_points": 128,
    "data.input_size": 64, "module.backbone_outc": 16,
    "module.stem_width": 8,
    "module.hrnet_stages": ((1, 1, (8, 8)), (1, 1, (8, 8, 16)),
                            (1, 1, (8, 8, 16, 16))),
    "module.xyznet": schema.HeadConfig(hidden=16),
    "module.nmlnet": schema.HeadConfig(hidden=16),
    "module.gcn3d": schema.Gcn3dConfig(neighbor_num=4, support_num=2),
    "train.amp": False})
TOL = 1e-6
CLIP = 10.0
# per step (count after it): the gradients' global norm, a NaN leaf, the
# loss; steps 3 and 6 clipped, step 6 the first rectified and a sync
STEPS = ((3.0, False, 1.0), (5.0, False, 1.0), (25.0, False, 1.0),
         (4.0, True, 1.0), (4.0, False, float("inf")), (40.0, False, 1.0),
         (2.0, False, 1.0), (7.0, False, 1.0))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def model_leaves(which: str) -> dict:
    """{name: shape} of a model's parameters (built on the meta device)."""
    if which in ("krrn_tiny", "krrn"):
        with torch.device("meta"):
            model = KRRN(TINY_KRRN if which == "krrn_tiny" else
                         schema.Config())
    else:
        cfg = schema.transparent_cleargrasp()
        if which == "pspnet":
            cfg = schema.override(cfg, **{
                "module.transparent_model": "posenet"})
        model = build_model(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _numpy(shapes: dict, seed: int, dev, scale=1.0, channels_last=False,
           bits=None) -> dict:
    """Tensors on `dev` from numpy's generator: normal, or with `bits`
    integers in +-2^bits times 2^-16; 4-D ones channels-last if asked (as
    cuDNN's weight gradients come)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        n = int(np.prod(s))
        if bits is None:
            a = rng.standard_normal(n, dtype=np.float32) * np.float32(scale)
        else:
            a = (rng.integers(-2 ** bits, 2 ** bits + 1, n)
                 * 2.0 ** -16).astype(np.float32)
        t = torch.from_numpy(a.reshape(s)).to(dev)
        if channels_last and len(s) == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        out[k] = t
    return out


def _state(shapes: dict, dev, tx) -> tuple:
    params = _numpy(shapes, 0, dev, 0.05)
    return params, tx.init(params)


def _copy(params: dict, state: dict) -> tuple:
    return ({k: v.clone() for k, v in params.items()},
            {"count": state["count"],
             **{s: {k: v.clone() for k, v in state[s].items()}
                for s in ("mu", "nu", "slow")}})


def _gaps(got: tuple, ref: tuple) -> dict:
    """{state: (max |got - ref| over every leaf / the largest |ref| of any
    leaf, the leaf of that largest difference)} for the parameters, mu,
    nu and slow: a leaf of one value whose state cancels leaves only its
    own rounding, a fault in any leaf a gap of its own size."""
    out = {}
    for s, a, b in zip(("params", "mu", "nu", "slow"), got, ref):
        diff = {k: float((a[k] - b[k]).abs().max()) for k in b}
        top = max(float(v.abs().max()) for v in b.values())
        worst = max(diff, key=diff.get)
        out[s] = (diff[worst] / top, worst)
    return out


def _all(params: dict, state: dict) -> tuple:
    return (params, state["mu"], state["nu"], state["slow"])


def _leaf_path(tx, params: dict, grads: dict, state: dict, loss,
               lr_scale: float) -> tuple:
    """The step's leaf path on the same tensors (what Optimizer.apply
    runs through TrainState.apply_gradients): the guard, Ranger.update and
    the add; state replaced in place; (gnorm, finite)."""
    grads, gnorm, finite = optim.nan_guard(grads, loss)
    updates, new = tx.update(grads, state, params, lr_scale)
    for k, p in params.items():
        p.add_(updates[k])
    state.update(new)
    return gnorm, finite


def _grads(shapes: dict, step: int, dev, norm: float, nan: bool) -> dict:
    grads = _numpy(shapes, 100 + step, dev, channels_last=True)
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in grads.values())))
    for g in grads.values():
        g.mul_(norm / total)
    if nan:
        g = grads[sorted(shapes)[len(shapes) // 2]]
        g[(0,) * g.ndim] = float("nan")
    return grads


@pytest.mark.parametrize("which", ("trpesnet", "pspnet", "krrn_tiny"))
def test_kernel_follows_the_plain_chain_for_8_steps(dev, which):
    shapes = model_leaves(which)
    tx = optim.Ranger(optim.flat_and_anneal_schedule(3e-4, 100, 0),
                      grad_clip=CLIP)
    params, state = _state(shapes, dev, tx)
    ref_params, ref_state = _copy(params, state)
    for i, (norm, nan, total) in enumerate(STEPS):
        grads = _grads(shapes, i, dev, norm, nan)
        loss = torch.tensor(total, device=dev)
        args = tx.step_args(state["count"], 1.0)
        assert args["sync"] == (i == 5) and (args["r"] is None) == (i < 5)
        gnorm, finite = ops_optim.ranger_apply(params, grads, state, loss,
                                               **args)
        ref_gnorm, ref_finite = _leaf_path(tx, ref_params, grads,
                                           ref_state, loss, 1.0)
        assert bool(finite) == bool(ref_finite) == (not nan and total == 1)
        if nan:
            assert gnorm.isnan() and ref_gnorm.isnan()
        else:
            assert float(gnorm) == pytest.approx(float(ref_gnorm), rel=TOL)
            assert (float(ref_gnorm) > CLIP) == (i in (2, 5))
        assert state["count"] == ref_state["count"] == i + 1
        gaps = _gaps(_all(params, state), _all(ref_params, ref_state))
        assert all(v <= TOL for v, _ in gaps.values()), (i, gaps)


@pytest.mark.parametrize("which", ("trpesnet", "krrn_tiny"))
def test_kernel_arithmetic_is_the_chain_s_bit_for_bit(dev, which):
    """Gradients of a few bits sum exactly in any order: the group means
    are then the plain chain's, and every parameter, moment and slow
    weight equals it bit for bit through RAdam's threshold and a sync."""
    shapes = model_leaves(which)
    tx = optim.Ranger(optim.flat_and_anneal_schedule(3e-4, 100, 0),
                      weight_decay=1e-4, grad_clip=CLIP)
    params, state = _state(shapes, dev, tx)
    ref_params, ref_state = _copy(params, state)
    for i in range(7):
        grads = _numpy(shapes, 200 + i, dev, channels_last=True, bits=3)
        loss = torch.tensor(1.0, device=dev)
        args = tx.step_args(state["count"], 0.75)
        gnorm, _ = ops_optim.ranger_apply(params, grads, state, loss, **args)
        ref_gnorm, _ = _leaf_path(tx, ref_params, grads, ref_state, loss,
                                  0.75)
        assert float(gnorm) < CLIP
        assert float(gnorm) == pytest.approx(float(ref_gnorm), rel=TOL)
        for k in shapes:
            assert torch.equal(params[k], ref_params[k]), (i, k)
            for s in ("mu", "nu", "slow"):
                assert torch.equal(state[s][k], ref_state[s][k]), (i, s, k)


def test_the_same_step_twice_gives_the_same_bits(dev):
    shapes = model_leaves("pspnet")
    tx = optim.Ranger(lambda c: 3e-4, grad_clip=CLIP)
    params, state = _state(shapes, dev, tx)
    state["count"] = 5                      # rectified, a sync
    twin = _copy(params, state)
    grads = _grads(shapes, 0, dev, 30.0, False)
    loss = torch.tensor(1.0, device=dev)
    args = tx.step_args(5)
    a = ops_optim.ranger_apply(params, grads, state, loss, **args)
    b = ops_optim.ranger_apply(twin[0], {k: g.clone() for k, g in
                                         grads.items()}, twin[1], loss,
                               **args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for k in shapes:
        assert torch.equal(params[k], twin[0][k])
        for s in ("mu", "nu", "slow"):
            assert torch.equal(state[s][k], twin[1][s][k])


def _device_ops(fn) -> int:
    """Kernels and copies on the card while fn() runs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


@pytest.mark.parametrize("n_leaves", (3, 863))
def test_launches_a_step_do_not_grow_with_the_leaves(dev, n_leaves):
    """One call: the pointer table's copy and three kernels, for 3 leaves
    and for KRRN's 863, with no host sync."""
    shapes = model_leaves("krrn")
    assert len(shapes) == 863
    shapes = dict(list(shapes.items())[:n_leaves])
    tx = optim.Ranger(lambda c: 3e-4, grad_clip=CLIP)
    params, state = _state(shapes, dev, tx)
    grads = _numpy(shapes, 1, dev, 1e-3, channels_last=True)
    loss = torch.tensor(1.0, device=dev)
    ops_optim.ranger_apply(params, grads, state, loss,
                           **tx.step_args(state["count"]))   # builds the plan
    before = ops_optim.ranger_apply.launches

    def step():                          # a host sync raises
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops_optim.ranger_apply(params, grads, state, loss,
                                   **tx.step_args(state["count"]))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    ops = _device_ops(step)
    assert ops_optim.ranger_apply.launches - before == ops_optim.LAUNCHES
    assert ops == ops_optim.LAUNCHES, ops


def test_wrapper_rejects_what_the_kernel_does_not_take_on_the_card(dev):
    """A bf16 or non-contiguous parameter, a bf16 gradient raise before
    any launch."""
    shapes = {"Conv_0.weight": (4, 2, 3, 3), "Dense_0.weight": (3, 5)}
    tx = optim.Ranger(lambda c: 3e-4, grad_clip=CLIP)
    loss = torch.tensor(1.0, device=dev)
    for what in ("bf16 parameter", "transposed parameter", "bf16 gradient"):
        params, state = _state(shapes, dev, tx)
        grads = _numpy(shapes, 1, dev)
        if what == "bf16 parameter":
            params["Dense_0.weight"] = params["Dense_0.weight"].bfloat16()
        elif what == "transposed parameter":
            params["Dense_0.weight"] = (params["Dense_0.weight"].t()
                                        .contiguous().t())
        else:
            grads["Dense_0.weight"] = grads["Dense_0.weight"].bfloat16()
        before = ops_optim.ranger_apply.launches
        with pytest.raises(ValueError):
            ops_optim.ranger_apply(params, grads, state, loss,
                                   **tx.step_args(0))
        assert ops_optim.ranger_apply.launches == before, what
