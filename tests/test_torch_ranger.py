"""The train step's guarded Ranger update (train/optim.py: Ranger.apply,
on the card one call of ops/optim.py:ranger_apply, the CUDA kernel
csrc/ranger.cu) on the CPU: the leaf path against the guard, Ranger.update
and the add as the step ran them before the kernel, bit for bit; the train
step and state around it; ops/ importing nothing of train/; the kernel's
plan (every gradient element read once, in its group; every parameter
written once)
with the kernel's reductions done by the plan in numpy; the entry's ctypes
signature against the wrapper's arguments and its launches, the same for 3
leaves and 863. The kernel itself runs in tests/test_torch_ranger_gpu.py.
"""

import ast
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.convert import flax_axis0_dim
from pose_estimation_tpu_torch.models.krrn import KRRN
from pose_estimation_tpu_torch.ops import _build
from pose_estimation_tpu_torch.ops import optim as ops_optim
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.state import TrainState
from pose_estimation_tpu_torch.train.transparent_trainer import build_model

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

# a small leaf set of every kind: conv kernels (3 x 3, 1 x 1, 7 x 7), a
# transposed conv, Dense kernels narrower and wider than a tile, kernels
# grouped along dim 0 in one row, biases, a scalar
SMALL = {"Conv_0.weight": (8, 3, 3, 3), "Conv_1.weight": (16, 8, 1, 1),
         "Conv_2.weight": (4, 2, 7, 7), "ConvTranspose_0.weight": (6, 5, 2, 2),
         "Dense_0.weight": (7, 33), "Dense_1.weight": (3, 300),
         "Attention_0.kernel": (3, 40), "Attention_1.kernel": (5, 2, 9),
         "Conv_0.bias": (8,), "Norm_0.scale": (21,), "prelu_alpha": ()}


def model_leaves(which: str) -> dict:
    """{name: shape} of a model's parameters (built on the meta device)."""
    if which == "small":
        return dict(SMALL)
    if which == "krrn_tiny":
        with torch.device("meta"):
            model = KRRN(TINY_KRRN)
    else:
        cfg = schema.transparent_cleargrasp()
        if which == "pspnet":
            cfg = schema.override(cfg, **{
                "module.transparent_model": "posenet"})
        model = build_model(cfg, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _grad_layout(shape, channels_last: bool):
    return (torch.channels_last if channels_last and len(shape) == 4
            else torch.contiguous_format)


def _seed_update(tx, grads, state, params, lr_scale):
    """Ranger.update as the step ran it before the one-call path: the
    clip, then leaf by leaf centralisation, RAdam, decay, the learning
    rate and Lookahead."""
    grads = optim.clip_by_global_norm(grads, tx.grad_clip)
    count = state["count"] + 1
    c1, c2, r = tx._radam_scalars(count)
    step_size = -tx.schedule(state["count"])
    sync = count % tx.sync_period == 0
    mu, nu, slow, updates = {}, {}, {}, {}
    for k, p in params.items():
        v = optim.centralise(k, grads[k])
        mu[k] = (1 - tx.b1) * v + tx.b1 * state["mu"][k]
        nu[k] = (1 - tx.b2) * (v * v) + tx.b2 * state["nu"][k]
        u = mu[k] / c1
        if r is not None:
            u = r * u / (torch.sqrt(nu[k] / c2) + tx.eps)
        if tx.weight_decay:
            u = u + tx.weight_decay * p
        u = (step_size * u) * lr_scale
        s = state["slow"][k]
        if sync:
            synced = s + tx.alpha * ((p + u) - s)
            updates[k], slow[k] = synced - p, synced
        else:
            updates[k], slow[k] = u, s
    return updates, {"count": count, "mu": mu, "nu": nu, "slow": slow}


def _seed_step(tx, params, grads, opt_state, loss, lr_scale):
    """The guard (train_step.py before the one-call path), _seed_update
    and the add."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    finite = torch.isfinite(loss) & torch.isfinite(gnorm)
    grads = {k: torch.where(finite, g, torch.zeros_like(g))
             for k, g in grads.items()}
    updates, new = _seed_update(tx, grads, opt_state, params, lr_scale)
    for k, p in params.items():
        p.add_(updates[k])
    return new, gnorm, finite


class _Leaves:
    """A model whose parameters are the tensors of `params` (for
    TrainState)."""

    def __init__(self, params: dict):
        self.leaves = params

    def named_parameters(self):
        return iter(self.leaves.items())


def _tensors(shapes: dict, seed: int, scale: float = 1.0,
             channels_last: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(np.asarray(rng.randn(*s) * scale,
                                           dtype=np.float32))
            .contiguous(memory_format=_grad_layout(s, channels_last))
            for k, s in shapes.items()}


CASES = {   # name: (state count, gradient scale, NaN leaf, loss)
    "first step": (0, 0.1, None, 1.0),
    "clipped": (3, 3.0, None, 1.0),
    "rectified, sync": (5, 0.2, None, 1.0),
    "nan gradient": (2, 0.1, "Dense_0.weight", 1.0),
    "non-finite loss": (6, 0.1, None, float("inf")),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weight_decay", (0.0, 1e-3))
def test_plain_path_is_the_seed_step_bit_for_bit(case, weight_decay):
    count, scale, nan_leaf, loss = CASES[case]
    tx = optim.Ranger(optim.flat_and_anneal_schedule(3e-4, 100, 10),
                      weight_decay=weight_decay, grad_clip=10.0)
    params = _tensors(SMALL, 0)
    state = tx.init(params)
    state["count"] = count
    state["mu"] = _tensors(SMALL, 1, 0.01)
    state["nu"] = {k: v.abs() for k, v in _tensors(SMALL, 2, 1e-3).items()}
    state["slow"] = _tensors(SMALL, 3)
    grads = _tensors(SMALL, 4, scale, channels_last=True)
    if nan_leaf:
        grads[nan_leaf][0, 1] = float("nan")
    loss = torch.tensor(loss)
    ref_p = {k: v.clone() for k, v in params.items()}
    ref_state, ref_gnorm, ref_finite = _seed_step(
        tx, ref_p, grads, state, loss, lr_scale=0.5)
    got = TrainState(_Leaves(params), dict(state), torch.Generator(),
                     lr_scale=0.5)
    gnorm, finite = tx.apply(got, grads, loss)
    got_state = got.opt_state
    assert torch.equal(gnorm, ref_gnorm) or (
        gnorm.isnan() and ref_gnorm.isnan())
    assert bool(finite) == bool(ref_finite) == (case not in (
        "nan gradient", "non-finite loss"))
    if case == "clipped":
        assert float(ref_gnorm) > 10.0
    assert got_state["count"] == ref_state["count"] == count + 1
    assert got.step == 1
    for k in SMALL:
        assert torch.equal(params[k], ref_p[k]), k
        for s in ("mu", "nu", "slow"):
            assert torch.equal(got_state[s][k], ref_state[s][k]), (s, k)


def test_step_args_give_update_s_scalars():
    """Ranger.update is ranger_chain with step_args: RAdam's rectifier
    from step 6 on (rho 5.97 against the threshold 5; 4.96 at step 5),
    Lookahead every 6th step, the schedule at the count before the
    step."""
    tx = optim.Ranger(lambda c: 1e-3 * (c + 1), grad_clip=10.0)
    rs = [tx.step_args(c)["r"] for c in range(8)]
    assert [r is None for r in rs] == [True] * 5 + [False] * 3
    args = [tx.step_args(c, 0.25) for c in range(13)]
    assert [a["sync"] for a in args].count(True) == 2
    assert args[5]["sync"] and args[11]["sync"]
    assert args[3]["step_size"] == -4e-3 and args[3]["lr_scale"] == 0.25
    assert args[3]["count"] == 4


@pytest.mark.parametrize("kind", (optim.Ranger, optim.Adam))
def test_train_step_on_the_cpu_goes_through_apply_gradients(monkeypatch,
                                                            kind):
    """On the CPU the step runs the guard and apply_gradients, with
    either optimizer (the benchmark's fault checks replace that method
    to leave the state unchanged)."""
    from pose_estimation_tpu_torch.train.train_step import TrainStep
    calls = []
    seen = TrainState.apply_gradients

    def spy(self, tx, grads):
        calls.append(len(grads))
        return seen(self, tx, grads)
    monkeypatch.setattr(TrainState, "apply_gradients", spy)
    model = torch.nn.Linear(3, 2)
    tx = kind(lambda c: 1e-2, grad_clip=1.0)
    state = TrainState.create(model, tx, torch.Generator())
    step = TrainStep.__new__(TrainStep)
    step.tx, step.total = tx, "loss"
    loss = model(torch.ones(1, 3)).sum()
    grads = dict(zip(["weight", "bias"],
                     torch.autograd.grad(loss, list(model.parameters()))))
    m = step.apply(state, {"loss": loss}, grads)
    assert calls == [2] and float(m["skipped_nonfinite"]) == 0.0
    assert state.step == state.opt_state["count"] == 1


def test_ops_import_nothing_of_train():
    """The kernels' layer sits below the train layer: no module under
    ops/ imports pose_estimation_tpu_torch.train (Ranger's constants
    reach ops.optim.ranger_apply as keywords)."""
    package = ["pose_estimation_tpu_torch", "ops"]
    train = "pose_estimation_tpu_torch.train"
    for path in sorted(Path(ops_optim.__file__).parent.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # a relative import counts up from ops/
                parts = package[:len(package) + 1 - node.level] \
                    if node.level else []
                base = ".".join(parts + [node.module] if node.module
                                else parts)
                names = [base] + [f"{base}.{a.name}" for a in node.names]
            else:
                continue
            assert not any(n == train or n.startswith(train + ".")
                           for n in names), (path.name, node.lineno)


def test_load_state_dict_copies_the_optimizer_state():
    """The loaded optimizer state shares no memory with the state dict
    (the card's update writes it in place), and is contiguous."""
    model = torch.nn.Conv2d(2, 3, 3)
    tx = optim.Ranger(lambda c: 1e-2)
    a = TrainState.create(model, tx, torch.Generator())
    sd = a.state_dict()
    sd["opt_state"]["mu"]["weight"] = torch.ones(3, 2, 3, 3).contiguous(
        memory_format=torch.channels_last)
    b = TrainState.create(torch.nn.Conv2d(2, 3, 3), tx, torch.Generator())
    b.load_state_dict(sd)
    for s in ("mu", "nu", "slow"):
        for k, v in b.opt_state[s].items():
            assert v.is_contiguous()
            assert v.data_ptr() != sd["opt_state"][s][k].data_ptr()
    assert torch.equal(b.opt_state["mu"]["weight"], torch.ones(3, 2, 3, 3))


# ---------------------------------------------------------------------------
# the kernel's plan
# ---------------------------------------------------------------------------

def _leaves(shapes: dict, channels_last: bool) -> list:
    out = []
    for k, s in shapes.items():
        p = torch.empty(s, device="meta")
        g = torch.empty(s, device="meta").contiguous(
            memory_format=_grad_layout(s, channels_last))
        out.append(ops_optim.leaf_of(k, p, g))
    return out


def _task_elements(task):
    """(memory offsets from the leaf's start, each one's slot or -1) of
    a reduction task, as rg_reduce reads them (thread (r % lanes) * cols
    + c takes row r, column c)."""
    (_, e0, row, cols, rows, n, c0, gdiv, _, slot, ngroups, _) = (
        int(v) for v in task)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    off = (r * row + c).ravel()
    keep = off < n
    if ngroups == 0:
        slots = np.full(off.shape, -1)
    elif ngroups == 1:
        slots = np.full(off.shape, slot)
    else:
        slots = (slot + (c0 + c) // gdiv - c0 // gdiv).ravel()
    return e0 + off[keep], slots[keep]


@pytest.mark.parametrize("which", ("small", "trpesnet", "pspnet",
                                   "krrn_tiny"))
@pytest.mark.parametrize("channels_last", (False, True))
def test_plan_reads_every_gradient_element_once_in_its_group(which,
                                                             channels_last):
    """Every element of every leaf's gradient is read by one reduction
    task, into the slot of its group ((m // stride) % size in memory
    order m: the index along flax's axis 0); each group's slots (csr)
    are the slots of its elements; update chunks write each parameter
    element once; the groups' factors are 1 / size in float32."""
    shapes = model_leaves(which)
    leaves = _leaves(shapes, channels_last)
    plan = ops_optim.make_plan(leaves)
    assert plan.leaves.shape == (len(leaves), ops_optim.LEAF_INTS)
    slot_group = np.full(len(plan.slots), -1)
    by_leaf = {}
    for task in plan.tasks:
        by_leaf.setdefault(int(task[0]), []).append(task)
    gbase = 0
    for li, ((name, shape), lf) in enumerate(zip(shapes.items(), leaves)):
        offs, slots = zip(*(_task_elements(t) for t in by_leaf[li]))
        offs, slots = np.concatenate(offs), np.concatenate(slots)
        assert np.array_equal(np.sort(offs), np.arange(lf.numel)), name
        if len(shape) <= 1:
            assert lf.groups == 0 and (slots == -1).all(), name
        else:
            keep = flax_axis0_dim(name)
            assert lf.groups == shape[keep]
            # the index along `keep` at each memory offset of the gradient
            along = torch.arange(shape[keep]).reshape(
                [-1 if d == keep else 1 for d in range(len(shape))])
            along = along.expand(shape).contiguous(
                memory_format=_grad_layout(shape, channels_last))
            want = gbase + torch.as_strided(along, (lf.numel,), (1,)).numpy()
            assert (slots >= 0).all(), name
            prev = slot_group[slots]
            assert ((prev == -1) | (prev == want[offs])).all(), name
            slot_group[slots] = want[offs]
        gbase += lf.groups
        rows = plan.chunks[plan.chunks[:, 0] == li]
        covered = np.concatenate([np.arange(s, s + n) for _, s, n, _ in rows])
        assert np.array_equal(covered, np.arange(lf.numel)), name
        assert (rows[:, 1] % 4 == 0).all()
    assert gbase == len(plan.factor) == len(plan.csr) - 1
    assert (slot_group >= 0).all()
    for gi in range(gbase):
        mine = plan.slots[plan.csr[gi]:plan.csr[gi + 1]]
        assert np.array_equal(np.sort(mine), np.flatnonzero(slot_group == gi))
    want = [np.float32(lf.groups) / np.float32(lf.numel)
            for lf in leaves for _ in range(lf.groups)]
    assert np.array_equal(plan.factor, np.asarray(want, np.float32))


def _emulate(plan, grads: list):
    """The kernel's two reductions and its mean lookup, done by the plan
    in float64: (norm, {leaf: group mean of each parameter element})."""
    mem = [torch.as_strided(g, (g.numel(),), (1,)).double().numpy()
           for g in grads]
    part, sq = np.zeros(len(plan.slots)), 0.0
    for task in plan.tasks:
        offs, slots = _task_elements(task)
        x = mem[int(task[0])][offs]
        sq += (x * x).sum()
        np.add.at(part, slots[slots >= 0], x[slots >= 0])
    gsum = np.array([part[plan.slots[a:b]].sum()
                     for a, b in zip(plan.csr[:-1], plan.csr[1:])])
    means = {}
    for li, (numel, groups, inner, gbase, *_) in enumerate(plan.leaves):
        if groups:
            e = np.arange(numel)
            means[li] = (gsum * plan.factor)[gbase + (e // inner) % groups]
    return np.sqrt(sq), means


@pytest.mark.parametrize("which", ("small", "krrn_tiny"))
@pytest.mark.parametrize("channels_last", (False, True))
def test_plan_sums_give_the_norm_and_the_group_means(which, channels_last):
    """The plan's partial sums, added by group, are the global norm and
    centralisation's means (train.optim.centralise's, in the parameter's
    order) of gradients in either layout."""
    shapes = model_leaves(which)
    grads = _tensors(shapes, 7, channels_last=channels_last)
    leaves = [ops_optim.leaf_of(k, g.new_empty(g.shape), g)
              for k, g in grads.items()]
    norm, means = _emulate(ops_optim.make_plan(leaves), list(grads.values()))
    want = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    assert norm == pytest.approx(float(want), rel=1e-12)
    for li, (k, g) in enumerate(grads.items()):
        if g.ndim <= 1:
            assert li not in means
            continue
        mean = (g.double() - optim.centralise(k, g.double())).contiguous()
        np.testing.assert_allclose(means[li], mean.flatten().numpy(),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# the entry's arguments and launches
# ---------------------------------------------------------------------------

def _fake_entry(monkeypatch):
    seen = []

    class Lib:
        pose_ranger_apply = "entry"

    def launch(fn, dev, *args):
        seen.append((fn, args))
        return 0

    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(ops_optim, "_upload",
                        lambda a, dev: torch.from_numpy(a))
    monkeypatch.setattr(ops_optim, "_plans", {})
    monkeypatch.setattr(ops_optim.ranger_apply, "launches", 0)
    return seen


@pytest.mark.parametrize("n_leaves", (3, 863))
def test_entry_arguments_and_launches_the_same_for_any_leaf_count(
        monkeypatch, n_leaves):
    """_launch's arguments against pose_ranger_apply's ctypes types (a
    pointer for each buffer and the stream, ints for the counts and
    flags, floats for the scalars, which are the chain's float32 values:
    1 - b, the bias corrections' reciprocals); one entry call (its three
    kernels) and one table a step whatever the leaf count; count set."""
    seen = _fake_entry(monkeypatch)
    shapes = {f"Conv_{i}.weight" if i % 3 else f"Dense_{i}.bias":
              (4, 2, 3, 3) if i % 3 else (5,) for i in range(n_leaves)}
    params = _tensors(shapes, 0)
    grads = _tensors(shapes, 1, channels_last=True)
    tx = optim.Ranger(lambda c: 3e-4, grad_clip=10.0, weight_decay=1e-4)
    state = tx.init(params)
    for step in range(2):
        args = tx.step_args(state["count"], 0.5)
        ops_optim._launch(params, grads, state, torch.tensor(1.0), **args)
        assert state["count"] == step + 1
    assert ops_optim.ranger_apply.launches == 2 * ops_optim.LAUNCHES
    assert len(seen) == 2 and seen[0][0] == "entry"
    sig = _build._SIGNATURES["pose_ranger_apply"]
    args = seen[1][1]
    assert len(sig) == len(args) + 1 and sig[-1] is ctypes.c_void_p
    for t, a in zip(sig, args):
        if t is ctypes.c_float:
            assert isinstance(a, float) and a == float(np.float32(a)), a
        else:
            assert isinstance(a, int) and 0 <= a < 2 ** 63, (t, a)
    assert args[7] == n_leaves
    (clip, use_clip, wd, b1, s1, b2, s2, ic1, ic2, r, use_r, eps, ss, lrs,
     sync, alpha) = args[12:]
    f = np.float32
    c1, c2, _ = tx._radam_scalars(2)
    assert (clip, use_clip, wd, use_r, sync) == (10.0, 1, f(1e-4), 0, 0)
    assert (b1, s1, b2, s2, eps, alpha) == (
        f(0.95), f(1 - 0.95), f(0.999), f(1 - 0.999), f(1e-5), 0.5)
    assert ic1 == f(1) / f(c1) and ic2 == f(1) / f(c2)
    assert (ss, lrs) == (f(-3e-4), 0.5) and r == 0.0


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """A bf16 leaf, a non-contiguous parameter or state, a gradient of
    another shape raise before any launch; a gradient in another layout
    than contiguous or channels-last is copied to a contiguous one."""
    seen = _fake_entry(monkeypatch)
    shapes = {"Conv_0.weight": (4, 2, 3, 3), "Dense_0.weight": (3, 5)}
    tx = optim.Ranger(lambda c: 3e-4, grad_clip=10.0)

    def call(edit):
        params, grads = _tensors(shapes, 0), _tensors(shapes, 1)
        state = tx.init(params)
        edit(params, grads, state)
        return ops_optim._launch(params, grads, state, torch.tensor(1.0),
                                 **tx.step_args(0))

    bad = {
        "bf16 parameter": lambda p, g, s: p.update(
            {"Dense_0.weight": p["Dense_0.weight"].bfloat16()}),
        "bf16 gradient": lambda p, g, s: g.update(
            {"Dense_0.weight": g["Dense_0.weight"].bfloat16()}),
        "transposed parameter": lambda p, g, s: p.update(
            {"Dense_0.weight": p["Dense_0.weight"].t().contiguous().t()}),
        "channels-last mu": lambda p, g, s: s["mu"].update(
            {"Conv_0.weight": s["mu"]["Conv_0.weight"].contiguous(
                memory_format=torch.channels_last)}),
        "gradient shape": lambda p, g, s: g.update(
            {"Dense_0.weight": g["Dense_0.weight"][:2]}),
    }
    for what, edit in bad.items():
        with pytest.raises(ValueError):
            call(edit)
        assert not seen, what
    call(lambda p, g, s: g.update(
        {"Dense_0.weight": g["Dense_0.weight"].t().contiguous().t()}))
    assert len(seen) == 1
