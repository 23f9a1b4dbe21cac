"""What both cells read, pinned bit for bit to the values that the
harness gave before its models, drivers and ops were found by name: the
reference models' leaves, the FLOPs of a step at the full
configurations, the tiny cells' seeded weights and pools, and the
numbers a tiny run compares."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from portbench import check, found
from portbench.flops import step_flops
from portbench.gen.pool import make_pool
from portbench.reference.layers import Precision
from portbench.run import load_cell
from portbench.tests.tiny import tiny_cell
from portbench.weights import make_weights, reference_model

SEED = 2 ** 33 + 12345
STEPS = 2                   # window steps of the pinned tiny runs

# (leaves, sha256 of the JSON list of [name, shape]) of the reference
# model at the full configuration, in the order the weights are drawn
LEAVES = {
    "krrn.serve_bs256": (863, "ef8e56ccbddcb2c7378668487d67afb31b448c0a"
                              "ba80814c6e7c11a079537e1f"),
    "trpesnet.train_bs8": (144, "da49a9d799e0694a1310629034a29b00b95c3e87"
                                "abe79d165f3631302863b0de"),
}
# step_flops on the meta device at the full configuration: a forward on
# a batch of the cell's own mix, a training step on a batch of 8
FLOPS = {
    "krrn.serve_bs256": (16158908481536.0, 1513793591616.0),
    "trpesnet.train_bs8": (1349349670912.0, 4046382369408.0),
}
# sha256 of the tiny cell's weights, then of each batch of its pool
DRAWS = {
    "krrn.serve_bs256": (
        "4cb3eab8c411249a4224d7ef1e76f6c6fe5340b6ffacb93fd54238ab8f889b47",
        "93a26ee5e03f2fa6c184cb74dc424fcbd0edd243f17987f29d3239bb39ea1df3",
        "b9cc856c24b29e6f380480cb316986599413f6251ed5f17a611085f0c9b2f5cb"),
    "trpesnet.train_bs8": (
        "7ede9d905a8ebe57a43837ba931b044813de0227214d1fe15163036fde012e46",
        "6fa103c9a38ca0b6c99b8ffcf2cea7d0ebec6db8ac67f7ccdac0e6ac34ba44f5",
        "5def6dfebe72c72bd3243cc7f01597aa6570b7b8c21eaf5a04560ae35f7c24ce",
        "07e220895f8316bc55c4cc95f84e1685b1a6b4e5ce17cf5bf37cb2b65fc28d94"),
}
# the numbers of a tiny run of STEPS window steps on the CPU
CHECKS = {
    "krrn.serve_bs256": {
        "xyz_gap": 0.05683115869760513, "rot_gap_deg": 0.0,
        "pnp_t_gap_mm": 0.0, "pred_t_gap_mm": 16.328580856323242},
    "trpesnet.train_bs8": {
        "loss_gap": 0.0005065906233935348,
        "grad_gap_worst": 0.03356337800277409,
        "grad_gap_median": 0.0016491901302629133,
        "update_gap_worst": 0.3676567363843483,
        "update_gap_median": 0.08296591970065256,
        "_grad_norms": [[46.96985626220703, 102.35443878173828,
                         53.58100509643555],
                        [47.11920166015625, 56.810150146484375,
                         53.6458740234375]]},
}
CELLS = tuple(LEAVES)


def _sha(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        v = tensors[k].contiguous()
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.numpy().tobytes() if v.dtype == torch.bool
                 else v.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload", CELLS)
def test_reference_leaves(workload):
    cfg_file = load_cell(workload)[2]
    with torch.device("meta"):
        ref = reference_model(cfg_file, Precision("fp32"))
    leaves = [(n, list(p.shape)) for n, p in ref.named_parameters()]
    got = (len(leaves),
           hashlib.sha256(json.dumps(leaves).encode()).hexdigest())
    assert got == LEAVES[workload]


@pytest.mark.parametrize("workload", CELLS)
def test_step_flops(workload):
    _, _, cfg_file, mix = load_cell(workload)
    own = make_pool(cfg_file, dict(mix, pool_batches=1), SEED)[0]
    train = make_pool(cfg_file, dict(mix, pool_batches=1, batch_size=8,
                                     driver="train"), SEED)[0]
    got = (step_flops(cfg_file, own, False),
           step_flops(cfg_file, train, True))
    assert got == FLOPS[workload]


@pytest.mark.parametrize("workload", CELLS)
def test_weights_and_pool(workload):
    _, _, cfg_file, mix = tiny_cell(workload)
    got = ((_sha(make_weights(cfg_file, SEED, torch.device("cpu"))),)
           + tuple(_sha(b) for b in make_pool(cfg_file, mix, SEED)))
    assert got == DRAWS[workload]


@pytest.mark.parametrize("workload", CELLS)
def test_checked_numbers(workload):
    _, _, cfg_file, mix = tiny_cell(workload)
    d = found.driver(mix["driver"])(cfg_file, mix, SEED, torch.device("cpu"))
    for i in range(STEPS):
        d.step(i)
    d.release(STEPS)
    nums = d.check(check.load_limits(workload))
    got = {k: v for k, v in nums.items()
           if not k.startswith("_") or k == "_grad_norms"}
    assert got == CHECKS[workload]


def test_a_family_names_its_norm_leaves(monkeypatch):
    """A leaf that the reference half's leaf_kinds names "norm" is drawn
    as a normalisation leaf; every other leaf stays as it was."""
    _, _, cfg_file, _ = tiny_cell("trpesnet.train_bs8")
    cpu = torch.device("cpu")
    plain = make_weights(cfg_file, SEED, cpu)
    leaf = next(k for k in plain if k.endswith("weight"))
    monkeypatch.setattr(found.family("trpesnet", "reference"), "leaf_kinds",
                        lambda model: {leaf: "norm"}, raising=False)
    named = make_weights(cfg_file, SEED, cpu)
    assert torch.equal(named[leaf], torch.ones_like(plain[leaf]))
    assert all(torch.equal(named[k], v) for k, v in plain.items()
               if k != leaf)
