"""The transparent options the shipped config leaves off, and decode,
against the JAX package on the CPU, on the same numpy inputs and converted
parameters:

  EqualizedDense and EqualizedConv: 1e-5 x max(1, max|ref|);
  TransformerEncoderBlock (flax's MultiHeadDotProductAttention: q scaled
      before q.k, the softmax in the compute dtype, LayerNorm eps 1e-6):
      1e-5 in fp32, 2e-2 in bf16 (an ulp of bf16 is 7.8e-3);
  PosePredHead(use_transformer=True) (the 128 layer dropped),
      PosePredHead(use_equalized=True) (EqualizedDense_<n>) and
      PosePredNet(use_transformer=True) (ReLU after each Dense): every
      output at 1e-5 x max(1, max|ref|);
  TRPESNet with either option: its parameter tree key for key and shape
      for shape the JAX model's (jax.eval_shape), torch -> flax -> torch
      -> flax bit for bit;
  one Ranger step on a use_transformer head from the same parameters and
      loss: the first moment (the centralised gradient, grouped by flax's
      axis 0: the attention's out kernel by head) and the parameters at
      1e-5 x max(1, max|ref|), which holds convert.flax_axis0_dim on the
      attention and LayerNorm leaves;
  decode_xyz_soft (both means), decode_xyz_hard and mask_argmax: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import torch_transparent_worker as W
from pose_estimation_tpu.configs import schema as jschema
from pose_estimation_tpu.models import decode as jdecode
from pose_estimation_tpu.models import equalized as jeq
from pose_estimation_tpu.models import pspnet as jpsp
from pose_estimation_tpu.models import transparent as jtr
from pose_estimation_tpu.train import optim as joptim
from pose_estimation_tpu.train.state import TrainState as JTrainState
from pose_estimation_tpu_torch import convert
from pose_estimation_tpu_torch.configs import schema
from pose_estimation_tpu_torch.models import decode, equalized, pspnet
from pose_estimation_tpu_torch.models import transparent as tr
from pose_estimation_tpu_torch.models.layers import Named
from pose_estimation_tpu_torch.train import optim
from pose_estimation_tpu_torch.train.state import TrainState

torch.set_num_threads(1)


def _flat(params) -> dict:
    return {"/".join(k): np.asarray(v) for k, v in
            flatten_dict(params).items()}


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, tol)
    return err


def _wrap(port):
    """The port's module as the one child of a model (convert reads a
    leaf's module from its path): (model, its name there)."""
    model = Named()
    model.child(port)
    return model, next(iter(model._modules))


def _pair(jmodule, port, *inputs, seed=0):
    """Initialise the JAX module on `inputs`, load its parameters into the
    port's module (strict): (variables, port)."""
    variables = jmodule.init(jax.random.PRNGKey(seed),
                             *[jnp.asarray(x) for x in inputs])
    model, name = _wrap(port)
    convert.load_flax_params(model, _flat({name: variables["params"]}))
    return variables, port


def _torch(x, dtype=None):
    t = torch.from_numpy(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def test_equalized_dense_matches_jax():
    x = np.random.RandomState(0).randn(3, 5, 24).astype(np.float32)
    variables, port = _pair(jeq.EqualizedDense(16), equalized.EqualizedDense(
        24, 16), x)
    assert variables["params"]["kernel"].shape == (24, 16)
    ref = jeq.EqualizedDense(16).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        _close(port(_torch(x)).numpy(), ref, 1e-5)


def test_equalized_conv_matches_jax():
    x = np.random.RandomState(1).randn(2, 9, 9, 4).astype(np.float32)
    jm = jeq.EqualizedConv(6, kernel=3, stride=2)
    variables, port = _pair(jm, equalized.EqualizedConv(4, 6, 3, 2), x)
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_transformer_block_matches_jax(dtype, tol):
    x = np.random.RandomState(2).randn(2, 7, 32).astype(np.float32)
    jm = jtr.TransformerEncoderBlock(32, 4, dim_ff=48,
                                     dtype=getattr(jnp, dtype))
    variables, port = _pair(jm, tr.TransformerEncoderBlock(
        32, 4, dim_ff=48, dtype=getattr(torch, dtype)), x)
    assert variables["params"]["MultiHeadDotProductAttention_0"]["out"][
        "kernel"].shape == (4, 8, 32)
    ref = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_torch(x))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(ref, np.float32), tol)


HEADS = {
    "transformer": (lambda: jtr.PosePredHead(3, use_transformer=True),
                    lambda: tr.PosePredHead(3, use_transformer=True), 1792),
    "equalized": (lambda: jtr.PosePredHead(3, use_equalized=True),
                  lambda: tr.PosePredHead(3, use_equalized=True), 1792),
    "posepred_transformer": (
        lambda: jpsp.PosePredNet(3, use_transformer=True),
        lambda: pspnet.PosePredNet(3, use_transformer=True), 2816),
}


def _head_inputs(width, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 6, width).astype(np.float32) * 0.5,
            np.array([2, 0], np.int32))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_heads_with_options_match_jax(name):
    jmake, make, width = HEADS[name]
    apx, obj = _head_inputs(width)
    variables, port = _pair(jmake(), make(), apx, obj)
    names = set(_flat(variables["params"]))
    if name == "equalized":
        assert "EqualizedDense_11/kernel" in names
    if name == "transformer":
        assert "Dense_8/kernel" in names and "Dense_9/kernel" not in names
        assert "TransformerEncoderBlock_2/LayerNorm_1/scale" in names
    ref = jmake().apply(variables, jnp.asarray(apx), jnp.asarray(obj))
    with torch.no_grad():
        got = port(_torch(apx), _torch(obj))
    for g, r in zip(got, ref):
        _close(g.numpy(), r, 1e-5)


@pytest.mark.parametrize("kw", [{"use_transformer": True},
                                {"use_equalized": True}])
def test_trpesnet_options_build_the_jax_tree(kw):
    batch = W.tiny_batch()
    jm = jtr.TRPESNet(num_points=W.NUM_POINTS, num_obj=W.NUM_OBJ, **kw)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)}, *[
        jnp.asarray(batch[k]) for k in ("img", "intrinsic", "xmap", "ymap",
                                        "d_scale", "obj")])["params"]
    want = {"/".join(k): tuple(v.shape)
            for k, v in flatten_dict(shapes).items()}
    port = tr.TRPESNet(W.NUM_POINTS, W.NUM_OBJ, **kw)
    flat = convert.torch_to_flax(port.state_dict())
    assert {k: v.shape for k, v in flat.items()} == want
    back = convert.torch_to_flax(convert.flax_to_torch(
        flat, tr.TRPESNet(W.NUM_POINTS, W.NUM_OBJ, **kw)))
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_ranger_step_on_a_transformer_head_matches_jax():
    apx, obj = _head_inputs(1792, seed=4)
    jm = jtr.PosePredHead(3, use_transformer=True)
    variables, port = _pair(jm, tr.PosePredHead(3, use_transformer=True),
                            apx, obj, seed=5)
    proj = [np.random.RandomState(6 + i).randn(2, 6, d).astype(np.float32)
            for i, d in enumerate((4, 3, 1))]

    def jloss(params):
        outs = jm.apply({"params": params}, jnp.asarray(apx),
                        jnp.asarray(obj))
        return sum(jnp.sum(o * jnp.asarray(p)) for o, p in zip(outs, proj))

    over = {"train.lr.warmup_iters": 0, "train.lr.lr": 1e-3}
    tx_ref = joptim.make_optimizer(jschema.override(
        jschema.transparent_cleargrasp(), **over), total_steps=10)
    ref = JTrainState.create(variables["params"], tx_ref,
                             jax.random.PRNGKey(0))
    ref = jax.jit(lambda st: st.apply_gradients(
        tx_ref, jax.grad(jloss)(st.params)))(ref)

    tx = optim.make_optimizer(schema.override(
        schema.transparent_cleargrasp(), **over), total_steps=10)
    model, name = _wrap(port)
    state = TrainState.create(model, tx, torch.Generator().manual_seed(0))
    outs = port(_torch(apx), _torch(obj))
    loss = sum(torch.sum(o * _torch(p)) for o, p in zip(outs, proj))
    names, params = zip(*model.named_parameters())
    state.apply_gradients(tx, dict(zip(names, torch.autograd.grad(
        loss, params))))

    mu = convert.tree_to_torch({name: ref.opt_state[1][1].mu})
    new = convert.tree_to_torch({name: ref.params})
    assert sorted(mu) == sorted(state.opt_state["mu"])
    out = (f"{name}.TransformerEncoderBlock_0.MultiHeadDotProductAttention_0"
           ".out.kernel")
    assert convert.flax_axis0_dim(out) == 0 and mu[out].shape[0] == 8
    got = dict(model.named_parameters())
    for k, v in mu.items():
        _close(state.opt_state["mu"][k].numpy(), v.numpy(), 1e-5)
        _close(got[k].detach().numpy(), new[k].numpy(), 1e-5)


# --- decode -----------------------------------------------------------------

def _decode_inputs():
    rng = np.random.RandomState(7)
    off = rng.randn(2, 5, 6, 3).astype(np.float32) * 0.1
    logits = rng.randn(2, 5, 6, 9).astype(np.float32) * 3
    logits[0, 0, 0, 2] = logits[0, 0, 0, 5] = 50.0        # a tie: the first
    pts = rng.randn(2, 9, 3).astype(np.float32)
    pts[:, 0] = 0.0
    return off, logits, pts


@pytest.mark.parametrize("fn", ["soft", "soft_mean", "hard", "mask"])
def test_decode_matches_jax(fn):
    off, logits, pts = _decode_inputs()
    j = [jnp.asarray(x) for x in (off, logits, pts)]
    t = [_torch(x) for x in (off, logits, pts)]
    if fn == "mask":
        got, ref = decode.mask_argmax(t[1]), jdecode.mask_argmax(j[1])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    if fn == "hard":
        got, ref = decode.decode_xyz_hard(*t), jdecode.decode_xyz_hard(*j)
    else:
        mean = fn == "soft_mean"
        got = decode.decode_xyz_soft(*t, reference_mean=mean)
        ref = jdecode.decode_xyz_soft(*j, reference_mean=mean)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
