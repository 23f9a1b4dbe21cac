"""pose_estimation_tpu_torch — the PyTorch/CUDA port of pose_estimation_tpu.

The JAX package beside it is the reference: module paths and public
layouts mirror it (NHWC maps, [B, N, C] point features, [B, N, K, 3]
neighbour directions) so each counterpart is easy to find and the parity
tests compare like with like.

Layout:
  configs         the config schema (the JAX package's, field for field)
  core/geometry   rotations, intrinsics, Kabsch, affine crop sampling
  core/pointops   KNN, nearest source point, gathers, neighbour directions
                  (KNN and nearest -> ops.pointops)
  core/solvers    batched EPnP (hypothesis grade), LM, PnP-RANSAC
  ops             hand-written CUDA kernels + their plain PyTorch versions,
                  the autograd.Functions that train through them
  csrc            CUDA sources, built at first use (ops/_build.py)
  models          HRNet, KRRN heads, 3D-GCN FusionNetLite and FusionNet,
                  TBase
  losses          map losses, ADD(-S) pose loss, the KRRN aggregate
  metrics         ADD(-S), pose accuracy, ADD AUC, the per-object table
  data            synthetic frames, sample preparation, batching, prefetch
  serve           the two-stage image -> pose serving program
  train           Ranger, train state, train step, checkpoints, trainer
  parallel        the process group and its collectives (data parallelism
                  with the JAX global-batch semantics), the ring point ops
  cli             the training command line (torchrun for several cards)
  convert         JAX ('/'-joined npz) params and parameter-shaped trees
                  -> torch
  tools/infer     serving CLI (JSONL per frame)
  tools/profile_eval, tools/profile_serve
                  per-component and per-layer times on the card
  utils           the TensorBoard writer and pose overlays (tb, viz);
                  profiling: the program's spans (serve, krrn, pnp,
                  train, optim, op) and its host-sync counter, off by
                  default
  device          the card unless the caller asks for the CPU

It imports torch and nothing of JAX or of the JAX package; its tests
import both.
"""

__version__ = "0.1.0"
