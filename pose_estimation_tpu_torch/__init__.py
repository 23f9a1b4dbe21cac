"""pose_estimation_tpu_torch — the PyTorch/CUDA port of pose_estimation_tpu.

The JAX package beside it is the reference: module paths and public
layouts mirror it (NHWC maps, [B, N, C] point features, [B, N, K, 3]
neighbour directions) so each counterpart is easy to find and the parity
tests compare like with like.

Layout:
  configs         the config schema (the JAX package's, field for field)
  core/geometry   rotations, intrinsics, Kabsch, affine crop sampling
  core/pointops   KNN / gathers / neighbour directions (KNN -> ops.pointops)
  core/solvers    batched EPnP (hypothesis grade), LM, PnP-RANSAC
  ops             hand-written CUDA kernels + their plain PyTorch versions
  csrc            CUDA sources, built at first use (ops/_build.py)
  models          HRNet, KRRN heads, 3D-GCN FusionNetLite, TBase
  metrics         ADD(-S), pose accuracy
  data            synthetic frames, eval-time sample preparation, batching
  serve           the two-stage image -> pose serving program
  convert         JAX ('/'-joined npz) params -> torch state_dict
  tools/infer     serving CLI (JSONL per frame)

It imports torch and nothing of JAX or of the JAX package; its tests
import both.
"""

__version__ = "0.1.0"
