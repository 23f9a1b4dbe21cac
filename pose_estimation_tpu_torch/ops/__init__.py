"""Hand-written CUDA kernels, each beside its plain PyTorch version
(pointops: KNN, nearest source point; gcn: the fused and the wide-table
3D-GCN aggregates; resize: bilinear up-sampling of NCHW maps), and the
check of a configuration against the kernels' limits
(limits.check_config)."""

from pose_estimation_tpu_torch.ops.limits import check_config  # noqa: F401
