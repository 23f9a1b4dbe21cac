"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version (pointops: KNN; gcn: fused 3D-GCN aggregates)."""
