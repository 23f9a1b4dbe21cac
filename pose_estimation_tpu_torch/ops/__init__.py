"""Hand-written CUDA kernels, each beside its plain PyTorch version
(pointops: KNN, nearest source point; gcn: the fused and the wide-table
3D-GCN aggregates)."""
