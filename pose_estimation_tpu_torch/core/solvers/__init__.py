"""Batched pose solvers: hypothesis-grade EPnP, LM refinement, PnP-RANSAC."""
