"""The least time the card could take for some work (chip_smoke.py's
`bound`, frozen here): the larger of the bytes over the memory rate (each
input read once, each output written once) and the operations over the
peak rate of their type. Each op file (`ops/<op>.py`) counts its call's
bytes and operations from the call's own shapes and asks `bound`.
Published peaks of one NVIDIA H100 SXM (dense): 3.35 TB/s; 67 TFLOP/s
fp32 outside the tensor cores; 989 TFLOP/s bf16 on the tensor cores;
133.8 T/s packed bf16x2 on the CUDA cores."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16_tensor": 989e12, "bf16_packed": 133.8e12}
BF16_DENSE_FLOP_S = 989e12


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, ops: dict) -> float:
    """Seconds: max(bytes / HBM rate, sum of ops / their peak rate)."""
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(n_bytes / HBM_BYTES_S, t_ops)

