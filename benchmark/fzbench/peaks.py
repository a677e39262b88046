"""The card's published peaks, for the roofline shares.

NVIDIA's H100 SXM data sheet, dense, without sparsity: 67 TFLOP/s of
float32 outside the tensor cores (the port refuses TF32), 3.35 TB/s of
HBM3.  They hold at the 700 W power limit; the run prints the card's
limit beside every share.  A card not in the table has no roofline.
"""

from __future__ import annotations

import shutil
import subprocess

PEAKS = {
    # name as torch.cuda.get_device_name gives it: (FLOP/s, bytes/s)
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def peaks(kind):
    return PEAKS.get(kind)


def least_time(ops, nbytes, kind):
    """(seconds, "operations" or "bytes") the call's work needs at the
    card's peaks, or None for a card not in the table."""
    pk = peaks(kind)
    if pk is None:
        return None
    t_ops, t_bytes = ops / pk[0], nbytes / pk[1]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def power_limits():
    """`nvidia-smi`'s name and power limit of each card (read only), or
    [] where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
