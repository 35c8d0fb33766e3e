"""Published peaks of the cards the benchmark knows, by ``torch.cuda.get_device_name``.

Dense rates without sparsity, from NVIDIA's H100 data sheet, at the card's full power
limit (the run records the limit it found): bf16 and fp16 on the tensor cores, TF32,
float32 outside the tensor cores, and HBM bandwidth.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    # H100 SXM5 80 GB
    "NVIDIA H100 80GB HBM3": dict(bf16=989e12, tf32=495e12, f32=67e12, hbm=3.35e12),
    # H100 PCIe 80 GB
    "NVIDIA H100 PCIe": dict(bf16=756e12, tf32=378e12, f32=51e12, hbm=2.0e12),
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)
