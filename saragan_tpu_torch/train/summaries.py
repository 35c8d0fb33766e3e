"""Training summaries (counterpart of ``saragan_tpu/train/summaries.py``): the scalar
families with the reference's tag names (losses, penalty, image min/max, alpha, learning
rates, gradient norms, throughput) and their ``_val`` / ``_EMA`` / ``_freeze``
suffixes, per-variable gradient histograms, image mosaics of z-slices, and the
timestamped stdout line.

The writer always appends one JSON object per event to ``<logdir>/events.jsonl``, the
machine-readable log.  It also writes TensorBoard event files when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard`` package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


class SummaryWriter:
    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self._tb = None
        self._jsonl = None
        if logdir is None:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a", buffering=1)
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter

            self._tb = TBWriter(log_dir=logdir)
        except Exception:  # no tensorboard package: events.jsonl only
            self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def text(self, tag: str, text: str, step: int):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "text": str(text), "step": int(step)})
                              + "\n")
        if self._tb is not None:
            self._tb.add_text(tag, str(text), step)

    def scalars(self, values: Dict[str, float], step: int):
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def image(self, tag: str, image_hw_or_hwc: np.ndarray, step: int):
        if self._tb is not None:
            img = image_hw_or_hwc
            if img.ndim == 2:
                img = img[None]
            elif img.ndim == 3 and img.shape[-1] in (1, 3):
                img = np.transpose(img, (2, 0, 1))
            self._tb.add_image(tag, img.astype(np.float32), step)

    def histogram_raw(self, tag: str, counts, edges, step: int):
        """A histogram binned on the device: 64 counts and 65 edges per variable."""
        counts = np.asarray(counts, np.float64)
        edges = np.asarray(edges, np.float64)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({
                "tag": tag, "step": int(step), "hist": True,
                "min": float(edges[0]), "max": float(edges[-1]),
                "count": float(counts.sum()),
                "counts": counts.tolist(), "edges": edges.tolist(),
            }) + "\n")
        if self._tb is not None:
            centers = (edges[:-1] + edges[1:]) / 2.0
            total = float(counts.sum())
            if total <= 0:
                return
            self._tb.add_histogram_raw(
                tag, min=float(edges[0]), max=float(edges[-1]), num=int(total),
                sum=float((counts * centers).sum()),
                sum_squares=float((counts * centers ** 2).sum()),
                bucket_limits=edges[1:].tolist(), bucket_counts=counts.tolist(),
                global_step=step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


def small_summary(d_loss, g_loss, gp_loss, fake, real, suffix: str = "") -> Dict[str, float]:
    """The small family: ``Loss/`` losses (the penalty's tag is ``gp``) and the
    ``Image_properties`` min/max scalars."""
    return {
        f"Loss/d_loss{suffix}": float(d_loss),
        f"Loss/g_loss{suffix}": float(g_loss),
        f"Loss/gp{suffix}": float(gp_loss),
        **image_range_summary(fake, real, suffix),
    }


def image_range_summary(fake, real, suffix: str = "") -> Dict[str, float]:
    """Min/max of the generated batch and of the FIRST real sample; `fake`/`real` are
    arrays or precomputed (min, max) pairs."""
    fmin, fmax = fake if isinstance(fake, tuple) else (np.min(fake), np.max(fake))
    rmin, rmax = real if isinstance(real, tuple) else (np.min(real[0]), np.max(real[0]))
    return {
        f"Image_properties/image_min_fake{suffix}": float(fmin),
        f"Image_properties/image_max_fake{suffix}": float(fmax),
        f"Image_properties/image_min_real{suffix}": float(rmin),
        f"Image_properties/image_max_real{suffix}": float(rmax),
    }


def training_props_summary(alpha, g_lr, d_lr) -> Dict[str, float]:
    return {
        "Training_properties/alpha": float(alpha),
        "Training_properties/g_lr": float(g_lr),
        "Training_properties/d_lr": float(d_lr),
    }


def memory_summary(device=None) -> Dict[str, float]:
    """Host RSS share (when psutil is installed) and, on a CUDA device, the bytes
    PyTorch's allocator holds now and at its peak (``torch.cuda.memory_stats``)."""
    out: Dict[str, float] = {}
    try:
        import psutil

        out["memory/host_rss_percent"] = float(psutil.Process().memory_percent())
    except Exception:  # telemetry never stops the loop
        pass
    if device is not None and torch.device(device).type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out["memory/device_bytes_in_use"] = float(stats.get("allocated_bytes.all.current", 0))
        out["memory/device_peak_bytes_in_use"] = float(stats.get("allocated_bytes.all.peak", 0))
    return out


def gradients_summary(max_g_norm, max_d_norm, suffix: str = "") -> Dict[str, float]:
    """Gradient max-norms, under the ``Loss/`` scope as in the reference."""
    return {
        f"Loss/max_g_grad_norm{suffix}": float(max_g_norm),
        f"Loss/max_d_grad_norm{suffix}": float(max_d_norm),
    }


def image_grid(batch: np.ndarray, grid_cols: int = 4, pad_value: float = 0.0) -> np.ndarray:
    """Mosaic of the centre z-slices of a (N, C, D, H, W) batch; 2D (N, C, H, W)
    batches are used as they are.  Returns (H', W') grayscale."""
    if batch.ndim == 5:
        imgs = batch[:, 0, batch.shape[2] // 2]
    elif batch.ndim == 4:
        imgs = batch[:, 0]
    else:
        raise ValueError(batch.shape)
    n, h, w = imgs.shape
    if n == 0:
        raise ValueError("image_grid: empty batch (no samples to tile)")
    cols = min(grid_cols, n)
    rows = (n + cols - 1) // cols
    grid = np.full((rows * h, cols * w), pad_value, imgs.dtype)
    for i in range(n):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = imgs[i]
    return grid


def grid_to_uint8(grid: np.ndarray) -> np.ndarray:
    """Min-max normalize a mosaic to uint8 for PNG writers (flat grids map to zeros)."""
    lo, hi = grid.min(), grid.max()
    img = np.zeros_like(grid, dtype=np.float64) if hi == lo else (grid - lo) / (hi - lo)
    return (img * 255).astype(np.uint8)


def print_summary_to_stdout(global_step, in_phase_step, img_s, local_img_s, d_loss, g_loss,
                            d_lr_val, g_lr_val, alpha):
    """The timestamped step line, in the reference's format."""
    current_time = time.strftime("%Y-%m-%d_%H:%M:%S", time.gmtime())
    print(f"{current_time} \t"
          f"Step {global_step:09} \t"
          f"Step(phase) {in_phase_step:09} \t"
          f"img/s {img_s:.2f} \t "
          f"img/s/worker {local_img_s:.3f} \t"
          f"d_loss {d_loss:.4f} \t "
          f"g_loss {g_loss:.4f} \t "
          f"d_lr {d_lr_val:.5f} \t"
          f"g_lr {g_lr_val:.5f} \t"
          f"alpha {float(alpha):.2f}", flush=True)
