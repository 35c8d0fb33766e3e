"""FID Inception network (pool3, 2048-d) in PyTorch (counterpart of
``saragan_tpu/metrics/inception.py``).

The architecture is pytorch-fid's InceptionV3 up to pool3 (torchvision's InceptionV3 with
the FID variant's pooling: average pools with ``count_include_pad=False`` and a max pool
in Mixed_7c's pool branch), so pytorch-fid's ``pt_inception-2015-12-05`` weights drop in
after an offline conversion:

    params = convert_torch_state_dict("pt_inception-2015-12-05-6726825d.pth")
    save_inception_npz(params, "inception_fid.npz")          # once
    extractor = InceptionFeatures("inception_fid.npz")        # calibrated FID

Parameters are the JAX package's flat dict keyed by the torch state-dict names
(``Conv2d_1a_3x3.conv.weight``, ``...bn.running_var``), so one npz serves both packages.
BatchNorm runs in inference mode with the reference's explicit formula (eps 1e-3).  Input
of the extractor: (N, H, W, 3) in [0, 255], resized to 299x299 bilinearly (antialias off,
as pytorch-fid's ``F.interpolate(align_corners=False)``) and scaled to [-1, 1].

The network runs on the device it is given, CUDA unless the caller names the CPU, under
the serving numerics (deterministic cuDNN, TF32 off in convs and matmuls): cuDNN's TF32
default would put the card's features about 1e-3 off the CPU's.  The convs are
``F.conv2d``: the JAX package leaves them to XLA, no Pallas kernel is involved.
Nothing is downloaded: without a weights file the FID code falls back, on request, to
``fid.RandomConvFeatures``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from saragan_tpu_torch._device import resolve_device
from saragan_tpu_torch.train.step import _train_numerics

Params = Dict[str, np.ndarray]

BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# the network (NCHW, OIHW weights)
# ---------------------------------------------------------------------------


def _avg_pool_nip(x):
    """3x3 stride-1 average pool, count_include_pad=False (the FID variant's pooling)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)  # implicit padding is -inf


class InceptionPool3(torch.nn.Module):
    """pytorch-fid's InceptionV3 from its input to the 2048-d pool3 features, with the
    parameters of a flat name-keyed dict (``inception_param_shapes``) held as buffers."""

    def __init__(self, params: Params):
        super().__init__()
        missing = sorted(set(inception_param_shapes()) - set(params))
        if missing:
            raise KeyError(f"Inception params lack {missing[:5]} ({len(missing)} in all)")
        for name in inception_param_shapes():
            self.register_buffer(name.replace(".", "__"),
                                 torch.tensor(np.asarray(params[name], np.float32)))

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name.replace(".", "__"))

    def _basic_conv(self, prefix, x, stride=1, padding=0):
        x = F.conv2d(x, self._p(f"{prefix}.conv.weight"), stride=stride, padding=padding)

        def bn(k):
            return self._p(f"{prefix}.bn.{k}").view(1, -1, 1, 1)

        x = (x - bn("running_mean")) * torch.rsqrt(bn("running_var") + BN_EPS) * bn("weight") \
            + bn("bias")
        return torch.clamp_min(x, 0.0)

    def _inception_a(self, pre, x):
        c = self._basic_conv
        b1 = c(f"{pre}.branch1x1", x)
        b5 = c(f"{pre}.branch5x5_2", c(f"{pre}.branch5x5_1", x), padding=2)
        b3 = c(f"{pre}.branch3x3dbl_1", x)
        b3 = c(f"{pre}.branch3x3dbl_3", c(f"{pre}.branch3x3dbl_2", b3, padding=1), padding=1)
        bp = c(f"{pre}.branch_pool", _avg_pool_nip(x))
        return torch.cat([b1, b5, b3, bp], 1)

    def _inception_b(self, pre, x):
        c = self._basic_conv
        b3 = c(f"{pre}.branch3x3", x, stride=2)
        bd = c(f"{pre}.branch3x3dbl_2", c(f"{pre}.branch3x3dbl_1", x), padding=1)
        bd = c(f"{pre}.branch3x3dbl_3", bd, stride=2)
        return torch.cat([b3, bd, _max_pool(x)], 1)

    def _inception_c(self, pre, x):
        c = self._basic_conv
        b1 = c(f"{pre}.branch1x1", x)
        b7 = c(f"{pre}.branch7x7_1", x)
        b7 = c(f"{pre}.branch7x7_2", b7, padding=(0, 3))
        b7 = c(f"{pre}.branch7x7_3", b7, padding=(3, 0))
        bd = c(f"{pre}.branch7x7dbl_1", x)
        bd = c(f"{pre}.branch7x7dbl_2", bd, padding=(3, 0))
        bd = c(f"{pre}.branch7x7dbl_3", bd, padding=(0, 3))
        bd = c(f"{pre}.branch7x7dbl_4", bd, padding=(3, 0))
        bd = c(f"{pre}.branch7x7dbl_5", bd, padding=(0, 3))
        bp = c(f"{pre}.branch_pool", _avg_pool_nip(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _inception_d(self, pre, x):
        c = self._basic_conv
        b3 = c(f"{pre}.branch3x3_2", c(f"{pre}.branch3x3_1", x), stride=2)
        b7 = c(f"{pre}.branch7x7x3_1", x)
        b7 = c(f"{pre}.branch7x7x3_2", b7, padding=(0, 3))
        b7 = c(f"{pre}.branch7x7x3_3", b7, padding=(3, 0))
        b7 = c(f"{pre}.branch7x7x3_4", b7, stride=2)
        return torch.cat([b3, b7, _max_pool(x)], 1)

    def _inception_e(self, pre, x, pool: str):
        c = self._basic_conv
        b1 = c(f"{pre}.branch1x1", x)
        b3 = c(f"{pre}.branch3x3_1", x)
        b3 = torch.cat([c(f"{pre}.branch3x3_2a", b3, padding=(0, 1)),
                        c(f"{pre}.branch3x3_2b", b3, padding=(1, 0))], 1)
        bd = c(f"{pre}.branch3x3dbl_2", c(f"{pre}.branch3x3dbl_1", x), padding=1)
        bd = torch.cat([c(f"{pre}.branch3x3dbl_3a", bd, padding=(0, 1)),
                        c(f"{pre}.branch3x3dbl_3b", bd, padding=(1, 0))], 1)
        # FIDInceptionE_1 (Mixed_7b) pools by average, FIDInceptionE_2 (Mixed_7c) by max
        bp = _avg_pool_nip(x) if pool == "avg" else _max_pool(x, k=3, s=1, pad=1)
        bp = c(f"{pre}.branch_pool", bp)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, 299, 299) in [-1, 1] -> (N, 2048) pool3 features."""
        c = self._basic_conv
        x = c("Conv2d_1a_3x3", x, stride=2)
        x = c("Conv2d_2a_3x3", x)
        x = c("Conv2d_2b_3x3", x, padding=1)
        x = _max_pool(x)
        x = c("Conv2d_3b_1x1", x)
        x = c("Conv2d_4a_3x3", x)
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._inception_a(name, x)
        x = self._inception_b("Mixed_6a", x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._inception_c(name, x)
        x = self._inception_d("Mixed_7a", x)
        x = self._inception_e("Mixed_7b", x, pool="avg")
        x = self._inception_e("Mixed_7c", x, pool="max")
        return torch.mean(x, dim=(2, 3))  # the adaptive average pool to 1x1


def inception_pool3(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, 299, 299) in [-1, 1] -> (N, 2048) pool3 features, on x's device."""
    return InceptionPool3(params).to(x.device)(x)


def preprocess(images_0_255: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) in [0, 255] -> (N, 3, 299, 299) in [-1, 1] (pytorch-fid's
    preprocessing: /255, bilinear resize without antialiasing, x * 2 - 1)."""
    x = images_0_255.to(torch.float32).permute(0, 3, 1, 2) / 255.0
    x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                      antialias=False)
    return x * 2.0 - 1.0


# ---------------------------------------------------------------------------
# parameter shape table / init / conversion
# ---------------------------------------------------------------------------


def _bc_shapes(prefix, cin, cout, k) -> Dict[str, tuple]:
    kh, kw = (k, k) if isinstance(k, int) else k
    return {
        f"{prefix}.conv.weight": (cout, cin, kh, kw),
        f"{prefix}.bn.weight": (cout,),
        f"{prefix}.bn.bias": (cout,),
        f"{prefix}.bn.running_mean": (cout,),
        f"{prefix}.bn.running_var": (cout,),
    }


def inception_param_shapes() -> Dict[str, tuple]:
    """{state-dict name: shape} of every parameter the pool3 network reads."""
    s: Dict[str, tuple] = {}
    s.update(_bc_shapes("Conv2d_1a_3x3", 3, 32, 3))
    s.update(_bc_shapes("Conv2d_2a_3x3", 32, 32, 3))
    s.update(_bc_shapes("Conv2d_2b_3x3", 32, 64, 3))
    s.update(_bc_shapes("Conv2d_3b_1x1", 64, 80, 1))
    s.update(_bc_shapes("Conv2d_4a_3x3", 80, 192, 3))

    def block_a(pre, cin, pool_f):
        s.update(_bc_shapes(f"{pre}.branch1x1", cin, 64, 1))
        s.update(_bc_shapes(f"{pre}.branch5x5_1", cin, 48, 1))
        s.update(_bc_shapes(f"{pre}.branch5x5_2", 48, 64, 5))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_1", cin, 64, 1))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_2", 64, 96, 3))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_3", 96, 96, 3))
        s.update(_bc_shapes(f"{pre}.branch_pool", cin, pool_f, 1))

    block_a("Mixed_5b", 192, 32)
    block_a("Mixed_5c", 256, 64)
    block_a("Mixed_5d", 288, 64)

    s.update(_bc_shapes("Mixed_6a.branch3x3", 288, 384, 3))
    s.update(_bc_shapes("Mixed_6a.branch3x3dbl_1", 288, 64, 1))
    s.update(_bc_shapes("Mixed_6a.branch3x3dbl_2", 64, 96, 3))
    s.update(_bc_shapes("Mixed_6a.branch3x3dbl_3", 96, 96, 3))

    def block_c(pre, c7):
        s.update(_bc_shapes(f"{pre}.branch1x1", 768, 192, 1))
        s.update(_bc_shapes(f"{pre}.branch7x7_1", 768, c7, 1))
        s.update(_bc_shapes(f"{pre}.branch7x7_2", c7, c7, (1, 7)))
        s.update(_bc_shapes(f"{pre}.branch7x7_3", c7, 192, (7, 1)))
        s.update(_bc_shapes(f"{pre}.branch7x7dbl_1", 768, c7, 1))
        s.update(_bc_shapes(f"{pre}.branch7x7dbl_2", c7, c7, (7, 1)))
        s.update(_bc_shapes(f"{pre}.branch7x7dbl_3", c7, c7, (1, 7)))
        s.update(_bc_shapes(f"{pre}.branch7x7dbl_4", c7, c7, (7, 1)))
        s.update(_bc_shapes(f"{pre}.branch7x7dbl_5", c7, 192, (1, 7)))
        s.update(_bc_shapes(f"{pre}.branch_pool", 768, 192, 1))

    block_c("Mixed_6b", 128)
    block_c("Mixed_6c", 160)
    block_c("Mixed_6d", 160)
    block_c("Mixed_6e", 192)

    s.update(_bc_shapes("Mixed_7a.branch3x3_1", 768, 192, 1))
    s.update(_bc_shapes("Mixed_7a.branch3x3_2", 192, 320, 3))
    s.update(_bc_shapes("Mixed_7a.branch7x7x3_1", 768, 192, 1))
    s.update(_bc_shapes("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7)))
    s.update(_bc_shapes("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1)))
    s.update(_bc_shapes("Mixed_7a.branch7x7x3_4", 192, 192, 3))

    def block_e(pre, cin):
        s.update(_bc_shapes(f"{pre}.branch1x1", cin, 320, 1))
        s.update(_bc_shapes(f"{pre}.branch3x3_1", cin, 384, 1))
        s.update(_bc_shapes(f"{pre}.branch3x3_2a", 384, 384, (1, 3)))
        s.update(_bc_shapes(f"{pre}.branch3x3_2b", 384, 384, (3, 1)))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_1", cin, 448, 1))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_2", 448, 384, 3))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_3a", 384, 384, (1, 3)))
        s.update(_bc_shapes(f"{pre}.branch3x3dbl_3b", 384, 384, (3, 1)))
        s.update(_bc_shapes(f"{pre}.branch_pool", cin, 192, 1))

    block_e("Mixed_7b", 1280)
    block_e("Mixed_7c", 2048)
    return s


def random_inception_params(seed: int = 0) -> Params:
    """Correctly shaped random parameters (tests, structure checks) from the port's own
    ``torch.Generator``: the reference's distributions (BN scales and variances uniform in
    [0.5, 1.5], means and biases N(0, 0.1), weights N(0, 1 / fan_in)), not its bits."""
    g = torch.Generator().manual_seed(seed)
    out: Params = {}
    for k, shape in inception_param_shapes().items():
        if k.endswith(("running_var", "bn.weight")):
            v = torch.rand(shape, generator=g) + 0.5
        elif k.endswith(("running_mean", "bn.bias")):
            v = torch.randn(shape, generator=g) * 0.1
        else:
            v = torch.randn(shape, generator=g) / float(np.sqrt(np.prod(shape[1:])))
        out[k] = v.numpy().astype(np.float32)
    return out


def convert_torch_state_dict(path: str) -> Params:
    """pytorch-fid's state dict (.pth) -> the name-keyed numpy params."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out: Params = {}
    for k, shape in inception_param_shapes().items():
        if k not in sd:
            raise KeyError(f"state dict missing {k}")
        v = np.asarray(sd[k].detach().cpu().numpy(), np.float32)
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        out[k] = v
    return out


def save_inception_npz(params: Params, path: str) -> str:
    np.savez(path, **params)
    return path


def load_inception_npz(path: str) -> Params:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class InceptionPool3Features:
    """The FID feature extractor over this network: ``extract`` takes (N, H, W, 3) in
    [0, 255] (what ``fid.get_activations_from_volume`` feeds) and returns (N, 2048)
    float32 numpy.  The weights move to `device` once (CUDA unless named)."""

    def __init__(self, params: Params, device: Optional[str] = None):
        self.device = resolve_device(device)
        self.net = InceptionPool3(params).to(self.device).eval()

    def extract(self, images: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), _train_numerics():
            x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
            return self.net(preprocess(x)).float().cpu().numpy()
