"""Model families of the port: pgan, pgan2, pgandeep, stylegan, stylegan2, surfgan."""

from saragan_tpu_torch.models.registry import Architecture, get_architecture, register

__all__ = ["Architecture", "get_architecture", "register"]
