"""Op library of the port: plain tensor ops and the hand-written Hopper kernels."""

from saragan_tpu_torch.ops.core import alpha_update  # noqa: F401
