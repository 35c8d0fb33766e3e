"""Device milliseconds a step in the kernels outside the conv and GEMM groups of the
frozen ``kernel_group`` (elementwise, reductions, the fused bias+act+pixel-norm)."""


def read(rec):
    if rec.get("kind") != "train_step" or not rec.get("steps"):
        return None
    skip = set(rec["conv_groups"]) | set(rec["gemm_groups"])
    other = sum(v for g, v in rec["group_s"].items() if g not in skip)
    return other / rec["steps"] * 1e3
