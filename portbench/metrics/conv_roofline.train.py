"""The convs' and dense layers' share of their roofline in the profiled steps: the sum
over the reference's counted calls of max(operations / peak, bytes / bandwidth), over the
device time of every conv and GEMM kernel (the frozen ``kernel_group``'s conv and GEMM
groups: kernels #1, #1' and #2, cuDNN, cuBLAS)."""


def read(rec):
    if rec.get("kind") != "train_step" or "roofline_s" not in rec:
        return None
    groups = rec["group_s"]
    conv_s = sum(groups.get(g, 0.0) for g in (*rec["conv_groups"], *rec["gemm_groups"]))
    if conv_s <= 0:
        return None
    return rec["roofline_s"] / conv_s * 100.0
