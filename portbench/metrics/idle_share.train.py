"""The device's idle share over the profiled steps: one minus the union of its
operations' intervals over the steps' wall time."""


def read(rec):
    if rec.get("kind") != "train_step" or not rec.get("window_s"):
        return None
    return (1.0 - rec["busy_s"] / rec["window_s"]) * 100.0
