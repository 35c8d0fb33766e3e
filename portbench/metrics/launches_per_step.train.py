"""The host's kernel-launch calls per profiled step."""


def read(rec):
    if rec.get("kind") != "train_step" or not rec.get("steps"):
        return None
    return rec["launches"] / rec["steps"]
