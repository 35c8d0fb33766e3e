"""Host milliseconds to enqueue one step that starts on an idle card (median)."""


def read(rec):
    if rec.get("kind") != "train_step":
        return None
    return rec["host_enqueue_ms"]
