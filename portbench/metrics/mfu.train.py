"""The whole train step's share of the card's dense bf16 peak: the reference's counted
operations per volume (``portbench/counts.py``) times the window's volumes per second."""


def read(rec):
    if rec.get("kind") != "train_step" or not rec.get("peak_flops"):
        return None
    return rec["flops_per_volume"] * rec["vol_s"] / rec["peak_flops"] * 100.0
