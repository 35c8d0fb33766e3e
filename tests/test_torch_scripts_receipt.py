"""``saragan_tpu_torch.scripts.preemption_receipt`` end to end on the CPU at phase 1
(``--smoke --device cpu``): the uninterrupted CLI run, a SIGTERM in the middle of the
phase (exit 75, one ``*_interrupt.pkl``), the requeue with ``--auto_resume`` and the
bitwise comparison of the final parameters and EMA."""

import torch

torch.set_num_threads(1)


def test_preemption_receipt_smoke(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the subprocesses' torch threads
    from saragan_tpu_torch.scripts import preemption_receipt as m

    assert m.main([str(tmp_path), "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PREEMPTION RECEIPT OK" in out
    receipt = (tmp_path / "receipt.txt").read_text()
    assert "leg2 SIGTERM mid-phase: rc=75" in receipt
    assert "_interrupt.pkl" in receipt and "param/EMA arrays identical" in receipt
    assert "auto_resume: continuing from" in (tmp_path / "leg_requeued.txt").read_text()
