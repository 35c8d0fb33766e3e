"""The family and HPO drivers of ``saragan_tpu_torch.scripts`` end to end on the CPU
(``--smoke --device cpu``, toy budgets): the five other families one phase each, and a
two-trial TPE study through the port's HPO harness."""

import json

import torch

torch.set_num_threads(1)


def test_family_smoke(tmp_path, capsys):
    from saragan_tpu_torch.scripts import family_chip_smoke as m

    assert m.main([str(tmp_path), "--smoke", "--device", "cpu"]) == 0
    assert "FAMILY SMOKE WIRING OK" in capsys.readouterr().out
    doc = json.loads((tmp_path / "family_smoke.json").read_text())
    assert [r["arch"] for r in doc] == m.FAMILIES
    for r in doc:
        assert {"arch", "wall_s", "steps_img", "first_moment_err", "last_moment_err",
                "improved", "trajectory"} <= set(r)
        assert r["losses_finite"] and r["n_losses"] > 0


def test_hpo_demo_smoke(tmp_path, capsys):
    from saragan_tpu_torch.scripts import hpo_chip_demo as m

    assert m.main([str(tmp_path), "2", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2/2 trials complete" in out and "HPO DEMO OK" in out
    assert (tmp_path / "study.db").is_file()
