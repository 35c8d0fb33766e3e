"""The port's quality-evidence drivers, counterparts of the JAX package's ``scripts/`` of
the same names; each runs as ``python -m saragan_tpu_torch.scripts.<name>``:

* ``convergence_run_flagship``: the anisotropic flagship growth schedule (1, 1, 4, 4) ->
  phase 6, the phase-7 leg and the phase-8 leg, gated on the measured seed band;
* ``convergence_run``: the cubic schedule 4³ -> 32³ for any family;
* ``convergence_run_2d``: the 2-D path through the JPEG class folders;
* ``seed_band``: the per-phase band of first -> last proxy-FID over training seeds;
* ``family_chip_smoke``: the five other families, one phase each;
* ``hpo_chip_demo``: the HPO harness's samplers and modes on real training trials;
* ``preemption_receipt``: SIGTERM, exit 75, ``--auto_resume``, bit-equal end state.

Every driver runs on the CUDA device unless given ``--device cpu`` (without a GPU it
raises), takes ``--seed`` where the training seed varies and ``--smoke`` for toy budgets,
and exits non-zero when its gate fails.  ``_evidence`` holds the data, the recording
metrics callback and the gates they share.
"""
