"""The seed-variance band of the convergence gates (counterpart of
``scripts/seed_band.py``): the flagship or 2-D recipe again under other training seeds
(data fixed; ``--seed`` varies the init and the per-step draws), one subprocess per seed,
serially on the one device, and the per-phase distribution of the relative change
(last - first) / first of the proxy FID, negative meaning improved.  A seed's run may fail
its own gate: its trajectory is data for the band all the same.

Run::

    python -m saragan_tpu_torch.scripts.seed_band flagship <outroot> [seeds...]  # 1-5
    python -m saragan_tpu_torch.scripts.seed_band 2d <outroot> [seeds...]        # 1-2
    python -m saragan_tpu_torch.scripts.seed_band 2d4 <outroot> [seeds...]       # 1-4

(seeds default to 42 1 2; ``--smoke``, phases 1 -> 2 on toy budgets, and ``--device``
pass through to the runs).  Writes ``<outroot>/band_<kind>.json`` (``kind``,
``seeds``, ``runs``, ``band``) and prints the band.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from saragan_tpu_torch.scripts import _evidence as ev

ENDING = {"flagship": 5, "2d": 2, "2d4": 4}
# the directory that holds the package, for the subprocesses' import path
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(kind: str, outdir: str, seed: int, ending: int, extra) -> dict:
    if kind == "flagship":
        module, traj = "convergence_run_flagship", f"trajectory_p1-{ending}.json"
        suffixes = ev.LAST_SUFFIXES
    else:
        module, traj = "convergence_run_2d", "trajectory_2d.json"
        suffixes = ev.LAST_SUFFIXES_2D
    cmd = [sys.executable, "-u", "-m", f"saragan_tpu_torch.scripts.{module}", outdir,
           str(ending), "--seed", str(seed), *extra]
    env = dict(os.environ,
               PYTHONPATH=PACKAGE_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    p = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    wall = time.time() - t0
    tail = "\n".join(p.stdout.splitlines()[-15:])
    with open(os.path.join(outdir, traj)) as f:
        trajectory = json.load(f)["trajectory"]
    first, last = ev.first_last(trajectory, suffixes)
    return {"seed": seed, "rc": p.returncode, "wall_s": round(wall, 1),
            "first": {str(k): v for k, v in first.items()},
            "last": {str(k): v for k, v in last.items()}, "tail": tail}


def band_of(results) -> dict:
    phases = sorted({ph for r in results for ph in r["first"]}, key=int)
    band = {}
    for ph in phases:
        rels = [(r["last"][ph] - r["first"][ph]) / abs(r["first"][ph])
                for r in results if ph in r["first"] and ph in r["last"]]
        band[ph] = {"rel_changes": [round(x, 4) for x in rels],
                    "worst": round(max(rels), 4), "best": round(min(rels), 4)}
    return band


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=sorted(ENDING))
    p.add_argument("outroot")
    p.add_argument("seeds", nargs="*", type=int)
    args = ev.add_common(p, seed=None).parse_args(argv)
    seeds = args.seeds or [42, 1, 2]
    ending = 2 if args.smoke else ENDING[args.kind]
    extra = (["--smoke"] if args.smoke else []) + (
        ["--device", args.device] if args.device else [])
    os.makedirs(args.outroot, exist_ok=True)
    results = []
    for seed in seeds:
        outdir = os.path.join(args.outroot, f"{args.kind}_seed{seed}")
        print(f"=== {args.kind} seed {seed} -> {outdir}", flush=True)
        r = run_one(args.kind, outdir, seed, ending, extra)
        results.append(r)
        print(json.dumps({k: r[k] for k in ("seed", "rc", "wall_s", "first", "last")}),
              flush=True)
    band = band_of(results)
    path = os.path.join(args.outroot, f"band_{args.kind}.json")
    with open(path, "w") as f:
        json.dump({"kind": args.kind, "seeds": seeds, "runs": results, "band": band}, f,
                  indent=1)
    print("BAND", json.dumps(band))
    print(f"written {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
