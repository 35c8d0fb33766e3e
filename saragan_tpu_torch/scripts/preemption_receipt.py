"""The preemption and auto-resume receipt (counterpart of
``scripts/preemption_receipt.py``), every leg through ``python -m saragan_tpu_torch``:

  1. an uninterrupted run of the CLI;
  2. the same command with a fresh logdir, sent SIGTERM in the middle of its last phase:
     it must exit 75 (EX_TEMPFAIL) and leave one exact-resume ``*_interrupt.pkl``;
  3. the identical command line again with ``--auto_resume``: it must continue from that
     point and exit 0;
  4. the requeued run's final ``model_<P>.npz`` must equal the uninterrupted run's bit for
     bit, parameters and EMA alike.

Equality is exact because the full-state resume restores parameters, optimizer slots and
counters, each step's draws depend only on (seed, phase, step), and the dataset's shuffle
fast-forwards to the consumed position.

Run::

    python -m saragan_tpu_torch.scripts.preemption_receipt <workdir> [--smoke] [--device cpu]

(phases 1 -> 2; ``--smoke``: phase 1 alone on toy budgets).  Writes ``<workdir>/receipt.txt`` and
prints ``PREEMPTION RECEIPT OK``; exits non-zero when a leg misbehaves.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

import numpy as np

from saragan_tpu_torch import resolve_device
from saragan_tpu_torch.scripts import _evidence as ev

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ReceiptError(RuntimeError):
    pass


def make_data(root: str, n: int = 24, sizes=(4, 8, 16)):
    rng = np.random.default_rng(0)
    for size in sizes:
        d = os.path.join(root, f"{size}x{size}")
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            np.save(os.path.join(d, f"{i:04d}.npy"),
                    rng.normal(size=(size,) * 3).astype(np.float32))


def cli_cmd(data: str, logdir: str, ending_phase: int, smoke: bool, device, auto_resume):
    nimg = "64" if smoke else "512"
    cmd = [
        sys.executable, "-u", "-m", "saragan_tpu_torch", "pgan", data,
        "--start_shape", "(1, 4, 4, 4)", "--final_shape", "(1, 16, 16, 16)",
        "--starting_phase", "1", "--ending_phase", str(ending_phase),
        "--latent_dim", "32", "--network_size", "xs",
        "--base_batch_size", "16", "--mixing_nimg", nimg,
        "--stabilizing_nimg", nimg, "--noise_stddev", "0.0",
        "--g_lr", "1e-3", "--d_lr", "1e-3",
        "--summary_small_every_nsteps", "16" if smoke else "64",
        "--checkpoint_every_nsteps", "100000",
        "--logdir", logdir,
    ]
    if device:
        cmd += ["--device", device]
    if auto_resume:
        cmd.append("--auto_resume")
    return cmd


def run_leg(cmd, log_path: str, kill_in_phase=None, timeout: float = 3600) -> int:
    """Run one CLI leg, its output to `log_path`; with `kill_in_phase`, SIGTERM once that
    phase printed its second step line."""
    env = dict(os.environ,
               PYTHONPATH=PACKAGE_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    with open(log_path, "w") as logf:
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, bufsize=1)
        try:
            in_phase, seen, sent = False, 0, False
            for line in p.stdout:
                logf.write(line)
                logf.flush()
                if kill_in_phase is not None:
                    in_phase = in_phase or f"Begin mixing epochs in phase {kill_in_phase}" in line
                    if in_phase and "\tStep " in line:
                        seen += 1
                    if not sent and seen >= 2:
                        p.send_signal(signal.SIGTERM)
                        sent = True
                if time.time() - t0 > timeout:
                    raise ReceiptError(f"leg stuck; see {log_path}")
            return p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()


def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def receipt(workdir: str, ending_phase: int, smoke: bool, device) -> str:
    os.makedirs(workdir, exist_ok=True)
    data = os.path.join(workdir, "data")
    make_data(data, sizes=(4, 8, 16)[:ending_phase])
    lines = []

    def expect(cond, msg):
        if not cond:
            raise ReceiptError(msg)

    log_u = os.path.join(workdir, "logs_uninterrupted")
    t0 = time.time()
    rc = run_leg(cli_cmd(data, log_u, ending_phase, smoke, device, False),
                 os.path.join(workdir, "leg_uninterrupted.txt"))
    lines.append(f"leg1 uninterrupted: rc={rc} wall={time.time() - t0:.0f}s")
    expect(rc == 0, f"the uninterrupted run exited {rc}")

    log_i = os.path.join(workdir, "logs_preempted")
    cmd = cli_cmd(data, log_i, ending_phase, smoke, device, True)
    t0 = time.time()
    rc = run_leg(cmd, os.path.join(workdir, "leg_preempted.txt"), kill_in_phase=ending_phase)
    lines.append(f"leg2 SIGTERM mid-phase: rc={rc} wall={time.time() - t0:.0f}s")
    expect(rc == 75, f"expected EX_TEMPFAIL 75, got {rc}")
    pkls = [f for f in os.listdir(log_i) if f.endswith("_interrupt.pkl")]
    expect(len(pkls) == 1, f"resume points {os.listdir(log_i)}")
    lines.append(f"leg2 resume point: {pkls[0]}")

    t0 = time.time()
    leg3 = os.path.join(workdir, "leg_requeued.txt")
    rc = run_leg(cmd, leg3)
    lines.append(f"leg3 requeue: rc={rc} wall={time.time() - t0:.0f}s")
    expect(rc == 0, f"the requeued run exited {rc}")
    with open(leg3) as f:
        expect("auto_resume: continuing from" in f.read(), "the requeue did not resume")

    u = load_npz(os.path.join(log_u, f"model_{ending_phase}.npz"))
    i = load_npz(os.path.join(log_i, f"model_{ending_phase}.npz"))
    expect(set(u) == set(i), "the checkpoints hold other arrays")
    keys = [k for k in u if k.startswith(("params/", "ema/"))]
    expect(keys, f"no params/ or ema/ arrays in model_{ending_phase}.npz: {sorted(u)[:5]}")
    mismatched = [k for k in keys if not np.array_equal(u[k], i[k])]
    expect(not mismatched, f"arrays differ: {mismatched[:5]}")
    lines.append(f"bitwise equality: {len(keys)} param/EMA arrays identical between the "
                 f"uninterrupted and the preempted + requeued runs")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir")
    args = ev.add_common(p, seed=None).parse_args(argv)
    resolve_device(args.device)  # without a GPU and without --device cpu this raises
    ending = 1 if args.smoke else 2
    try:
        txt = receipt(args.workdir, ending, args.smoke, args.device)
    except ReceiptError as e:
        print(f"PREEMPTION RECEIPT FAILED: {e}", flush=True)
        return 1
    txt += "\nPREEMPTION RECEIPT OK\n"
    with open(os.path.join(args.workdir, "receipt.txt"), "w") as f:
        f.write(txt)
    print(txt, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
