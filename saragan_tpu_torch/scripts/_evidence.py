"""What the convergence drivers share: the synthetic data, the recording metrics
callback and the quality gates.

Data (bit-equal to the JAX package's drivers for the same seeds):

* the cubic blob pyramid of ``scripts/convergence_run.py``: ``make_blob_volume``,
  ``downsample``, ``build_dataset`` (one master volume per index, block-mean levels);
* the anisotropic field of ``scripts/convergence_run_flagship.py``:
  ``make_blob_volume_aniso``, ``build_level`` (the same analytic field evaluated on each
  level's (hw/4, hw, hw) grid);
* the 2-D JPEG class folders of ``scripts/convergence_run_2d.py``: ``make_blob_image``,
  ``build_dataset_2d``.

``Recorder`` is the metrics callback the drivers hand the trainer: it records one
trajectory entry per metric pass under the JAX drivers' keys (``phase``, ``step``,
``suffix``, ``time`` and the metrics: ``FID``, ``mse``, ``swd``), prints it as a
``METRIC`` line with the host's RSS, ``torch.cuda.max_memory_allocated`` and the steps
per second since the previous pass, and rewrites the trajectory file after every pass.

The gates are plain functions of a trajectory that return a ``Verdict``:

* ``band_gate``: every regressing phase is within the noise tolerance (+5 %) or a bounded
  fade disruption (at most +100 %) whose final reading beats every later in-phase reading;
  a majority of phases improve; the summed relative change is negative
  (``convergence_run.py:193-248``, ``convergence_run_flagship.py:260-305``);
* ``caps_gate_2d``: the 2-D per-phase caps (``convergence_run_2d.py:189-207``);
* ``recovery_gate``: a chained big-phase leg's final reading beats every in-phase reading
  after its first step (``convergence_run_flagship.py:226-248``);
* ``finite_gate``: the phase-8 leg's final reading exists and is finite (``:218-224``);
* ``smoke_gate``: a toy budget's end-of-phase readings are finite.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import resource
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the seed-band gate (measured on the JAX package's three-seed flagship band): small
# regressions are seed noise, one bounded fade-disruption mode recovers
NOISE_TOL = 0.05
REGRESSION_CAP = 1.0
# the 2-D band's per-phase caps and the cap of the phases it did not measure
NOISE_TOL_PER_PHASE_2D = {1: 0.05, 2: 0.08, 3: 0.04, 4: 0.04}
DEFAULT_TOL_2D = 0.08
# the readings that end a phase: the EMA pass and the end-of-phase splits
LAST_SUFFIXES = ("_EMA", "_validation")
LAST_SUFFIXES_2D = ("_EMA", "_validation", "_test")

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_blob_volume(rng: np.random.Generator, size: int = 32) -> np.ndarray:
    """1-3 gaussian ellipsoids + smooth low-frequency background on a size³ grid."""
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, size)] * 3), indexing="ij")
    vol = np.zeros((size, size, size), np.float32)
    for _ in range(rng.integers(1, 4)):
        c = rng.uniform(-0.5, 0.5, 3)
        s = rng.uniform(0.12, 0.35, 3)
        a = rng.uniform(0.8, 1.6)
        vol += a * np.exp(
            -(((zz - c[0]) / s[0]) ** 2 + ((yy - c[1]) / s[1]) ** 2 + ((xx - c[2]) / s[2]) ** 2)
        )
    f = rng.uniform(0.5, 1.5, 3)
    p = rng.uniform(0, 2 * np.pi, 3)
    vol += 0.2 * np.sin(f[0] * np.pi * zz + p[0]) * np.sin(f[1] * np.pi * yy + p[1]) * np.sin(
        f[2] * np.pi * xx + p[2]
    )
    return vol.astype(np.float32)


def downsample(vol: np.ndarray, size: int) -> np.ndarray:
    """Block mean of a cubic volume down to size³."""
    factor = vol.shape[0] // size
    if factor == 1:
        return vol
    s = size
    return vol.reshape(s, factor, s, factor, s, factor).mean(axis=(1, 3, 5))


def cubic_stats(master: int):
    """(mean, std) of 64 analytic volumes at the master size: the normalisation."""
    sample = np.stack([make_blob_volume(np.random.default_rng(10_000 + i), master)
                       for i in range(64)])
    return float(sample.mean()), float(sample.std())


def build_dataset(root: str, n: int = 384, master: int = 32, seed: int = 0):
    """The cubic pyramid 4³ .. master³ under `root` (``<s>x<s>/v<i>.npy``); returns the
    normalisation (mean, std)."""
    rng = np.random.default_rng(seed)
    sizes = [4 * 2**i for i in range(int(np.log2(master // 4)) + 1)]
    for s in sizes:
        os.makedirs(os.path.join(root, f"{s}x{s}"), exist_ok=True)
    for i in range(n):
        vol = make_blob_volume(rng, master)
        for s in sizes:
            np.save(os.path.join(root, f"{s}x{s}", f"v{i:04d}.npy"), downsample(vol, s))
    return cubic_stats(master)


def cubic_dataset(root: str, master: int, n: int = 384):
    """The cubic pyramid, built unless its master level exists; returns (mean, std)."""
    if os.path.isdir(os.path.join(root, f"{master}x{master}")):
        print("Reusing existing blob pyramid", flush=True)
        return cubic_stats(master)
    print(f"Building synthetic blob pyramid (master {master}³) ...", flush=True)
    return build_dataset(root, n=n, master=master)


def make_blob_volume_aniso(seed: int, hw: int) -> np.ndarray:
    """1-3 gaussian ellipsoids + low-frequency ripple on a (hw/4, hw, hw) grid.  Every
    random draw comes before any grid evaluation, so a seed gives the same continuous
    field at every resolution."""
    d = max(1, hw // 4)
    rng = np.random.default_rng(seed)
    blobs = [
        (rng.uniform(-0.5, 0.5, 3), rng.uniform(0.12, 0.35, 3), rng.uniform(0.8, 1.6))
        for _ in range(rng.integers(1, 4))
    ]
    f = rng.uniform(0.5, 1.5, 3)
    p = rng.uniform(0, 2 * np.pi, 3)
    zz = np.linspace(-1, 1, d, dtype=np.float32).reshape(d, 1, 1)
    yy = np.linspace(-1, 1, hw, dtype=np.float32).reshape(1, hw, 1)
    xx = np.linspace(-1, 1, hw, dtype=np.float32).reshape(1, 1, hw)
    vol = np.zeros((d, hw, hw), np.float32)
    for c, s, a in blobs:
        vol += a * np.exp(
            -(((zz - c[0]) / s[0]) ** 2 + ((yy - c[1]) / s[1]) ** 2 + ((xx - c[2]) / s[2]) ** 2)
        )
    vol += (
        0.2
        * np.sin(f[0] * np.pi * zz + p[0])
        * np.sin(f[1] * np.pi * yy + p[1])
        * np.sin(f[2] * np.pi * xx + p[2])
    )
    return vol


def build_level(root: str, hw: int, n: int, seed_base: int = 31_000_000):
    """`n` anisotropic volumes at width `hw` under ``<root>/<hw>x<hw>``, unless there."""
    d = os.path.join(root, f"{hw}x{hw}")
    if os.path.isdir(d) and len(os.listdir(d)) >= n:
        return
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    for i in range(n):
        np.save(os.path.join(d, f"v{i:04d}.npy"), make_blob_volume_aniso(seed_base + i, hw))
    print(f"  level {hw}: {n} volumes in {time.time() - t0:.0f}s", flush=True)


def aniso_stats():
    """(mean, std) of the anisotropic field at width 64: the flagship's normalisation."""
    sample = np.stack([make_blob_volume_aniso(31_500_000 + i, 64) for i in range(64)])
    return float(sample.mean()), float(sample.std())


MASTER_2D = 64  # JPEG resolution on disk; the pipeline resizes per phase


def make_blob_image(rng: np.random.Generator, size: int = MASTER_2D) -> np.ndarray:
    """1-3 gaussian blobs + low-frequency ripple, uint8 grayscale."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij")
    img = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(1, 4)):
        c = rng.uniform(-0.5, 0.5, 2)
        s = rng.uniform(0.12, 0.35, 2)
        a = rng.uniform(0.8, 1.6)
        img += a * np.exp(-(((yy - c[0]) / s[0]) ** 2 + ((xx - c[1]) / s[1]) ** 2))
    f = rng.uniform(0.5, 1.5, 2)
    p = rng.uniform(0, 2 * np.pi, 2)
    img += 0.2 * np.sin(f[0] * np.pi * yy + p[0]) * np.sin(f[1] * np.pi * xx + p[1])
    img = img / max(img.max(), 1e-6)
    return (img * 255).astype(np.uint8)


def image_seeds(n: int = 400, seed: int = 0) -> List[tuple]:
    """(split, file index, image seed) of every JPEG of ``build_dataset_2d``."""
    rng = np.random.default_rng(seed)
    n_test = max(1, n // 10)
    out = []
    for split, count, off in (("train", n - n_test, 0), ("test", n_test, n - n_test)):
        for i in range(count):
            out.append((split, off + i, rng.integers(2**31) + off + i))
    return out


def build_dataset_2d(root: str, n: int = 400, seed: int = 0) -> None:
    """JPEG class folders ``<root>/{train,test}/n001/img_<i>.JPEG`` (RGB, quality 95)."""
    from PIL import Image

    for split, idx, s in image_seeds(n, seed):
        d = os.path.join(root, split, "n001")
        os.makedirs(d, exist_ok=True)
        arr = make_blob_image(np.random.default_rng(s))
        Image.fromarray(arr, mode="L").convert("RGB").save(
            os.path.join(d, f"img_{idx:05d}.JPEG"), quality=95)


# ---------------------------------------------------------------------------
# the recording metrics callback
# ---------------------------------------------------------------------------


def host_rss_mib():
    """(current, peak) resident set of this process in MiB: VmRSS from /proc/self/status,
    the peak from ``getrusage`` (ru_maxrss, KiB on Linux)."""
    rss = float("nan")
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 1024
    return rss, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _json_value(v):
    return np.asarray(v).tolist() if hasattr(v, "tolist") else float(v)


class Recorder:
    """``callback(trainer, sampler, dataset, step, suffix)`` around `base` (the same
    signature, returning a metrics dict): records ``trajectory`` (the JAX drivers' keys)
    and ``passes`` (per pass: the host's RSS and peak RSS in MiB, the device's peak
    allocation since the phase began, the steps per second since the previous pass, the
    pass's seconds), and rewrites `path` after every pass."""

    fid_calibrated = False  # random features: run-internal trajectories only

    def __init__(self, base: Callable, path: Optional[str] = None):
        self.base = base
        self.path = path
        self.trajectory: List[dict] = []
        self.passes: List[dict] = []
        self._mark = None  # (phase, step, perf_counter) at the end of the previous pass
        self.t0 = time.time()

    def __call__(self, trainer, sampler, dataset, step, suffix):
        t_in = time.perf_counter()
        phase = trainer.phase
        rate = None
        if self._mark is not None and self._mark[0] == phase and step > self._mark[1]:
            batch = trainer.cfg.batch_size_for_phase(phase, trainer.global_size)
            steps = (step - self._mark[1]) / (batch * trainer.global_size)
            rate = steps / (t_in - self._mark[2])
        m = self.base(trainer, sampler, dataset, step, suffix)
        entry = {"phase": phase, "step": int(step), "suffix": suffix, "time": time.time()}
        for k, v in (m or {}).items():
            entry[k] = _json_value(v)
        self.trajectory.append(entry)
        rss, rss_peak = host_rss_mib()
        cuda = trainer.device.type == "cuda"
        info = {"phase": phase, "step": int(step), "suffix": suffix,
                "rss_mib": rss, "rss_peak_mib": rss_peak,
                "cuda_peak_mib": (torch.cuda.max_memory_allocated(trainer.device) / 2**20
                                  if cuda else None),
                "steps_per_s": rate, "metric_s": time.perf_counter() - t_in}
        self.passes.append(info)
        print("METRIC", json.dumps(entry), flush=True)
        peak = info["cuda_peak_mib"]
        print(f"HOST phase {phase} step {step}{suffix}: rss {rss:.0f} MiB (peak "
              f"{rss_peak:.0f}), cuda peak {'-' if peak is None else f'{peak:.0f}'} MiB, "
              f"steps/s since the last pass {'-' if rate is None else f'{rate:.3f}'}, "
              f"pass {info['metric_s']:.1f} s", flush=True)
        if self.path:
            self.write()
        self._mark = (phase, step, time.perf_counter())
        return m

    def write(self, **extra):
        doc = {"trajectory": self.trajectory, "wall_s": time.time() - self.t0,
               "passes": self.passes, **extra}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=_json_value)
        os.replace(tmp, self.path)

    def phase_table(self, last_suffixes: Sequence[str] = LAST_SUFFIXES) -> Dict[int, dict]:
        return phase_table(self.trajectory, self.passes, last_suffixes)


def _max(values) -> Optional[float]:
    values = [v for v in values if v is not None and not math.isnan(v)]
    return max(values) if values else None


def phase_table(trajectory, passes,
                last_suffixes: Sequence[str] = LAST_SUFFIXES) -> Dict[int, dict]:
    """Per phase of a run's record (a ``Recorder``'s ``trajectory`` and ``passes``, or a
    trajectory file's): first and last FID and their relative change; ``steps_per_s``, the
    steps between the phase's passes over their time outside the passes (prefetcher waits
    and host stalls included), with the median of the per-interval rates beside it; the
    peak host RSS (``ru_maxrss``; None where the recorder did not read it) and the largest
    RSS read at a pass; the device's peak; the passes' seconds; the seconds from the first
    reading to the last."""
    first, last = first_last(trajectory, last_suffixes)
    out = {}
    for ph in sorted({p["phase"] for p in passes}):
        ps = [p for p in passes if p["phase"] == ph]
        es = [e for e in trajectory if e["phase"] == ph]
        # a pass's rate covers the images since the pass before it, on the host's clock
        images = seconds = 0.0
        rates = []
        for prev, p in zip(passes, passes[1:]):
            if p["phase"] == ph and p["steps_per_s"] is not None:
                n = p["step"] - prev["step"]
                images += n
                seconds += n / p["steps_per_s"]
                rates.append(p["steps_per_s"])
        cuda = [p["cuda_peak_mib"] for p in ps if p["cuda_peak_mib"] is not None]
        f, l_ = first.get(ph), last.get(ph)
        out[ph] = {"first": f, "last": l_,
                   "rel": (l_ - f) / abs(f) if f is not None and l_ is not None else None,
                   "steps_per_s": images / seconds if seconds else None,
                   "steps_per_s_median": float(np.median(rates)) if rates else None,
                   "rss_peak_mib": _max(p["rss_peak_mib"] for p in ps),
                   "rss_max_at_passes_mib": _max(p["rss_mib"] for p in ps),
                   "rss_mib_first_last": [ps[0]["rss_mib"], ps[-1]["rss_mib"]],
                   "cuda_peak_mib": max(cuda) if cuda else None,
                   "metric_s": sum(p["metric_s"] for p in ps),
                   "wall_s": es[-1]["time"] - es[0]["time"]}
    return out


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Verdict:
    """A gate's reading of a trajectory.  ``clauses``: how each phase passed or failed
    ("improved", "noise", "recovered", "cap", "no recovery", ...)."""

    gate: str
    ok: bool
    failures: List[str]
    first: Dict[int, float]
    last: Dict[int, float]
    improved: int
    n_phases: int
    total_rel: float
    clauses: Dict[int, str]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        rels = {ph: round((self.last[ph] - f) / abs(f), 4)
                for ph, f in self.first.items() if ph in self.last}
        return (f"{self.gate}: {'PASS' if self.ok else 'FAIL'}; phases improved "
                f"{self.improved}/{self.n_phases}; aggregate {self.total_rel:+.3f}; "
                f"relative change per phase {rels}; clauses {self.clauses}"
                + (f"; failures {self.failures}" if self.failures else ""))


def first_last(trajectory, last_suffixes: Sequence[str] = LAST_SUFFIXES):
    """Per phase, the first FID under the training weights and the last FID of a
    phase-ending reading (`last_suffixes`)."""
    first, last = {}, {}
    for e in trajectory:
        if "FID" not in e:
            continue
        ph = e["phase"]
        if e["suffix"] == "" and ph not in first:
            first[ph] = e["FID"]
        if e["suffix"] in last_suffixes:
            last[ph] = e["FID"]
    return first, last


def _readings(trajectory, phase: int) -> List[float]:
    return [e["FID"] for e in trajectory
            if e.get("suffix") == "" and e["phase"] == phase and "FID" in e]


def _improved(first, last) -> int:
    return sum(1 for ph in first if ph in last and last[ph] < first[ph])


def _total_rel(first, last) -> float:
    return sum((last[p] - f) / abs(f) for p, f in first.items() if p in last)


def band_gate(trajectory, require_final_improved: bool = False) -> Verdict:
    """The seed-band gate of the 3-D schedules.  `require_final_improved`: the last
    phase must also end below its first reading (the cubic driver's extra clause)."""
    first, last = first_last(trajectory)
    failures, clauses = [], {}
    if require_final_improved and last:
        final = max(last)
        if not (final in first and last[final] < first[final]):
            failures.append(f"final phase {final} did not improve over its first reading")
    total_rel = 0.0
    for ph, f in first.items():
        l_ = last.get(ph)
        if l_ is None:
            continue
        rel = (l_ - f) / abs(f)
        total_rel += rel
        if l_ < f:
            clauses[ph] = "improved"
            continue
        in_phase = _readings(trajectory, ph)[1:]  # the alpha~1 first reading dropped
        if rel <= NOISE_TOL:
            clauses[ph] = "noise"
        elif rel > REGRESSION_CAP:
            clauses[ph] = "cap"
            failures.append(f"phase {ph} regression {rel:+.2f} exceeds the cap "
                            f"{REGRESSION_CAP}")
        elif in_phase and l_ < min(in_phase):
            clauses[ph] = "recovered"
        else:
            clauses[ph] = "no recovery"
            failures.append(f"phase {ph} regressed {f:.2f} -> {l_:.2f} with no fade "
                            f"recovery (in-phase readings {in_phase})")
    improved, n = _improved(first, last), len(first)
    if improved < (n + 1) // 2:
        failures.append(f"only {improved}/{n} phases improved")
    if not total_rel < 0:
        failures.append(f"aggregate relative change {total_rel:+.3f} is not negative")
    return Verdict("band", not failures, failures, first, last, improved, n, total_rel,
                   clauses)


def caps_gate_2d(trajectory) -> Verdict:
    """The 2-D gate: a regressing phase within its measured cap, a majority improving,
    the aggregate improving."""
    first, last = first_last(trajectory, LAST_SUFFIXES_2D)
    failures, clauses = [], {}
    total_rel = 0.0
    for ph, f in first.items():
        l_ = last.get(ph)
        if l_ is None:
            continue
        rel = (l_ - f) / abs(f)
        total_rel += rel
        if l_ < f:
            clauses[ph] = "improved"
            continue
        cap = NOISE_TOL_PER_PHASE_2D.get(ph, DEFAULT_TOL_2D)
        if rel <= cap:
            clauses[ph] = "within cap"
        else:
            clauses[ph] = "cap"
            failures.append(f"phase {ph} regression {rel:+.3f} exceeds its cap {cap}")
    improved, n = _improved(first, last), len(first)
    if improved < (n + 1) // 2:
        failures.append(f"only {improved}/{n} phases improved")
    if not total_rel < 0:
        failures.append(f"aggregate relative change {total_rel:+.3f} is not negative")
    return Verdict("caps_2d", not failures, failures, first, last, improved, n, total_rel,
                   clauses)


def recovery_gate(trajectory, phase: int) -> Verdict:
    """A chained big-phase leg: the final validation reading beats every in-phase
    reading taken after the leg's first step (the mid-fade peak and the post-fade)."""
    first, last = first_last(trajectory)
    in_phase = [e["FID"] for e in trajectory
                if e.get("suffix") == "" and e["phase"] == phase and e["step"] > 1
                and "FID" in e]
    final = last.get(phase)
    failures = []
    if final is None or not math.isfinite(final):
        failures.append(f"phase {phase}: no finite final reading ({final})")
    elif not in_phase:
        failures.append(f"phase {phase}: no in-phase reading after the first step")
    elif not final < min(in_phase):
        failures.append(f"phase {phase}: final {final:.2f} does not beat the in-phase "
                        f"readings {in_phase} (no recovery from the mixing fade)")
    ok = not failures
    return Verdict("recovery", ok, failures, first, last, _improved(first, last), len(first),
                   _total_rel(first, last), {phase: "recovered" if ok else "no recovery"})


def finite_gate(trajectory, phase: int) -> Verdict:
    """A short leg: its final reading exists and is finite."""
    first, last = first_last(trajectory)
    final = last.get(phase)
    ok = final is not None and math.isfinite(final)
    return Verdict("finite", ok, [] if ok else [f"phase {phase}: final reading {final}"],
                   first, last, _improved(first, last), len(first), _total_rel(first, last),
                   {phase: "finite" if ok else "not finite"})


def smoke_gate(trajectory, last_suffixes: Sequence[str] = LAST_SUFFIXES) -> Verdict:
    """A toy budget (a wiring check): every phase-ending reading is finite."""
    first, last = first_last(trajectory, last_suffixes)
    bad = {p: v for p, v in last.items() if not math.isfinite(v)}
    failures = ([] if last else ["no phase-ending reading"]) + (
        [f"non-finite readings {bad}"] if bad else [])
    return Verdict("smoke", not failures, failures, first, last, _improved(first, last),
                   len(first), _total_rel(first, last),
                   {p: "finite" for p in last if p not in bad})


def trajectory_differences(a, b) -> List[str]:
    """The readings on which two trajectories disagree, over the phases both hold: a
    (phase, step, suffix) one lacks, or any metric value not bit-equal."""
    def key(e):
        return e["phase"], e["step"], e["suffix"]

    common = {e["phase"] for e in a} & {e["phase"] for e in b}
    ia = {key(e): e for e in a if e["phase"] in common}
    ib = {key(e): e for e in b if e["phase"] in common}
    diffs = []
    for k in sorted(set(ia) | set(ib)):
        if k not in ia or k not in ib:
            diffs.append(f"{k}: in one trajectory only")
            continue
        va, vb = ({m: v for m, v in e.items() if m not in ("phase", "step", "suffix", "time")}
                  for e in (ia[k], ib[k]))
        if va != vb:
            diffs.append(f"{k}: {va} != {vb}")
    return diffs


def report(verdict: Verdict, ok_line: str) -> int:
    """Print a verdict; the exit code of a driver whose gate it is."""
    print(verdict.summary(), flush=True)
    if verdict.ok:
        print(ok_line, flush=True)
        return 0
    print(f"GATE FAILED ({verdict.gate}): " + "; ".join(verdict.failures), flush=True)
    return 1


# ---------------------------------------------------------------------------
# the drivers' run and conclusion
# ---------------------------------------------------------------------------


def train(cfg, base: Callable, path: str, device):
    """One ``Trainer`` run of `cfg` on `device` with a ``Recorder`` around the metrics
    callback `base`, its trajectory rewritten to `path`; returns (recorder, wall s)."""
    from saragan_tpu_torch.train.trainer import Trainer

    rec = Recorder(base, path)
    t0 = time.time()
    Trainer(cfg, metrics_callback=rec, verbose=True, prefetch=True, device=device).run()
    return rec, time.time() - t0


def conclude(rec: Recorder, wall: float, verdict: Verdict, ok_line: str, smoke: bool,
             smoke_line: str, last_suffixes: Sequence[str] = LAST_SUFFIXES, **extra) -> int:
    """Write the trajectory file with the per-phase table and the verdict, print both, and
    return the exit code: the gate's, or on a toy budget the smoke gate's (the verdict
    printed, not enforced)."""
    phases = rec.phase_table(last_suffixes)
    rec.write(wall_s=wall, gate=verdict.as_dict(), phases=phases, **extra)
    print("PHASES", json.dumps(phases), flush=True)
    print(f"wall {wall:.0f}s", flush=True)
    if smoke:
        print(verdict.summary(), flush=True)
        return report(smoke_gate(rec.trajectory, last_suffixes), smoke_line)
    return report(verdict, ok_line)


# ---------------------------------------------------------------------------
# flags the drivers share
# ---------------------------------------------------------------------------

# the proxy FID's random-feature width: the JAX runs' 2048, on which the gates were set, or
# a --smoke run's 64
FEATURE_DIM, SMOKE_FEATURE_DIM = 2048, 64


def add_common(parser, seed: Optional[int] = 42):
    if seed is not None:
        parser.add_argument("--seed", type=int, default=seed,
                            help="training seed (init and per-step draws); data stays fixed")
    parser.add_argument("--smoke", action="store_true",
                        help="toy budgets for a wiring check; the quality gate is reported, "
                             "only finiteness is enforced")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; without a GPU this "
                             "raises unless 'cpu' is named)")
    return parser


def feature_dim(args) -> int:
    return SMOKE_FEATURE_DIM if args.smoke else FEATURE_DIM


def main(argv=None) -> int:
    """Print the per-phase table of recorded trajectory files (``python -m
    saragan_tpu_torch.scripts._evidence <trajectory.json>...``), recomputed from their
    ``trajectory`` and ``passes``; ``--2d`` reads the 2-D driver's phase-ending suffixes."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--2d", dest="two_d", action="store_true")
    args = p.parse_args(argv)
    for path in args.files:
        with open(path) as f:
            doc = json.load(f)
        table = phase_table(doc["trajectory"], doc["passes"],
                            LAST_SUFFIXES_2D if args.two_d else LAST_SUFFIXES)
        print(path, json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
