"""HTTP serving endpoint for trained generators (counterpart of
``saragan_tpu/tools/serve.py``).

One process owns the card; one keyed sampler per batch size serves every request.
Concurrent requests are MICRO-BATCHED: a worker thread drains per-sample slots from all
pending requests into one fixed-size device batch, splitting large requests across
dispatches and packing small concurrent ones together.  Sample j of request seed S
depends only on (S, j) (``tools/generate.py::make_keyed_sampler``), so responses are
bit-identical whether a request is served alone or coalesced in the same batch size.

    python -m saragan_tpu_torch.tools.serve pgan --model_path runs/model_6.npz \
        --phase 6 --latent_dim 256 --start_shape "(1, 1, 4, 4)" \
        --final_shape "(1, 128, 512, 512)" --conv_engine flat --port 8753
    python -m saragan_tpu_torch.tools.serve --artifact g.pt2 --port 8753

``--artifact`` serves a params-baked program of ``tools/export_model.py`` (no model code,
no checkpoint); its batch size and latent size come from the program's input signature.

Endpoints:
  GET  /healthz    -> {"status": "ok"}
  GET  /info       -> model/config JSON (shape, batch size, param count, device, engine)
  GET  /stats      -> micro-batching counters
  POST /generate   -> JSON body {"num_samples": N, "seed": S,
                      "format": "npy"|"png", "unnormalize": bool}
                      (N capped by --max_samples; client errors are 400, server
                      faults 500)

``--serve_devices N`` serves a checkpoint on N cards (``cuda:0`` .. ``cuda:N-1``; with
``--device cpu``, N copies on the CPU): the parameters replicated on each, every batch's
rows split between them (``make_keyed_sampler`` over a list of devices), each row still
keyed by its own seed, so the responses equal one device's.  Every bucket batch size must
divide by N, and fewer cards than N raise ``ValueError``, as the reference's does.  An
artifact is one program on one device: ``--artifact`` with ``--serve_devices`` above 1
raises ``ValueError``.
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from saragan_tpu_torch.config import Config
from saragan_tpu_torch.ops.core import Engine
from saragan_tpu_torch.train.summaries import grid_to_uint8, image_grid, png_bytes


class _Ticket:
    """One request's pending samples inside the MicroBatcher."""

    __slots__ = ("seed", "num", "out", "remaining", "event", "error")

    def __init__(self, seed: int, num: int):
        self.seed = int(seed)
        self.num = int(num)
        self.out = [None] * num
        self.remaining = num
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent sample requests into fixed-size device batches.

    Submitters enqueue one slot per sample and block; the worker thread drains up to
    `batch_size` slots per dispatch, across request boundaries, and runs them through
    `run_slots(seeds, idxs)`, which must make output row k depend ONLY on (seeds[k],
    idxs[k]).  A short batch is padded by repeating slot 0 (padding rows are
    discarded).  No batching timer: requests arriving while the card is busy pile up
    and ship together.  One worker thread runs one dispatch at a time.

    A dispatch failure fails every request with a sample in that batch, and still-queued
    slots of those requests are skipped; other requests and the worker survive.

    BUCKETED batching: `run_slots` may be a dict {batch_size: fn}.  Each dispatch drains
    up to max(sizes) slots and picks the bucket that clears them fastest: L slots with
    bucket b take ceil(L/b) dispatches of T_b, the online EMA of that bucket's measured
    dispatch time (each bucket's first call bears kernel compilation and is excluded;
    unmeasured buckets are assumed proportional to their size).  When the winner is
    smaller than the drained queue, one full bucket ships and the rest is requeued at
    the front.
    """

    LAT_EMA = 0.3  # weight of the newest per-bucket latency sample

    def __init__(self, run_slots, batch_size: Optional[int] = None, start: bool = True):
        if callable(run_slots):
            if batch_size is None:
                raise ValueError("batch_size required with a single run_slots")
            run_slots = {int(batch_size): run_slots}
        self._runs = {int(b): fn for b, fn in run_slots.items()}
        self.batch_sizes = sorted(self._runs)
        self.batch_size = self.batch_sizes[-1]  # drain cap per dispatch
        self._lat = {b: None for b in self.batch_sizes}
        self._lat_n = {b: 0 for b in self.batch_sizes}
        self._q = collections.deque()  # (_Ticket, sample_index)
        self._cv = threading.Condition()
        self._closed = False
        self.stats = {
            "requests": 0,
            "samples": 0,
            "batches": 0,
            "padded_slots": 0,
            "max_requests_coalesced": 0,
            "dispatch_sizes": {b: 0 for b in self.batch_sizes},
        }
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-microbatcher")
        if start:
            self._thread.start()

    def start(self):
        if not self._thread.is_alive():
            self._thread.start()

    def submit(self, seed: int, num: int) -> np.ndarray:
        """Block until all `num` samples of request (seed) are generated."""
        if num < 1:  # zero slots would never be dispatched -> eternal wait
            raise ValueError(f"num must be >= 1, got {num}")
        # validated on the submitter's thread: an OverflowError inside the worker would
        # kill the dispatch loop; int32 is the run_slots wire contract
        if not (-(2**31) <= int(seed) < 2**31):
            raise ValueError(f"seed must fit int32, got {seed}")
        ticket = _Ticket(seed, num)
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self.stats["requests"] += 1
            self.stats["samples"] += num
            for j in range(num):
                self._q.append((ticket, j))
            self._cv.notify()
        ticket.event.wait()
        if ticket.error is not None:
            raise ticket.error
        return np.stack(ticket.out)

    def warm(self, rounds: int = 2):
        """Run EVERY bucket directly `rounds` times, bypassing the queue, so each one
        is compiled and its latency EMA seeded (the first call excluded).  Warmup
        through submit() would be rerouted by the cost model and could leave the
        largest bucket cold.  Runs on the caller's thread."""
        for b in self.batch_sizes:
            seeds = np.zeros(b, np.int32)
            idxs = np.arange(b, dtype=np.int32)
            for _ in range(max(1, rounds)):
                t0 = time.perf_counter()
                out = np.asarray(self._runs[b](seeds, idxs), np.float32)
                if out.shape[0] != b:
                    raise ValueError(f"run_slots returned {out.shape[0]} rows, expected {b}")
                dt_ms = (time.perf_counter() - t0) * 1e3
                with self._cv:
                    self._lat_n[b] += 1
                    if self._lat_n[b] >= 2:
                        prev = self._lat[b]
                        self._lat[b] = (dt_ms if prev is None else
                                        prev + self.LAT_EMA * (dt_ms - prev))

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify()
        if self._thread.is_alive():
            self._thread.join(timeout=30)

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                entries = []
                while self._q and len(entries) < self.batch_size:
                    t, j = self._q.popleft()
                    if t.error is None:  # skip slots of already-failed requests
                        entries.append((t, j))
                bucket = self._choose_bucket(len(entries)) if entries else 0
                if bucket and bucket < len(entries):
                    # one full smaller bucket ships now; the tail goes back to the FRONT
                    self._q.extendleft(reversed(entries[bucket:]))
                    entries = entries[:bucket]
                if self._closed and not entries and not self._q:
                    return
            if entries:
                self._dispatch(entries, bucket)

    def _estimate_ms(self, bucket: int) -> float:
        """T_bucket: the measured EMA, else proportional to size scaled by the measured
        buckets' median ms per slot (1.0 when none is measured)."""
        if self._lat[bucket] is not None:
            return self._lat[bucket]
        per_slot = [self._lat[b] / b for b in self.batch_sizes if self._lat[b] is not None]
        scale = float(np.median(per_slot)) if per_slot else 1.0
        return bucket * scale

    def _choose_bucket(self, n_slots: int) -> int:
        """Bucket minimizing T_b * ceil(n/b); ties prefer the larger bucket."""
        return min(self.batch_sizes,
                   key=lambda b: (self._estimate_ms(b) * -(-n_slots // b), -b))

    def _dispatch(self, entries, bucket: int):
        pad = bucket - len(entries)
        error = None
        t0 = time.perf_counter()
        try:
            # any failure here is forwarded to the submitters, never kills the worker
            seeds = np.asarray([t.seed for t, _ in entries] + [entries[0][0].seed] * pad,
                               np.int32)
            idxs = np.asarray([j for _, j in entries] + [entries[0][1]] * pad, np.int32)
            out = np.asarray(self._runs[bucket](seeds, idxs), np.float32)
            if out.shape[0] != bucket:
                raise ValueError(f"run_slots returned {out.shape[0]} rows, expected {bucket}")
        except BaseException as e:  # noqa: BLE001 (forwarded to submitters)
            error = e
        dt_ms = (time.perf_counter() - t0) * 1e3
        done = {}
        for k, (t, j) in enumerate(entries):
            if error is not None:
                t.error = error
            else:
                t.out[j] = out[k]
                t.remaining -= 1
            done[id(t)] = t
        with self._cv:
            self.stats["batches"] += 1
            self.stats["padded_slots"] += pad
            self.stats["dispatch_sizes"][bucket] += 1
            self.stats["max_requests_coalesced"] = max(
                self.stats["max_requests_coalesced"], len(done))
            self._lat_n[bucket] += 1
            if error is None and self._lat_n[bucket] >= 2:
                prev = self._lat[bucket]
                self._lat[bucket] = (dt_ms if prev is None else
                                     prev + self.LAT_EMA * (dt_ms - prev))
        for t in done.values():
            if t.error is not None or t.remaining == 0:
                t.event.set()


def serve_devices(device, n: int) -> list:
    """The devices of ``--serve_devices n``: ``cuda:0`` .. ``cuda:n-1`` for a CUDA
    `device` (``ValueError`` when the machine has fewer cards), else n times `device`."""
    import torch

    if n < 1:
        raise ValueError(f"--serve_devices {n} < 1")
    if n == 1:
        return [device]
    if device.type != "cuda":
        return [device] * n
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--serve_devices {n} > {have} available CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


class GeneratorService:
    """Keyed samplers + their parameters; concurrent requests are micro-batched through
    one worker thread."""

    # cap on num_samples per request: bounds card hold time and host-side accumulation
    DEFAULT_MAX_SAMPLES = 1024

    def __init__(self, run_slots, batch_size: Optional[int] = None,
                 info: Optional[dict] = None, data_mean: Optional[float] = None,
                 data_stddev: Optional[float] = None, max_samples: Optional[int] = None):
        self.info = dict(info or {})
        self.data_mean = data_mean
        self.data_stddev = data_stddev
        self.max_samples = int(max_samples or self.DEFAULT_MAX_SAMPLES)
        self._batcher = MicroBatcher(run_slots, batch_size)
        self.batch_size = self._batcher.batch_size

    @classmethod
    def from_checkpoint(cls, architecture: str, model_path: str, *, cfg: Config, phase: int,
                        batch_size: int = 8, alpha: float = 0.0, use_ema: bool = True,
                        max_samples: Optional[int] = None,
                        batch_sizes: Optional[list] = None,
                        fetch_dtype: Optional[str] = None, n_devices: int = 1,
                        device=None, conv_engine: Engine = "direct"):
        from saragan_tpu_torch._device import resolve_device
        from saragan_tpu_torch.tools.generate import _load_generator_params, make_keyed_sampler

        dev = resolve_device(device)
        devices = serve_devices(dev, n_devices)
        # the family served is `architecture`, whatever family `cfg` names
        cfg = dataclasses.replace(cfg, architecture=architecture)
        g_params, _ = _load_generator_params(model_path, use_ema, dev)
        sizes = sorted({int(b) for b in (batch_sizes or [batch_size])})
        bad = [b for b in sizes if b % n_devices]
        if bad:
            raise ValueError(f"batch sizes {bad} do not divide by --serve_devices {n_devices}")

        def make_run(size: int):
            sampler = make_keyed_sampler(cfg, phase, size, alpha, fetch_dtype=fetch_dtype,
                                         device=devices, conv_engine=conv_engine)

            def run_slots(seeds: np.ndarray, idxs: np.ndarray) -> np.ndarray:
                return sampler(g_params, seeds, idxs).cpu().float().numpy()

            return run_slots

        info = {
            "source": "checkpoint",
            "architecture": architecture,
            "phase": phase,
            "batch_size": sizes[-1],
            "batch_sizes": sizes,
            "latent_dim": cfg.latent_dim,
            "volume_shape": list(cfg.current_shape(phase, 1))[1:],
            "ema": bool(use_ema),
            "fetch_dtype": fetch_dtype or "float32",
            "serve_devices": n_devices,
            "device": str(dev),
            "devices": [str(d) for d in devices],
            "conv_engine": conv_engine if isinstance(conv_engine, str) else vars(conv_engine),
            "num_params": int(sum(v.numel() for v in g_params.values())),
        }
        return cls({size: make_run(size) for size in sizes}, None, info,
                   cfg.data_mean, cfg.data_stddev, max_samples=max_samples)

    @classmethod
    def from_artifact(cls, path: str, latent_dim: Optional[int] = None,
                      data_mean: Optional[float] = None,
                      data_stddev: Optional[float] = None,
                      max_samples: Optional[int] = None, device=None):
        """Serve a params-baked artifact of ``tools.export_model`` (a ``torch.export``
        program) on `device` (the CUDA device unless named)."""
        from saragan_tpu_torch.tools.export_model import load_exported

        gen = load_exported(path, device)
        if gen.takes_params:
            raise ValueError(f"{path} takes (params, z); serving needs a params-baked "
                             f"artifact (export without --no_bake_params)")
        # the artifact's input signature fixes (batch, latent_dim)
        batch_size, art_latent = gen.batch_size, gen.latent_dim
        if latent_dim is not None and latent_dim != art_latent:
            raise ValueError(f"--latent_dim {latent_dim} != artifact's {art_latent}")

        def run_slots(seeds: np.ndarray, idxs: np.ndarray) -> np.ndarray:
            # the artifact's input is the latent batch, so each row's latent is drawn on
            # the host, as the JAX package draws it: z row k from
            # default_rng([seeds[k], idxs[k]]) with both words masked to uint32, so the
            # whole int32 seed range is accepted (negative seeds included) and both
            # packages' artifacts get the same z
            z = np.stack([
                np.random.default_rng(
                    [int(s) & 0xFFFFFFFF, int(j) & 0xFFFFFFFF]
                ).normal(size=art_latent)
                for s, j in zip(seeds, idxs)
            ]).astype(np.float32)
            return gen(z).cpu().float().numpy()

        info = {
            "source": "torch_export_artifact",
            "artifact": path,
            "batch_size": batch_size,
            "latent_dim": art_latent,
            "device": str(gen.device),
        }
        return cls(run_slots, batch_size, info, data_mean, data_stddev,
                   max_samples=max_samples)

    def generate(self, num_samples: int, seed: int = 0,
                 unnormalize: Optional[bool] = None) -> np.ndarray:
        if num_samples < 1:
            raise ValueError("num_samples must be >= 1")
        if num_samples > self.max_samples:
            raise ValueError(f"num_samples {num_samples} > max_samples {self.max_samples} "
                             f"(server cap; raise with --max_samples)")
        vols = self._batcher.submit(seed, num_samples)
        do_unnorm = (self.data_mean is not None and self.data_stddev is not None
                     if unnormalize is None else bool(unnormalize))
        if do_unnorm:
            if self.data_mean is None or self.data_stddev is None:
                raise ValueError("unnormalize requested but --data_mean/--data_stddev unknown")
            from saragan_tpu_torch.data import invert_normalize_numpy

            vols = invert_normalize_numpy(vols, self.data_mean, self.data_stddev)
        return vols

    def warmup(self, rounds: int = 2):
        """Compile and latency-seed every bucket before accepting traffic."""
        self._batcher.warm(rounds)

    @property
    def stats(self) -> dict:
        """Coalescing counters (GET /stats)."""
        return {"batch_size": self.batch_size,
                "batch_sizes": self._batcher.batch_sizes,
                "bucket_ms": {b: (round(v, 2) if v is not None else None)
                              for b, v in self._batcher._lat.items()},
                **self._batcher.stats}

    def close(self):
        self._batcher.close()


def _png_bytes(vols: np.ndarray) -> bytes:
    return png_bytes(grid_to_uint8(image_grid(vols)))


def _npy_bytes(vols: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, vols)
    return buf.getvalue()


def make_server(service: GeneratorService, port: int = 8753,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok"})
            elif self.path == "/info":
                self._send_json(200, service.info)
            elif self.path == "/stats":
                self._send_json(200, service.stats)
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                # request parsing and validation: failures here are the client's
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    num = int(req.get("num_samples", service.batch_size))
                    seed = int(req.get("seed", 0))
                    fmt = req.get("format", "npy")
                    if fmt not in ("npy", "png"):
                        raise ValueError(f"unknown format {fmt!r}")
                except (ValueError, TypeError, json.JSONDecodeError) as e:
                    self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    vols = service.generate(num, seed, req.get("unnormalize"))
                except ValueError as e:  # num_samples/unnormalize validation
                    self._send_json(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                if fmt == "npy":
                    self._send(200, _npy_bytes(vols), "application/octet-stream")
                else:
                    self._send(200, _png_bytes(vols), "image/png")
            except Exception as e:  # server-side fault: 5xx, server stays up
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None):
    import argparse

    from saragan_tpu_torch.tools.generate import add_model_args, config_from_args

    p = argparse.ArgumentParser(description="Serve a trained generator over HTTP")
    p.add_argument("architecture", nargs="?", default=None)
    p.add_argument("--model_path", default=None, help="checkpoint .npz (model_{phase})")
    p.add_argument("--artifact", default=None,
                   help="params-baked .pt2 artifact of tools.export_model")
    add_model_args(p)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batch_sizes", default=None,
                   help="comma list of bucket batch sizes, e.g. '8,32'; overrides "
                        "--batch_size")
    p.add_argument("--fetch_dtype", default=None, choices=[None, "float16", "bfloat16"],
                   help="cast volumes to this dtype on the device before the host fetch "
                        "(half the bytes, about 3 decimal digits; responses stay float32)")
    p.add_argument("--serve_devices", type=int, default=1,
                   help="data-parallel serving over N devices (cuda:0 .. cuda:N-1)")
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--port", type=int, default=8753)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_samples", type=int, default=None,
                   help=f"per-request num_samples cap (default "
                        f"{GeneratorService.DEFAULT_MAX_SAMPLES})")
    args = p.parse_args(argv)

    if args.artifact:
        if args.serve_devices != 1:
            raise ValueError("--serve_devices applies to a checkpoint; an artifact is one "
                             "program on one device")
        service = GeneratorService.from_artifact(
            args.artifact, data_mean=args.data_mean, data_stddev=args.data_stddev,
            max_samples=args.max_samples, device=args.device)
    else:
        if not (args.architecture and args.model_path and args.phase):
            p.error("either --artifact, or <architecture> --model_path --phase")
        sizes = [int(s) for s in args.batch_sizes.split(",")] if args.batch_sizes else None
        service = GeneratorService.from_checkpoint(
            args.architecture, args.model_path, cfg=config_from_args(args), phase=args.phase,
            batch_size=args.batch_size, batch_sizes=sizes, alpha=args.alpha,
            use_ema=not args.no_ema, max_samples=args.max_samples,
            fetch_dtype=args.fetch_dtype, n_devices=args.serve_devices, device=args.device,
            conv_engine=args.conv_engine)
    # compile every bucket before accepting traffic and seed its latency EMA
    service.warmup()
    srv = make_server(service, port=args.port, host=args.host)
    print(f"serving {service.info} on http://{args.host}:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        service.close()


if __name__ == "__main__":
    main()
