"""The port's serving export (``saragan_tpu_torch/tools/export_model.py``, a
``torch.export`` program) and artifact serving (``tools/serve.py --artifact``) against the
JAX package's StableHLO artifact: an artifact the port exports from the reference's
parameters serves the same volumes for the same seeds (negative ones included) as the
reference's artifact, within rtol = atol = 1e-5 (the reference's own export tolerance,
``tests/test_cli_and_tools.py``); the artifact equals the live generator bit for bit on the
CPU (a style family's noise baked from the seed); the unbaked form takes (params, z); a
latent mismatch raises; a config naming the ``flat`` engine still exports the plain
program; serving an artifact over several devices is refused; the graph holds ATen
operators only; the artifact loads in a process that never imports the package; and the
two CLIs, export then ``serve --artifact`` over HTTP, serve it."""

import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.tools import export_model as ref_export
from saragan_tpu.tools.serve import GeneratorService as RefService
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.core import filter_params
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops.core import LayerNoise
from saragan_tpu_torch.tools import export_model, serve
from saragan_tpu_torch.tools.serve import GeneratorService
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)", starting_phase=2,
           ending_phase=2, latent_dim=8, network_size="xxs")
PHASE, BATCH = 2, 2


@pytest.fixture(scope="module")
def reference_pgan():
    """The reference's pgan at phase 2: its generator params (numpy) and its
    params-baked StableHLO artifact's path."""
    cfg = JaxConfig(architecture="pgan", **CFG).finalize()
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=PHASE, cfg=cfg)
    g = {k: np.asarray(v) for k, v in params.items() if k.startswith("generator")}
    return g, ref_export.export_generator(cfg, PHASE, g, batch_size=BATCH)


def _port_artifact(tmp_path, params, name="pgan", **kw):
    cfg = Config(architecture=name, **CFG).finalize()
    blob = export_model.export_generator(cfg, PHASE, params, batch_size=BATCH, device="cpu",
                                         **kw)
    return export_model.save_exported(str(tmp_path / f"{name}.pt2"), blob)


def test_artifact_serves_the_reference_artifacts_volumes(tmp_path, reference_pgan):
    g, blob = reference_pgan
    ref_path = ref_export.save_exported(str(tmp_path / "g.stablehlo"), blob)
    ref_service = RefService.from_artifact(ref_path)
    service = GeneratorService.from_artifact(_port_artifact(tmp_path, g), device="cpu")
    try:
        assert service.batch_size == ref_service.batch_size == BATCH
        assert service.info["latent_dim"] == 8 and service.info["device"] == "cpu"
        assert service.info["source"] == "torch_export_artifact"
        for num, seed in ((3, 0), (1, 7), (2, -5), (1, -(2 ** 31))):
            got, want = service.generate(num, seed), ref_service.generate(num, seed)
            assert got.shape == want.shape == (num, 1, 8, 8, 8)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        service.close()
        ref_service.close()


@pytest.mark.parametrize("name", ["pgan", "surfgan"])
def test_artifact_equals_the_live_generator(tmp_path, name):
    cfg = Config(architecture=name, **CFG).finalize()
    arch = get_architecture(name)
    g = filter_params(arch.init(torch.Generator().manual_seed(0), phase=PHASE, cfg=cfg,
                                device="cpu"), "generator")
    if name == "surfgan":  # non-zero noise strengths, so the baked noise shows
        g = {k: (torch.full_like(v, 0.3) if "noise_strength" in k else v) for k, v in g.items()}
    gen = export_model.load_exported(_port_artifact(tmp_path, g, name, seed=3), device="cpu")
    assert (gen.batch_size, gen.latent_dim, gen.takes_params) == (BATCH, 8, False)
    z = np.random.default_rng(0).normal(size=(BATCH, 8)).astype(np.float32)
    live_cfg = dataclasses.replace(cfg, fused_transitions=True, use_pallas_fusion=False)
    with torch.no_grad():
        live = arch.generator(g, torch.from_numpy(z), 0.0, phase=PHASE, cfg=live_cfg,
                              train=False, noise=LayerNoise(3))
        other = arch.generator(g, torch.from_numpy(z), 0.0, phase=PHASE, cfg=live_cfg,
                               train=False, noise=LayerNoise(4))
    assert torch.equal(gen(z), live)
    if name == "surfgan":
        assert not torch.equal(live, other)  # the noise is the seed's
    targets = {n.target for n in gen.program.graph.nodes if n.op == "call_function"}
    assert targets and all(isinstance(t, torch._ops.OpOverload) and t.namespace == "aten"
                           for t in targets), targets


def test_unbaked_artifact_takes_params(tmp_path, reference_pgan):
    g, _ = reference_pgan
    baked = export_model.load_exported(_port_artifact(tmp_path, g), device="cpu")
    path = _port_artifact(tmp_path, g, bake_params=False)
    gen = export_model.load_exported(path, device="cpu")
    assert gen.takes_params and (gen.batch_size, gen.latent_dim) == (BATCH, 8)
    z = np.random.default_rng(1).normal(size=(BATCH, 8)).astype(np.float32)
    assert torch.equal(gen(g, z), baked(z))
    with pytest.raises(ValueError, match="params-baked"):
        GeneratorService.from_artifact(path, device="cpu")


def test_latent_mismatch_flat_engine_and_serve_devices_are_refused(tmp_path, reference_pgan):
    g, _ = reference_pgan
    path = _port_artifact(tmp_path, g)
    with pytest.raises(ValueError, match="latent_dim 9"):
        GeneratorService.from_artifact(path, latent_dim=9, device="cpu")
    # a config naming the card's kernels still exports the plain program: the same ATen
    # graph, the same volumes
    flat_cfg = Config(architecture="pgan", conv_engine="flat", **CFG).finalize()
    flat = export_model.load_exported(export_model.save_exported(
        str(tmp_path / "flat.pt2"), export_model.export_generator(
            flat_cfg, PHASE, g, batch_size=BATCH, device="cpu")), device="cpu")
    gen = export_model.load_exported(path, device="cpu")
    z = np.random.default_rng(2).normal(size=(BATCH, 8)).astype(np.float32)
    assert torch.equal(flat(z), gen(z))
    assert ([n.target for n in flat.program.graph.nodes if n.op == "call_function"]
            == [n.target for n in gen.program.graph.nodes if n.op == "call_function"])
    with pytest.raises(ValueError, match="serve_devices"):
        serve.main(["--artifact", path, "--device", "cpu", "--serve_devices", "2"])


_LOAD_ALONE = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)  # the CPU's conv sums in the order of one thread, as the test's
program = torch.export.load(sys.argv[1])
out = program.module()(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.detach().numpy())
assert not [m for m in sys.modules if m.split(".")[0] in ("saragan_tpu_torch", "saragan_tpu")]
print("ok")
"""


def test_artifact_loads_without_the_package(tmp_path, reference_pgan):
    g, _ = reference_pgan
    path = _port_artifact(tmp_path, g)
    z = np.random.default_rng(2).normal(size=(BATCH, 8)).astype(np.float32)
    np.save(tmp_path / "z.npy", z)
    out = subprocess.run([sys.executable, "-c", _LOAD_ALONE, path, str(tmp_path / "z.npy"),
                          str(tmp_path / "out.npy")], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = export_model.load_exported(path, device="cpu")(z).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_export_cli_then_serve_cli_over_http(tmp_path, reference_pgan):
    """``python -m ...export_model`` on a checkpoint, then ``python -m ...serve --artifact``
    in its own process answering over HTTP."""
    g, _ = reference_pgan
    model = ckpt.save_params(str(tmp_path / "model_2"),
                             {k: torch.from_numpy(v.copy()) for k, v in g.items()})
    art = str(tmp_path / "g.pt2")
    export_model.main(["pgan", "--model_path", model, "--out", art, "--phase", "2",
                       "--batch_size", str(BATCH), "--latent_dim", "8", "--start_shape",
                       "(1, 4, 4, 4)", "--final_shape", "(1, 16, 16, 16)", "--network_size",
                       "xxs", "--no_ema", "--device", "cpu"])
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "saragan_tpu_torch.tools.serve",
                             "--artifact", art, "--device", "cpu", "--port", str(port)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(url + "/info", timeout=5) as r:
                    info = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.5)
        assert info["source"] == "torch_export_artifact" and info["batch_size"] == BATCH
        req = urllib.request.Request(url + "/generate",
                                     data=json.dumps({"num_samples": 3, "seed": -4}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            vols = np.load(io.BytesIO(r.read()))
        want = GeneratorService.from_artifact(art, device="cpu")
        try:
            np.testing.assert_array_equal(vols, want.generate(3, -4))
        finally:
            want.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
