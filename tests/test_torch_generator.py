"""The serving slice of the PyTorch port end to end on the CPU: the pgan generator
against the JAX package's generator on the same parameters and latents, then the HTTP
service over a checkpoint written by the JAX package, and the micro-batcher."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import saragan_tpu.ops.core as jax_ops_core
from saragan_tpu.config import Config as JaxConfig
from saragan_tpu.core import filter_params as jax_filter_params
from saragan_tpu.models import get_architecture as jax_arch
from saragan_tpu.train import checkpoint as jax_ckpt
from saragan_tpu_torch.config import Config
from saragan_tpu_torch.convert import params_from_numpy
from saragan_tpu_torch.models import get_architecture
from saragan_tpu_torch.ops import conv3d_flat as cf
from saragan_tpu_torch.ops import fused_bias_act as fba
from saragan_tpu_torch.tools.generate import generate_minimal, main as generate_main
from saragan_tpu_torch.tools.serve import GeneratorService, MicroBatcher, make_server
from saragan_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)

# phase 3 of a (1,1,4,4) start: 1x3x3 kernels at phases 1-2, 3x3x3 at phase 3, as the
# bench configuration has; narrow filters
PHASE3 = dict(architecture="pgan", start_shape="(1, 1, 4, 4)", final_shape="(1, 8, 32, 32)",
              latent_dim=16, filter_spec=[[16, 16], [16, 8], [8, 8]])


@pytest.fixture(scope="module")
def phase3_params():
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=3,
                                   cfg=JaxConfig(**PHASE3).finalize())
    return {k: np.asarray(v) for k, v in jax_filter_params(params, "generator").items()}


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("engine,jax_engine", [("direct", "direct"), ("flat", "pallas")])
@pytest.mark.parametrize("fusion", [True, False], ids=["fused_kernel", "unfused"])
@pytest.mark.parametrize("transitions", [True, False], ids=["fused_tr", "unfused_tr"])
def test_generator_matches_jax(phase3_params, monkeypatch, transitions, fusion, engine,
                               jax_engine, alpha):
    monkeypatch.setattr(jax_ops_core, "CONV3D_ALGORITHM", jax_engine)
    kw = dict(PHASE3, use_pallas_fusion=fusion, fused_transitions=transitions)
    z = np.random.default_rng(1).normal(size=(2, 16)).astype(np.float32)
    ref = np.asarray(jax_arch("pgan").generator(phase3_params, z, alpha, phase=3,
                                                cfg=JaxConfig(**kw).finalize(), train=False))
    plain = cf.conv3d_flat_plain.calls, fba.bias_act_pixelnorm_plain.calls
    ours = get_architecture("pgan").generator(
        params_from_numpy(phase3_params, "cpu"), torch.from_numpy(z), alpha, phase=3,
        cfg=Config(**kw).finalize(), conv_engine=engine)
    assert ours.shape == ref.shape == (2, 1, 4, 16, 16)
    np.testing.assert_allclose(ours.numpy(), ref, **F32)
    # the CPU path runs each kernel's plain version wherever the kernel would run: one
    # conv in generator_in and one (fused transitions) or two per block
    convs = 3 if transitions else 5
    assert (cf.conv3d_flat_plain.calls - plain[0]) == (convs if engine == "flat" else 0)
    assert (fba.bias_act_pixelnorm_plain.calls - plain[1]) == (5 if fusion else 0)


def test_unknown_conv_engine_raises(phase3_params):
    with pytest.raises(ValueError, match="conv engine"):
        get_architecture("pgan").generator(params_from_numpy(phase3_params, "cpu"),
                                           torch.zeros(1, 16), 0.0, phase=3,
                                           cfg=Config(**PHASE3).finalize(), conv_engine="s2d")


# ---------------------------------------------------------------------------
# Serving end to end on the CPU
# ---------------------------------------------------------------------------

SERVE = dict(architecture="pgan", start_shape="(1, 4, 4, 4)", final_shape="(1, 16, 16, 16)",
             latent_dim=8, kernel_spec=[[[], [3, 3, 3]], [[3, 3, 3], [3, 3, 3]]],
             filter_spec=[[8, 8], [8, 8]])


def serve_cfg(**kw):
    return Config(**SERVE, starting_phase=2, ending_phase=2, **kw).finalize()


@pytest.fixture(scope="module")
def checkpoint_path(tmp_path_factory):
    """A phase-2 checkpoint written by the JAX package."""
    cfg = JaxConfig(**SERVE, starting_phase=2, ending_phase=2).finalize()
    params = jax_arch("pgan").init(jax.random.PRNGKey(0), phase=2, cfg=cfg)
    path = str(tmp_path_factory.mktemp("serve") / "model_2")
    jax_ckpt.save_params(path, params, ema=dict(params), meta={"phase": 2})
    return path + ".npz"


def _service(checkpoint_path, **kw):
    kw.setdefault("cfg", serve_cfg())
    kw.setdefault("batch_size", 2)
    return GeneratorService.from_checkpoint("pgan", checkpoint_path, phase=2, device="cpu", **kw)


@pytest.fixture(scope="module")
def server(checkpoint_path):
    service = _service(checkpoint_path, cfg=serve_cfg(data_mean=10.0, data_stddev=4.0))
    srv = make_server(service, port=0)  # 0 -> OS-assigned free port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    service.close()


def _post(url, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_healthz_and_info(server):
    with urllib.request.urlopen(server + "/healthz") as r:
        assert json.loads(r.read())["status"] == "ok"
    with urllib.request.urlopen(server + "/info") as r:
        info = json.loads(r.read())
    assert info["architecture"] == "pgan" and info["phase"] == 2
    assert info["volume_shape"] == [1, 8, 8, 8]
    assert info["device"] == "cpu" and info["conv_engine"] == "direct"
    assert info["num_params"] > 0


def test_generate_npy_shape_and_batching(server):
    # num_samples=3 with batch_size=2 forces two dispatches and a padded slot
    status, ctype, body = _post(server + "/generate",
                                {"num_samples": 3, "seed": 7, "unnormalize": False})
    assert status == 200 and ctype == "application/octet-stream"
    vols = np.load(io.BytesIO(body))
    assert vols.shape == (3, 1, 8, 8, 8) and vols.dtype == np.float32
    assert np.all(np.isfinite(vols))
    _, _, body2 = _post(server + "/generate", {"num_samples": 3, "seed": 7, "unnormalize": False})
    assert body2 == body  # deterministic serving


def test_generate_unnormalizes_by_default(server):
    _, _, raw = _post(server + "/generate", {"num_samples": 2, "seed": 1, "unnormalize": False})
    _, _, un = _post(server + "/generate", {"num_samples": 2, "seed": 1})
    raw_v, un_v = np.load(io.BytesIO(raw)), np.load(io.BytesIO(un))
    np.testing.assert_allclose(un_v, raw_v * 4.0 + 10.0, rtol=1e-5)


def test_generate_png(server):
    status, ctype, body = _post(server + "/generate", {"num_samples": 2, "format": "png"})
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("body,needle", [
    ({"num_samples": 2, "format": "gif"}, "unknown format"),
    ({"num_samples": 0}, "num_samples"),
    ({"num_samples": 10**9}, "max_samples"),
    ({"num_samples": "many"}, "ValueError"),
], ids=["format", "zero", "over_cap", "not_int"])
def test_generate_bad_request_is_400(server, body, needle):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/generate", body)
    assert e.value.code == 400
    assert needle in json.loads(e.value.read())["error"]


def test_server_fault_is_500():
    def broken_run_slots(seeds, idxs):
        raise RuntimeError("device lost")

    service = GeneratorService(broken_run_slots, 2, {"source": "test"})
    srv = make_server(service, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"http://127.0.0.1:{srv.server_address[1]}/generate", {"num_samples": 1})
        assert e.value.code == 500
        assert "device lost" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        service.close()


def test_seed_streams_do_not_overlap(server):
    _, _, a = _post(server + "/generate", {"num_samples": 4, "seed": 7, "unnormalize": False})
    _, _, b = _post(server + "/generate", {"num_samples": 2, "seed": 8, "unnormalize": False})
    assert not np.allclose(np.load(io.BytesIO(a))[2:4], np.load(io.BytesIO(b)))


def test_service_responses_invariant_under_coalescing(server):
    """A request's payload is byte-identical served alone or fired concurrently with
    other seeds: per-sample latents and row-independent kernels."""
    solo = {}
    for seed in (7, 8, 9, 10):
        _, _, solo[seed] = _post(server + "/generate",
                                 {"num_samples": 3, "seed": seed, "unnormalize": False})
    concurrent = {}

    def client(seed):
        _, _, concurrent[seed] = _post(server + "/generate",
                                       {"num_samples": 3, "seed": seed, "unnormalize": False})

    threads = [threading.Thread(target=client, args=(s,)) for s in (7, 8, 9, 10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert concurrent == solo


def test_stats_endpoint(server):
    _post(server + "/generate", {"num_samples": 1, "seed": 3})
    with urllib.request.urlopen(server + "/stats") as r:
        stats = json.loads(r.read())
    assert stats["batch_size"] == 2
    assert stats["requests"] >= 1 and stats["samples"] >= 1 and stats["batches"] >= 1
    assert 0 <= stats["padded_slots"] < stats["batches"] * stats["batch_size"]


def test_bucketed_service_matches_single_bucket(checkpoint_path):
    small = _service(checkpoint_path)
    bucketed = _service(checkpoint_path, batch_sizes=[2, 4])
    try:
        assert bucketed.batch_size == 4 and bucketed.info["batch_sizes"] == [2, 4]
        a = small.generate(5, seed=11, unnormalize=False)
        b = bucketed.generate(5, seed=11, unnormalize=False)  # one 4- and one 2-dispatch
        np.testing.assert_array_equal(a, b)
        assert bucketed.stats["dispatch_sizes"][4] >= 1
    finally:
        small.close()
        bucketed.close()


def test_flat_engine_service_matches_direct(checkpoint_path):
    direct = _service(checkpoint_path)
    flat = _service(checkpoint_path, conv_engine="flat")
    try:
        assert flat.info["conv_engine"] == "flat"
        np.testing.assert_allclose(flat.generate(3, seed=2, unnormalize=False),
                                   direct.generate(3, seed=2, unnormalize=False), **F32)
    finally:
        direct.close()
        flat.close()


def test_fetch_dtype_float16_service(checkpoint_path):
    exact = _service(checkpoint_path)
    f16 = _service(checkpoint_path, fetch_dtype="float16")
    try:
        assert f16.info["fetch_dtype"] == "float16"
        a = exact.generate(3, seed=5, unnormalize=False)
        b = f16.generate(3, seed=5, unnormalize=False)
        assert b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
        assert not np.array_equal(a, b)  # it really did round through f16
    finally:
        exact.close()
        f16.close()


def test_service_warmup_seeds_all_buckets(checkpoint_path):
    service = _service(checkpoint_path, batch_sizes=[2, 4])
    try:
        service.warmup()
        assert all(v is not None for v in service._batcher._lat.values())
    finally:
        service.close()


def test_unported_serving_options_raise(checkpoint_path):
    """Data-parallel serving is ported: two devices (two CPU copies here) serve every
    response bit-equal to one device's, and a bucket that does not split over them
    raises."""
    one, two = _service(checkpoint_path, batch_size=4), _service(checkpoint_path, batch_size=4,
                                                                  n_devices=2)
    try:
        assert two.info["serve_devices"] == 2 and two.info["devices"] == ["cpu", "cpu"]
        np.testing.assert_array_equal(two.generate(5, seed=3), one.generate(5, seed=3))
    finally:
        one.close()
        two.close()
    with pytest.raises(ValueError, match="divide"):
        _service(checkpoint_path, batch_sizes=[2, 3], n_devices=2)


def test_generate_minimal_writes_unnormalized_volumes(checkpoint_path, tmp_path):
    paths = generate_minimal("pgan", checkpoint_path, str(tmp_path / "a"), cfg=serve_cfg(),
                             phase=2, num_samples=3, data_mean=1.0, data_stddev=2.0,
                             device="cpu")
    vols = [np.load(p) for p in paths]
    assert len(vols) == 3 and all(v.shape == (8, 8, 8) and np.all(np.isfinite(v)) for v in vols)


def test_generate_cli_minimal(tmp_path):
    cli = ["--phase", "1", "--latent_dim", "8", "--start_shape", "(1, 2, 2, 2)",
           "--final_shape", "(1, 4, 4, 4)", "--network_size", "xxs", "--device", "cpu"]
    cfg = Config(start_shape="(1, 2, 2, 2)", final_shape="(1, 4, 4, 4)", latent_dim=8,
                 network_size="xxs").finalize()
    params = get_architecture("pgan").init(torch.Generator().manual_seed(0), phase=1, cfg=cfg,
                                           device="cpu")
    model = ckpt.save_params(str(tmp_path / "model_1"), params, ema=params)
    generate_main(["pgan", "unused", model, str(tmp_path / "out"), "--minimal",
                   "--num_samples", "2", *cli])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["fake_0000.npy",
                                                                    "fake_0001.npy"]
    # without --minimal: the report over the phase's real volumes (2x2x2 here: FID only,
    # the SWD and SSIM size gates keep those off)
    data = tmp_path / "data" / "2x2"
    data.mkdir(parents=True)
    for i in range(3):
        np.save(data / f"{i}.npy", np.random.default_rng(i).normal(size=(2, 2, 2)))
    generate_main(["pgan", str(tmp_path / "data"), model, str(tmp_path / "report"),
                   "--num_samples", "2", "--batch_size", "2", "--compute_psnrs",
                   "--compute_mses", *cli])
    assert sorted(p.name for p in (tmp_path / "report").iterdir()) == [
        "fake_0000.png", "fake_0000_0.npy", "fake_0000_1.npy", "real_0000.png", "summary.txt"]
    summary = (tmp_path / "report" / "summary.txt").read_text().split()
    assert summary[0::2] == ["psnr:", "mse:"] and all(np.isfinite(float(v))
                                                       for v in summary[1::2])


# ---------------------------------------------------------------------------
# Micro-batching (MicroBatcher): row k depends only on (seeds[k], idxs[k])
# ---------------------------------------------------------------------------

def _slot_oracle(seeds, idxs):
    vals = np.asarray(seeds, np.float32) * 1000 + np.asarray(idxs, np.float32)
    return np.tile(vals[:, None, None, None, None], (1, 1, 2, 2, 2))


def _expected(seed, num):
    return _slot_oracle(np.full(num, seed, np.int32), np.arange(num, dtype=np.int32))


def _wait_queue(mb, n):
    for _ in range(200):
        if len(mb._q) == n:
            return
        time.sleep(0.01)
    raise AssertionError(f"queue holds {len(mb._q)} slots, expected {n}")


def test_microbatcher_coalesces_concurrent_requests():
    calls = []

    def run(seeds, idxs):
        calls.append((list(seeds), list(idxs)))
        return _slot_oracle(seeds, idxs)

    mb = MicroBatcher(run, batch_size=4, start=False)
    results = {}
    threads = [threading.Thread(target=lambda s=s: results.__setitem__(s, mb.submit(s, 2)))
               for s in (1, 2)]
    for t in threads:
        t.start()
    _wait_queue(mb, 4)  # both requests queued before the worker starts: one batch
    mb.start()
    for t in threads:
        t.join(timeout=10)
    assert len(calls) == 1
    np.testing.assert_array_equal(results[1], _expected(1, 2))
    np.testing.assert_array_equal(results[2], _expected(2, 2))
    assert (mb.stats["batches"], mb.stats["padded_slots"], mb.stats["max_requests_coalesced"]) \
        == (1, 0, 2)
    mb.close()


def test_microbatcher_pads_and_splits():
    sizes = []

    def run(seeds, idxs):
        sizes.append(len(seeds))
        return _slot_oracle(seeds, idxs)

    mb = MicroBatcher(run, batch_size=2)
    np.testing.assert_array_equal(mb.submit(5, 1), _expected(5, 1))  # 1 padded slot
    np.testing.assert_array_equal(mb.submit(6, 5), _expected(6, 5))  # 3 batches, 1 padded
    assert all(s == 2 for s in sizes)
    assert mb.stats["batches"] == 4 and mb.stats["padded_slots"] == 2
    mb.close()


def test_microbatcher_error_fails_batch_but_survives():
    state = {"fail": True}

    def run(seeds, idxs):
        if state["fail"]:
            raise RuntimeError("device lost")
        return _slot_oracle(seeds, idxs)

    mb = MicroBatcher(run, batch_size=4, start=False)
    errors = {}

    def client(seed, num):
        try:
            mb.submit(seed, num)
        except RuntimeError as e:
            errors[seed] = str(e)

    # seed 1 spans two batches: the failed first dispatch fails both coalesced requests
    # and seed 1's remaining 2 slots are skipped
    threads = [threading.Thread(target=client, args=(1, 6)),
               threading.Thread(target=client, args=(2, 2))]
    for t in threads:
        t.start()
    _wait_queue(mb, 8)
    mb.start()
    for t in threads:
        t.join(timeout=10)
    assert errors == {1: "device lost", 2: "device lost"}
    state["fail"] = False
    np.testing.assert_array_equal(mb.submit(3, 3), _expected(3, 3))
    mb.close()


@pytest.mark.parametrize("seed,num,match", [
    (1, 0, "num"), (1, -3, "num"), (2**31, 1, "int32"), (-(2**31) - 1, 1, "int32"),
], ids=["zero", "negative", "above_int32", "below_int32"])
def test_microbatcher_rejects_bad_submissions(seed, num, match):
    """Rejected on the submitter's thread; the worker keeps serving, boundary seeds too."""
    mb = MicroBatcher(_slot_oracle, batch_size=2)
    with pytest.raises(ValueError, match=match):
        mb.submit(seed, num)
    np.testing.assert_array_equal(mb.submit(2**31 - 1, 1), _expected(2**31 - 1, 1))
    np.testing.assert_array_equal(mb.submit(-(2**31), 1), _expected(-(2**31), 1))
    mb.close()


def test_microbatcher_bucketed_dispatch():
    sizes = []

    def make_run(b):
        def run(seeds, idxs):
            assert len(seeds) == b
            sizes.append(b)
            return _slot_oracle(seeds, idxs)
        return run

    mb = MicroBatcher({2: make_run(2), 4: make_run(4)})
    assert mb.batch_size == 4  # drain cap = largest bucket
    np.testing.assert_array_equal(mb.submit(5, 1), _expected(5, 1))
    assert sizes == [2]  # a solo slot ships in the small bucket, 1 padded
    np.testing.assert_array_equal(mb.submit(6, 6), _expected(6, 6))
    assert sizes == [2, 4, 2]  # 6 slots -> 4-bucket + 2-bucket, no padding
    assert mb.stats["padded_slots"] == 1 and mb.stats["dispatch_sizes"] == {2: 2, 4: 1}
    mb.close()


@pytest.mark.parametrize("small_ms,expected_sizes,padded", [
    (20.0, [2, 2, 2], 0),  # 3 * 20 < 77.7: three full small dispatches
    (30.0, [8], 2),        # 3 * 30 > 77.7: one padded large dispatch
], ids=["fast_small_bucket", "slow_small_bucket"])
def test_microbatcher_cost_aware_bucket_choice(small_ms, expected_sizes, padded):
    sizes = []

    def make(b):
        def run(seeds, idxs):
            sizes.append(b)
            return _slot_oracle(seeds, idxs)
        return run

    mb = MicroBatcher({2: make(2), 8: make(8)}, start=False)
    mb._lat.update({2: small_ms, 8: 77.7})
    mb._lat_n.update({2: 2, 8: 2})
    mb.start()
    np.testing.assert_array_equal(mb.submit(7, 6), _expected(7, 6))
    assert sizes == expected_sizes
    assert mb.stats["padded_slots"] == padded
    mb.close()


def test_microbatcher_records_bucket_latency_after_first_call():
    mb = MicroBatcher({2: _slot_oracle})
    mb.submit(1, 2)  # first dispatch bears compilation: not recorded
    assert mb._lat[2] is None
    mb.submit(1, 2)
    assert mb._lat[2] is not None and mb._lat[2] >= 0.0
    mb.close()


def test_microbatcher_warm_seeds_every_bucket():
    sizes = []

    def make_run(b):
        def run(seeds, idxs):
            assert len(seeds) == b
            sizes.append(b)
            return _slot_oracle(seeds, idxs)
        return run

    mb = MicroBatcher({2: make_run(2), 4: make_run(4), 8: make_run(8)})
    mb.warm()
    assert sizes == [2, 2, 4, 4, 8, 8]
    assert all(mb._lat[b] is not None and mb._lat_n[b] == 2 for b in (2, 4, 8))
    np.testing.assert_array_equal(mb.submit(9, 3), _expected(9, 3))
    mb.close()
