"""The port's serving front end on the CPU: the body encoders and the
MicroBatcher (toycrystals_torch/serve.py) and the HTTP server
(toycrystals_torch/scripts/serve_sde_score_model.py), in the pattern of
tests/test_serving.py.

- raw_png_bytes and npy_bytes give the JAX package's bytes for the same
  array, f32 and uint8; grid_png_bytes is the square grid of the quantised
  tiles (the JAX one draws a matplotlib figure; ROADMAP.md section 3).
- The batcher coalesces requests within its window into one dispatch whose
  seed is base_seed + k, and each caller gets its own rows of
  service.sample(concatenated rows, seed=base_seed + k), bit for bit.
- The server answers /healthz, /stats and /sample in every format, 400 on a
  bad body or bad conditions, 404 on an unknown route; a seeded request is
  the service's own dispatch; SIGTERM finishes the request in flight.
- The server on a mesh (--shard 2 on the CPU, two gloo ranks: rank 0 serves,
  rank 1 follows): 8 concurrent seeded requests answer the one-process
  service's dispatch of the same rows; it outlives an idle gap longer than
  its collective timeout (shortened for the test by a launcher script); a
  SIGTERM drains it with every rank at exit 0; a killed follower ends it with
  a non-zero exit, and no rank hangs.
"""

import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from toycrystals_torch import serve
from toycrystals_torch.models import sde_score_model as tm
from toycrystals_torch.scripts import serve_sde_score_model as ssm
from toycrystals_torch.utils.checkpoint import save_checkpoint
from toycrystals_torch.utils.figures import quantize_u8, read_png
from toycrystals_torch.utils.params import flax_from_torch_state_dict
from toycrystals_tpu import serve as jserve

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(n_types=4, y_cont_dim=4, base_ch=8, emb_dim=16, cond_ch=8, time_ch=8, img_size=16,
           beta_min=0.1, beta_max=30.0, dtype="float32", param="eps")


@pytest.fixture(scope="module")
def params():
    torch.manual_seed(0)
    model = tm.CondUNetTiny(4, 4, base_ch=8, emb_dim=16)
    return flax_from_torch_state_dict({k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def svc(params):
    return serve.ScoreModelService(CFG, params, device="cpu", steps=2, buckets=(2, 8))


def _arrays():
    rng = np.random.default_rng(0)
    return {"f32": rng.uniform(size=(5, 8, 8, 1)).astype(np.float32),
            "f32 out of range": rng.uniform(-0.2, 1.2, size=(3, 4, 6)).astype(np.float32),
            "u8": rng.integers(0, 256, size=(7, 8, 6, 1)).astype(np.uint8),
            "one f64 image": rng.uniform(size=(5, 5))}


@pytest.mark.parametrize("name", list(_arrays()))
def test_encoders_give_the_jax_bytes(name):
    x = _arrays()[name]
    for kw in ({}, {"ncols": 2, "pad": 1, "pad_value": 0.5}, {"pad": 0}):
        assert serve.raw_png_bytes(x, **kw) == jserve.raw_png_bytes(x, **kw), kw
    assert serve.npy_bytes(x) == jserve.npy_bytes(x)
    back = np.load(io.BytesIO(serve.npy_bytes(x)))
    np.testing.assert_array_equal(back, x.astype(np.uint8 if x.dtype == np.uint8 else np.float32))


def test_grid_png_bytes_is_the_square_grid_of_the_pixels(tmp_path):
    x = np.random.default_rng(1).uniform(size=(5, 8, 8, 1)).astype(np.float32)
    png = serve.grid_png_bytes(x)
    (tmp_path / "g.png").write_bytes(png)
    img = np.rint(read_png(tmp_path / "g.png") * 255.0).astype(np.uint8)
    assert img.shape == (3 * 10 + 2, 3 * 10 + 2)  # ceil(sqrt(5)) = 3 columns, 2-px gaps
    for i in range(5):
        r, c = divmod(i, 3)
        np.testing.assert_array_equal(img[2 + 10 * r:10 + 10 * r, 2 + 10 * c:10 + 10 * c],
                                      quantize_u8(x[i, ..., 0]))
    assert img[22:, 12:].min() == 255  # the missing sixth cell and the gaps are white
    u8 = quantize_u8(x)
    assert serve.grid_png_bytes(u8) == serve.grid_png_bytes(x)


def test_batcher_coalesces_and_splits_per_caller(svc):
    """Requests within the window (7 rows of an 8-row max_batch) share one
    dispatch with seed base_seed + 1; the next dispatch takes base_seed + 2."""
    mb = serve.MicroBatcher(svc, window_ms=1000, base_seed=40)
    try:
        reqs = [([0], [0.1]), ([1, 2], [0.2, 0.3]), ([3], None), ([2], [0.5]), ([0, 1], 0.7)]
        futs = [mb.submit(t, th) for t, th in reqs]
        outs = [f.result(timeout=60) for f in futs]
        assert mb.stats == {"batched_dispatches": 1, "coalesced_requests": 5,
                            "window_ms": 1000.0, "max_batch": 8}
        conds = [svc.conditions(t, th) for t, th in reqs]
        want = svc.sample(np.concatenate([c[0] for c in conds]),
                          np.concatenate([c[1] for c in conds]), seed=41)
        i = 0
        for (yc, _), out in zip(conds, outs):
            np.testing.assert_array_equal(out, want[i:i + len(yc)])
            i += len(yc)
        second = mb.submit([3, 3], [0.4, 0.6]).result(timeout=60)
        np.testing.assert_array_equal(second, svc.sample(*svc.conditions([3, 3], [0.4, 0.6]),
                                                         seed=42))
    finally:
        mb.close()


def test_batcher_max_batch_bounds_a_dispatch(svc):
    mb = serve.MicroBatcher(svc, window_ms=200, max_batch=2)
    try:
        outs = [f.result(timeout=60) for f in [mb.submit([i % 4]) for i in range(5)]]
        assert all(o.shape == (1, 16, 16, 1) for o in outs)
        assert mb.stats["coalesced_requests"] == 5 and mb.stats["batched_dispatches"] >= 3
    finally:
        mb.close()


def test_batcher_failure_goes_to_every_future(svc, monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("boom")

    mb = serve.MicroBatcher(svc, window_ms=500)
    monkeypatch.setattr(svc, "sample", boom)
    try:
        futs = [mb.submit([i]) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=60)
    finally:
        mb.close()


def test_batcher_drains_on_close_then_refuses(svc):
    mb = serve.MicroBatcher(svc, window_ms=300)
    with pytest.raises(ValueError, match="out of range"):  # validated before the queue
        mb.submit([99])
    futs = [mb.submit([i]) for i in range(3)]
    mb.close(timeout=60)
    assert not mb._worker.is_alive()
    assert all(f.done() for f in futs)
    assert all(f.result().shape == (1, 16, 16, 1) for f in futs)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit([0])
    mb.close()  # idempotent


def test_batcher_close_racing_submits_loses_no_request(svc):
    """16 threads submit while another closes: every request is either
    refused at submit or answered; none is left behind the close."""
    mb = serve.MicroBatcher(svc, window_ms=1)
    futs, refused, lock = [], [0], threading.Lock()
    start = threading.Barrier(17)

    def client(i):
        start.wait(timeout=30)
        for _ in range(5):
            try:
                f = mb.submit([i % 4])
            except RuntimeError:
                with lock:
                    refused[0] += 1
                continue
            with lock:
                futs.append(f)

    def closer():
        start.wait(timeout=30)
        time.sleep(0.002)
        mb.close(timeout=120)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        threads.append(threading.Thread(target=closer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not mb._worker.is_alive()
    assert len(futs) + refused[0] == 80
    assert all(f.done() and f.result().shape == (1, 16, 16, 1) for f in futs)


@pytest.fixture(scope="module")
def server(params):
    svc = serve.ScoreModelService(CFG, params, device="cpu", steps=2, buckets=(2, 8))
    srv = ssm.make_server(svc, port=0, window_ms=50)
    assert srv.daemon_threads is False and isinstance(srv.batcher, serve.MicroBatcher)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://{srv.server_address[0]}:{srv.server_address[1]}", svc, srv.batcher
    srv.shutdown()
    srv.server_close()
    srv.batcher.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, obj, raw=None):
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_healthz_and_stats(server):
    url, svc, _ = server
    code, ctype, body = _get(url + "/healthz")
    assert (code, ctype) == (200, "application/json")
    assert json.loads(body) == {"ok": True, "model": svc.describe()}
    code, _, body = _get(url + "/stats")
    stats = json.loads(body)
    assert set(stats) == {"service", "batcher"}
    assert set(stats["batcher"]) == {"batched_dispatches", "coalesced_requests", "window_ms",
                                     "max_batch"}
    assert stats["service"]["buckets"] == [2, 8] and stats["service"]["device"] == "cpu"


@pytest.mark.parametrize("fmt", ["json", "png", "png_raw", "npy"])
def test_http_seeded_sample_is_the_services_dispatch(server, fmt):
    url, svc, _ = server
    code, ctype, body = _post(url + "/sample", {"types": [0, 3], "thetas": [0.1, 0.4],
                                                "format": fmt, "seed": 7})
    x = svc.sample_conditions([0, 3], [0.1, 0.4], seed=7)
    assert code == 200
    if fmt == "json":
        obj = json.loads(body)
        assert ctype == "application/json" and obj["shape"] == [2, 16, 16, 1]
        np.testing.assert_array_equal(np.asarray(obj["images"], np.float32), x[..., 0])
    elif fmt == "npy":
        assert ctype == "application/octet-stream" and body == serve.npy_bytes(x)
    else:
        enc = serve.grid_png_bytes if fmt == "png" else serve.raw_png_bytes
        assert ctype == "image/png" and body == enc(x)


def test_http_get_query_and_post_query_fallback(server):
    url, svc, _ = server
    code, _, body = _get(url + "/sample?type=1&theta=0.3&n=2&seed=5")
    assert code == 200 and json.loads(body)["shape"] == [2, 16, 16, 1]
    assert _get(url + "/sample?type=1&theta=0.3&n=2&seed=5")[2] == body  # reproducible
    _, ctype, body = _post(url + "/sample?format=npy&seed=3", {"types": [2]})
    assert ctype == "application/octet-stream"
    assert body == serve.npy_bytes(svc.sample_conditions([2], seed=3))
    _, ctype, _ = _post(url + "/sample?format=png", {"types": [0], "format": "json"})
    assert ctype == "application/json"  # the body wins over the query string
    code, ctype, body = _get(url + "/sample?type=0,1,2&format=png_raw")
    assert code == 200 and ctype == "image/png" and body[:4] == b"\x89PNG"


def test_http_concurrent_unseeded_requests_coalesce(server):
    """32 clients at once: each is answered (the listen backlog takes the
    burst) and they share fewer dispatches than requests."""
    url, _, batcher = server
    before = dict(batcher.stats)
    go = threading.Barrier(32)
    results = [None] * 32

    def one(i):
        go.wait(timeout=30)
        results[i] = _post(url + "/sample", {"types": [i % 4], "format": "npy"})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for code, _, body in results:
        x = np.load(io.BytesIO(body))
        assert code == 200 and x.shape == (1, 16, 16, 1) and np.isfinite(x).all()
    after = batcher.stats
    assert after["coalesced_requests"] - before["coalesced_requests"] == 32
    assert after["batched_dispatches"] - before["batched_dispatches"] < 32


@pytest.mark.parametrize("case, code", [
    ("no types", 400), ("bad format", 400), ("bad json", 400), ("type out of range", 400),
    ("not an object", 400), ("unknown GET route", 404), ("unknown POST route", 404)])
def test_http_errors(server, case, code):
    url, _, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        if case == "no types":
            _post(url + "/sample", {"thetas": [0.0]})
        elif case == "bad format":
            _post(url + "/sample", {"types": [0], "format": "gif"})
        elif case == "bad json":
            _post(url + "/sample", None, raw=b"{types")
        elif case == "type out of range":
            _post(url + "/sample", {"types": [7]})
        elif case == "not an object":
            _post(url + "/sample", [0, 1])
        elif case == "unknown GET route":
            _get(url + "/nope")
        else:
            _post(url + "/samples", {"types": [0]})
    assert e.value.code == code
    assert "error" in json.loads(e.value.read())


def test_cli_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="--shard must be >= 0, got -1"):  # before any rank
        ssm.main(["x.msgpack", "--device", "cpu", "--shard", "-1", "--shard-model", "2",
                  "--shard-space", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.main([str(tmp_path / "x.msgpack")])


def test_sigterm_drains_the_request_in_flight(params, tmp_path):
    """A SIGTERM'd server process finishes the request it is sampling, then
    exits 0. The signal goes once /stats shows the batcher's dispatch begun."""
    ckpt = tmp_path / "tiny.msgpack"
    save_checkpoint(ckpt, {"epoch_next": 1, "config": CFG,
                           "state": {"params": params, "ema_params": params}})
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "toycrystals_torch.scripts.serve_sde_score_model",
         str(ckpt), "--device", "cpu", "--port", "0", "--steps", "100", "--buckets", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        url, deadline = None, time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("listening on "):
                url = line.split()[2]
                break
            if proc.poll() is not None:
                pytest.fail(f"server died early:\n{proc.stdout.read()}")
        assert url, "the server never reported its address"
        got = {}

        def request():
            got["resp"] = _post(url + "/sample", {"types": [0, 1], "format": "npy"})

        t = threading.Thread(target=request)
        t.start()
        while time.time() < deadline and \
                json.loads(_get(url + "/stats")[2])["batcher"]["coalesced_requests"] == 0:
            time.sleep(0.01)
        assert json.loads(_get(url + "/stats")[2])["service"]["requests"] == 0  # in flight
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=300)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "draining" in out and "serving stopped" in out, out
    code, _, body = got["resp"]
    assert code == 200 and np.load(io.BytesIO(body)).shape == (2, 16, 16, 1)


# ---------------------------------------------------------------------------
# The server on a 2-rank mesh
# ---------------------------------------------------------------------------

COLLECTIVE_S = 3  # the ranks' collective timeout in these tests


def _launcher(tmp_path):
    """A script that runs the serve CLI with every rank's collective timeout
    at COLLECTIVE_S seconds: spawned ranks import the main module, so its
    top level runs in each of them before the rank joins its group."""
    script = tmp_path / "serve_short_timeout.py"
    script.write_text(
        "from datetime import timedelta\n"
        "from toycrystals_torch.parallel import multihost\n"
        f"multihost.COLLECTIVE_TIMEOUT = timedelta(seconds={COLLECTIVE_S})\n"
        "if __name__ == '__main__':\n"
        "    import sys\n"
        "    from toycrystals_torch.scripts import serve_sde_score_model as cli\n"
        "    sys.exit(cli.main())\n")
    return script


def _start_sharded(params, tmp_path):
    ckpt = tmp_path / "tiny.msgpack"
    save_checkpoint(ckpt, {"epoch_next": 1, "config": CFG,
                           "state": {"params": params, "ema_params": params}})
    proc = subprocess.Popen(
        [sys.executable, "-u", str(_launcher(tmp_path)), str(ckpt), "--device", "cpu",
         "--port", "0", "--steps", "3", "--buckets", "1,4", "--shard", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)))
    # the ranks share the pipe, unbuffered: a line of one may hold another's text
    url, follower, text, deadline = None, None, "", time.time() + 300
    try:
        while time.time() < deadline and (url is None or follower is None):
            text += proc.stdout.readline()
            found = re.search(r"listening on (http://[0-9.]+:[0-9]+)", text)
            url = found and found.group(1)
            found = re.search(r"following rank 0's dispatches \(pid ([0-9]+)\)", text)
            follower = found and int(found.group(1))
            if proc.poll() is not None:
                pytest.fail("server died early:\n" + text + proc.stdout.read())
        assert url and follower, text
    except BaseException:
        _stop(proc)
        raise
    return proc, url, follower


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def sharded(params, tmp_path_factory):
    proc, url, follower = _start_sharded(params, tmp_path_factory.mktemp("sharded"))
    yield proc, url
    _stop(proc)


def _one_process(params, types, thetas, seed, rows):
    """The one-process service's dispatch of a request padded to `rows` (the
    mesh's layout: the bucket, rounded to the data axis)."""
    svc = serve.ScoreModelService(CFG, params, device="cpu", steps=3, buckets=(rows,))
    yc, yv = svc.conditions(types, thetas)
    n = yc.shape[0]
    yc, yv = (np.concatenate([a, np.repeat(a[-1:], rows - n, axis=0)]) for a in (yc, yv))
    with torch.inference_mode():
        x = tm.sample_chunked(svc._dispatch, svc._apply_fn, svc.sde, torch.from_numpy(yc),
                              torch.from_numpy(yv), (rows, 16, 16, 1), seed, chunk=rows)
    return x[:n]


def test_sharded_server_answers_concurrent_requests_as_one_process(params, sharded):
    proc, url = sharded
    stats = json.loads(_get(url + "/stats")[2])["service"]
    assert stats["mesh"] == [2, 1] and stats["buckets"] == [2, 4]
    reqs = [([i % 4], [0.1 * i], 100 + i) if i % 2 else ([i % 4, 3 - i % 4], [0.2, 0.4], 100 + i)
            for i in range(8)]
    got = {}

    def go(i):
        types, thetas, seed = reqs[i]
        got[i] = _post(url + "/sample", {"types": types, "thetas": thetas, "seed": seed,
                                         "format": "npy"})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (types, thetas, seed) in enumerate(reqs):
        code, _, body = got[i]
        assert code == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                      _one_process(params, types, thetas, seed, 2))
    assert proc.poll() is None


def test_sharded_server_outlives_an_idle_gap_beyond_the_collective_timeout(params, sharded):
    proc, url = sharded
    _post(url + "/sample", {"types": [1], "seed": 5, "format": "npy"})
    time.sleep(2 * COLLECTIVE_S)  # the follower waits outside any collective
    code, _, body = _post(url + "/sample", {"types": [2, 0, 1], "seed": 6, "format": "npy"})
    assert code == 200 and proc.poll() is None
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  _one_process(params, [2, 0, 1], None, 6, 4))


def test_sharded_server_drains_on_sigterm_with_every_rank_at_exit_0(sharded):
    proc, url = sharded
    got = {}
    t = threading.Thread(target=lambda: got.update(r=_post(url + "/sample",
                                                          {"types": [0, 1], "format": "npy"})))
    t.start()
    while json.loads(_get(url + "/stats")[2])["batcher"]["coalesced_requests"] == 0:
        time.sleep(0.01)
    start = time.time()
    proc.send_signal(signal.SIGTERM)
    t.join(timeout=120)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out  # the launcher exits 0 only when every rank did
    assert time.time() - start < 60
    assert "draining" in out and "serving stopped" in out, out
    code, _, body = got["r"]
    assert code == 200 and np.load(io.BytesIO(body)).shape == (2, 16, 16, 1)


def test_sharded_server_exits_nonzero_when_a_follower_dies(params, tmp_path):
    proc, url, follower = _start_sharded(params, tmp_path)
    try:
        assert _post(url + "/sample", {"types": [3], "seed": 1, "format": "npy"})[0] == 200
        os.kill(follower, signal.SIGKILL)
        out, _ = proc.communicate(timeout=60)
    finally:
        _stop(proc)
    assert proc.returncode not in (0, None), out
    assert "rank 1 died" in out, out


def test_sharded_server_ranks_exit_when_the_launcher_is_killed(params, tmp_path):
    """A follower waits for work with no deadline: when its launcher is killed
    outright (no SIGTERM to pass on), the ranks end themselves."""
    proc, url, follower = _start_sharded(params, tmp_path)
    proc.kill()
    proc.wait()
    deadline = time.time() + 30
    while time.time() < deadline and Path(f"/proc/{follower}").exists() \
            and "zombie" not in _proc_state(follower):
        time.sleep(0.2)
    assert not Path(f"/proc/{follower}").exists() or "zombie" in _proc_state(follower)


def _proc_state(pid):
    try:
        return Path(f"/proc/{pid}/status").read_text().split("State:")[1].split("\n")[0]
    except (OSError, IndexError):
        return "zombie"
