#!/usr/bin/env python3
"""Serve a trained score model over HTTP, on the GPU.

    python -m toycrystals_torch.scripts.serve_sde_score_model <ckpt> [--port 8700] [--warmup]

Counterpart of scripts/serve_sde_score_model.py: the weights stay on the
device in a `ScoreModelService`, and a `MicroBatcher` coalesces concurrent
requests into shared dispatches. Endpoints:

  GET  /healthz            liveness and the model's description
  GET  /stats              the service's and the batcher's counters
  POST /sample             {"types": [...], "thetas": [...],
                            "format": "json"|"png"|"png_raw"|"npy",
                            "seed": optional int}
  GET  /sample?type=0&theta=0.0&n=36&format=png

--shard N and --shard-space S serve on a (data, space) mesh of N x S ranks
(one process per device, spawned here unless the cluster flags join ranks
started elsewhere; parallel/spatial.py): rank 0 binds the port and holds the
batcher, the others follow its dispatches (`ScoreModelService.follow`), and
each answer is the one-process service's `sample_chunked` at the mesh's
bucket. SIGTERM to this process goes on to rank 0, which drains, stops the
followers, and every rank exits 0; a rank that dies ends the whole server
with a non-zero exit.

png is a square grid (`grid_png_bytes`), png_raw the direct-pixel grid
(`raw_png_bytes`), npy the array itself (float32 in [0, 1], or uint8 in
[0, 255] under --out-dtype uint8). A bad body or bad conditions answer 400,
an unknown route 404. A request without "seed" goes through the batcher
(i.i.d. across dispatches); an explicit "seed" bypasses it and runs one
reproducible dispatch (`ScoreModelService.sample`). SIGTERM stops taking
connections, finishes the requests in flight, and exits 0.

Differences from the JAX CLI: --device defaults to cuda (cpu only when
asked) and never falls back; the service is built by
`ScoreModelService.from_checkpoint(path, ...)`; png is utils/figures.py's PNG
of the pixels, not a matplotlib figure; the listen backlog is 128, not the
stdlib's 5, which resets a burst of concurrent connections. --shard-model M
serves on a --shard x M ("data", "model") mesh (parallel/tensor.py): every
rank holds its block of the weights and runs every dispatch; with
--shard-space too it serves on JAX's 3-D (data, space, model) mesh of
--shard x S x M ranks, rank 0 the one front rank.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from toycrystals_torch.parallel.multihost import is_primary, process_index
from toycrystals_torch.scripts._common import (
    add_device_flag,
    add_parallel_flags,
    init_distributed,
    select_device,
    setup_mesh,
    spawn_shards,
)
from toycrystals_torch.serve import (
    MicroBatcher,
    ScoreModelService,
    grid_png_bytes,
    npy_bytes,
    raw_png_bytes,
)

FORMATS = ("json", "png", "png_raw", "npy")


def _parse_request(handler) -> dict:
    """A sample request from a POST body (query parameters fill in format and
    seed under it) or from a GET query string."""
    q = parse_qs(urlparse(handler.path).query)
    if handler.command == "POST":
        n = int(handler.headers.get("Content-Length") or 0)
        raw = handler.rfile.read(n) if n else b"{}"
        try:
            req = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise ValueError(f"bad JSON body: {e}") from e
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        if "format" in q:
            req.setdefault("format", q["format"][0])
        if "seed" in q:
            req.setdefault("seed", int(q["seed"][0]))
        return req
    req: dict = {}
    n = int(q["n"][0]) if "n" in q else 1
    if "type" in q:
        t = [int(v) for v in q["type"][0].split(",")]
        req["types"] = t * n if len(t) == 1 else t
    else:
        req["types"] = [0] * n
    if "theta" in q:
        th = [float(v) for v in q["theta"][0].split(",")]
        req["thetas"] = th * n if len(th) == 1 else th
    if "seed" in q:
        req["seed"] = int(q["seed"][0])
    if "format" in q:
        req["format"] = q["format"][0]
    return req


def _body(x, fmt: str) -> tuple[bytes, str]:
    if fmt == "png":
        return grid_png_bytes(x), "image/png"
    if fmt == "png_raw":
        return raw_png_bytes(x), "image/png"
    if fmt == "npy":
        return npy_bytes(x), "application/octet-stream"
    return (json.dumps({"shape": list(x.shape), "images": x[..., 0].tolist()}).encode(),
            "application/json")


def make_handler(service: ScoreModelService, batcher: MicroBatcher):
    """The request-handler class, closed over the service and the batcher."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 - requests are not logged
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler's name
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send_json(200, {"ok": True, "model": service.describe()})
            elif path == "/stats":
                self._send_json(200, {"service": service.stats, "batcher": batcher.stats})
            elif path == "/sample":
                self._sample()
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):  # noqa: N802
            if urlparse(self.path).path == "/sample":
                self._sample()
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def _sample(self) -> None:
            try:
                req = _parse_request(self)
                types = req.get("types")
                if types is None:
                    raise ValueError('"types" is required (list of lattice-type ints)')
                fmt = str(req.get("format", "json"))
                if fmt not in FORMATS:
                    raise ValueError(f'format must be json|png|png_raw|npy, got "{fmt}"')
                if "seed" in req:  # reproducible path: a dispatch of its own
                    x = service.sample_conditions(types, req.get("thetas"),
                                                  seed=int(req["seed"]))
                else:  # coalesce with concurrent callers
                    x = batcher.submit(types, req.get("thetas")).result()
            except ValueError as e:
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - answer, and keep the thread serving
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:  # an encoding failure answers 500 like any other, not a reset
                body, ctype = _body(x, fmt)
            except Exception as e:  # noqa: BLE001
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, body, ctype)

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 resets the connections of a burst of
    # concurrent clients before a handler thread can take them
    request_queue_size = 128


def make_server(service: ScoreModelService, host: str = "127.0.0.1", port: int = 0,
                window_ms: float = 5.0) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer over the service; port 0 takes a free port. The
    server carries `.batcher`: after `shutdown()`, call `server_close()` (it
    joins the handler threads) and then `server.batcher.close()`."""
    batcher = MicroBatcher(service, window_ms=window_ms)
    srv = _Server((host, port), make_handler(service, batcher))
    # handler threads are joined at server_close(), so an exit never cuts a
    # dispatch or a write short
    srv.daemon_threads = False
    srv.batcher = batcher
    return srv


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help="score-model checkpoint (.msgpack or reference .pt)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    add_device_flag(p)
    p.add_argument("--sampler", default=None, choices=["ode", "sde", "dpm", "ddim", "rf"],
                   help="default: ddim for distilled checkpoints, rf for --param fm ones, "
                        "else sde")
    p.add_argument("--steps", type=int, default=None,
                   help="default: the student's trained step count, else 300 (rf: 50)")
    p.add_argument("--guidance-scale", type=float, default=None,
                   help="default: 0 for distilled checkpoints (guidance baked in), else 1.5")
    p.add_argument("--t-end", type=float, default=None)
    p.add_argument("--clip-x0", action="store_true")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"])
    p.add_argument("--attn-impl", default="auto", choices=["auto", "xla", "flash"])
    p.add_argument("--quantize", default="none", choices=["none", "int8"],
                   help="int8: dynamic-quantised int8 convs (post-training; any float "
                        "checkpoint serves so)")
    p.add_argument("--out-dtype", default="float32", choices=["float32", "uint8"],
                   help="uint8: quantise samples to u8 on the device (png_raw's rounding); "
                        "npy bodies are then uint8 in [0, 255]")
    p.add_argument("--no-ema", action="store_true", help="serve the raw params")
    p.add_argument("--buckets", default="1,4,16,64",
                   help="batch-shape ladder (comma-separated)")
    p.add_argument("--window-ms", type=float, default=5.0,
                   help="micro-batching coalesce window")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before taking traffic")
    add_parallel_flags(p, train=False)
    return p


def serve(argv: list[str] | None = None) -> int:
    """The server in this process: the whole of it, or one rank of a mesh
    (rank 0 serves HTTP, the others follow)."""
    p = build_parser()
    args = p.parse_args(argv)
    init_distributed(args, args.device)
    device = select_device(args.device)
    mesh = setup_mesh(args.shard, device=device, shard_space=args.shard_space,
                      shard_model=args.shard_model)
    service = ScoreModelService.from_checkpoint(
        args.ckpt, device=device, use_ema=not args.no_ema, sampler=args.sampler,
        steps=args.steps, guidance_scale=args.guidance_scale, t_end=args.t_end,
        clip_x0=args.clip_x0, dtype=args.dtype, attn_impl=args.attn_impl,
        quantize=args.quantize, out_dtype=args.out_dtype,
        buckets=[int(b) for b in args.buckets.split(",")], mesh=mesh)
    if mesh is not None and not is_primary():
        print(f"rank {process_index()}: following rank 0's dispatches (pid {os.getpid()})",
              flush=True)
        service.follow()
        return 0
    if mesh is not None:
        service.lead()
        shape = service.stats["mesh"]  # [D, S], or [D, S, M] with a model axis
        axes = [f"{shape[0]} data"] + [f"{n} {a}" for a, n in zip(("space", "model"), shape[1:])
                                       if n > 1 or a == "space" and len(shape) == 2]
        print(f"mesh: {' x '.join(axes)} ranks; rank 0 serves")
    print(f"model: {service.describe()}")
    print(f"serving: sampler={service.sampler_name} steps={service.steps} "
          f"cfg={service.guidance_scale} buckets={list(service.buckets)} "
          f"quantize={service.quantize} device={service.device}")
    if args.warmup:
        print(f"warmup: buckets {list(service.buckets)} ...")
        service.warmup()

    srv = make_server(service, args.host, args.port, window_ms=args.window_ms)
    print(f"listening on http://{srv.server_address[0]}:{srv.server_address[1]}"
          f"  (POST /sample, GET /healthz, GET /stats)", flush=True)

    def _drain(signum, frame):
        # os.write, not print: the signal may land inside a print of the main thread
        os.write(2, f"\n{signal.Signals(signum).name} received: draining and shutting "
                    f"down\n".encode())
        # shutdown() blocks until serve_forever (on this thread) returns
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        # join the handler threads first: those waiting on a Future resolve as
        # the batcher's worker dispatches them; only then drain the worker
        srv.server_close()
        srv.batcher.close()
        service.stop_followers()
    print("serving stopped (in-flight requests completed)", flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    """The CLI: `serve(argv)` in this process, or in --shard x --shard-space
    (or x --shard-model) spawned ranks."""
    p = build_parser()
    args = p.parse_args(argv)
    if spawn_shards(args, serve, argv, sigterm_rank=0):
        return 0
    return serve(argv)


if __name__ == "__main__":
    sys.exit(main())
