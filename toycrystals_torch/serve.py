"""Serving runtime for the VP-SDE score model, in PyTorch.

Counterpart of toycrystals_tpu/serve.py:ScoreModelService. The weights go
onto the device once; each request is padded on the host to the nearest
batch bucket, sampled in one call and trimmed; a request beyond the top
bucket runs in top-bucket chunks (`sample_chunked`). Settings left `None`
resolve from the checkpoint config exactly as the JAX service does: a
distilled student serves with DDIM at its trained steps and t_end with its
baked-in guidance, a rectified-flow (`param` fm) model with the rf sampler at
50 steps on its `fm_shift` grid, a v-prediction model is wrapped to eps, and
anything else serves the reference settings (reverse SDE, 300 steps, CFG
1.5, t_end 0.005).

One deliberate difference: the JAX service caps its bucket ladder by
`auto_chunk`, because its backend kills a dispatch that runs longer than a
minute or two. A CUDA device has no such limit, so this service keeps the
buckets it is given.

`ScoreModelService.from_checkpoint(path)` serves a checkpoint of either
package's trainer (msgpack) or a reference `.pt`, as the JAX service does from
its `ckpt_path` (kept as `service.ckpt_path`). `quantize="int8"` serves every
conv of the U-Net as the dynamic int8 conv of ops/conv.py.

A dispatch is `sampler_callable(batch)`, a function of the conditions and
the noise, run on the draws of a generator seeded by the request's seed
(`draw_noise`, in the order and at the time the sampler itself would draw
them).
toycrystals_torch/export.py exports that same function.

`MicroBatcher` coalesces concurrent requests into shared dispatches, and
`grid_png_bytes`, `raw_png_bytes` and `npy_bytes` encode a response body;
scripts/serve_sde_score_model.py puts them behind HTTP. `grid_png_bytes`
differs from JAX's on purpose: JAX draws a matplotlib figure with a frame and
a title, which the card machine cannot, so this writes utils/figures.py's PNG
of the pixels and takes no title. `raw_png_bytes` and `npy_bytes` give JAX's
bytes.

On a mesh (`mesh=`: the ("data",), ("data", "space"), ("data", "model") or
("data", "space", "model") mesh of parallel/mesh.py, one rank per device)
every rank holds the weights
(on a model axis its block of them, parallel/tensor.py), the buckets round
up to multiples of the data axis, and every request runs through
`sample_chunked` at its bucket, as JAX's does: each rank samples its rows of
the batch and of the image height (the model ranks of a (data, space)
coordinate the same rows, each with its channels), and every rank returns
the whole result. `sample` is then collective: every rank calls it with the same
arguments. A server puts one rank in front (`lead`, rank 0, with the
`MicroBatcher` and the HTTP front end) and the others in `follow`: rank 0
announces each dispatch's (n, seed, y_cat, y_cont) on the process group's
store and the followers run the same `sample`. A follower waits for the next
announcement on the store, outside any collective, so an idle server never
meets the collectives' timeout; `stop_followers` ends their loops.
"""

from __future__ import annotations

import io
import math
import pickle
import queue
import threading
import time
from datetime import timedelta
from concurrent.futures import Future
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from toycrystals_torch.models.flow_matching import sample_rectified_flow
from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    eps_apply_from_v,
    sample_chunked,
    draw_sampler_noise,
    sample_ddim,
    sample_dpmpp_2m,
    sample_probability_flow_ode,
    sample_reverse_sde_euler_maruyama,
)
from toycrystals_torch.parallel import spatial
from toycrystals_torch.parallel.mesh import AXIS, MODEL, SPACE, axis_size, check_data_mesh
from toycrystals_torch.utils.figures import _grid_png, png_gray
from toycrystals_torch.utils.params import load_flax_params

DEFAULT_BUCKETS = (1, 4, 16, 64)

_REFERENCE_SERVE = {"sampler": "sde", "steps": 300,
                    "guidance_scale": 1.5, "t_end": 0.005}

_SAMPLERS = {"sde": sample_reverse_sde_euler_maruyama,
             "ode": sample_probability_flow_ode,
             "dpm": sample_dpmpp_2m,
             "ddim": sample_ddim,
             "rf": sample_rectified_flow}

# a follower's wait for rank 0's next announcement, re-armed until it comes
_FOLLOW_POLL = timedelta(seconds=1)
_ANNOUNCE_KEY = "toycrystals/serve/{}"


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no GPU raises
    (nothing moves to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


def load_score_payload(ckpt_path: str) -> dict[str, Any]:
    """Read a score-model checkpoint: msgpack of either package's trainer or a
    reference `.pt` (utils/checkpoint.py)."""
    from toycrystals_torch.utils.checkpoint import load_score_payload as _load

    return _load(ckpt_path)


class ScoreModelService:
    """Device-resident sampling service with fixed batch buckets.

    config: the checkpoint's config dict (n_types, y_cont_dim, base_ch,
    emb_dim, cond_ch, time_ch, and optionally stem, dtype, img_size, param,
    beta_min/beta_max/logsnr_shift, distilled/distill_steps/distill_t_end).
    params / ema_params: flax-layout CondUNetTiny param trees (numpy leaves);
    the EMA tree serves when `use_ema` and it is given.
    """

    def __init__(
        self,
        config: Mapping[str, Any],
        params: Mapping[str, Any],
        *,
        ema_params: Mapping[str, Any] | None = None,
        device: str | torch.device = "cuda",
        use_ema: bool = True,
        sampler: str | None = None,
        steps: int | None = None,
        guidance_scale: float | None = None,
        t_end: float | None = None,
        clip_x0: bool = False,
        dtype: str = "auto",
        attn_impl: str = "auto",
        quantize: str = "none",
        out_dtype: str = "float32",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.ckpt_path: str | None = None  # set by from_checkpoint
        cfg = dict(config)
        self.config = cfg
        if use_ema and ema_params is not None:
            params = ema_params

        distilled = bool(cfg.get("distilled"))
        param = str(cfg.get("param", "eps"))
        flow = param == "fm"
        if sampler is None:
            sampler = ("ddim" if distilled else
                       "rf" if flow else _REFERENCE_SERVE["sampler"])
        if flow and sampler != "rf":
            raise ValueError(f"sampler {sampler!r} expects a VP eps/v model; this checkpoint "
                             "was trained with param fm (rectified flow): serve with "
                             "sampler='rf'")
        if not flow and sampler == "rf":
            raise ValueError(f"sampler 'rf' integrates a rectified-flow velocity field; this "
                             f"checkpoint was trained with param {param}")
        if sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be one of {sorted(_SAMPLERS)}, got {sampler!r}")
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
        if mesh is not None:
            check_data_mesh(mesh, space=True, model=True)
        if out_dtype not in ("float32", "uint8"):
            raise ValueError(f"out_dtype must be 'float32' or 'uint8', got {out_dtype!r}")
        if steps is None:
            steps = (int(cfg["distill_steps"]) if distilled else
                     50 if flow else _REFERENCE_SERVE["steps"])
        if t_end is None:
            t_end = float(cfg["distill_t_end"]) if distilled else _REFERENCE_SERVE["t_end"]
        if guidance_scale is None:
            # distilled students bake their guidance in
            guidance_scale = 0.0 if distilled else _REFERENCE_SERVE["guidance_scale"]
        self.sampler_name = str(sampler)
        self.steps = int(steps)
        self.guidance_scale = float(guidance_scale)
        self.t_end = float(t_end)
        self.clip_x0 = bool(clip_x0)
        self.quantize = str(quantize)
        self.out_dtype = str(out_dtype)

        dtype_name = str(cfg.get("dtype", "float32")) if dtype == "auto" else dtype
        self.n_types = int(cfg["n_types"])
        self.y_cont_dim = int(cfg["y_cont_dim"])
        self.img_size = int(cfg.get("img_size", 64))
        self.mesh = mesh
        if mesh is not None and axis_size(mesh, SPACE) > 1:
            spatial.check_stem_divisibility(self.img_size, axis_size(mesh, SPACE),
                                            str(cfg.get("stem", "none")))
        model = CondUNetTiny(
            n_types=self.n_types, y_cont_dim=self.y_cont_dim,
            base_ch=int(cfg["base_ch"]), emb_dim=int(cfg["emb_dim"]),
            cond_ch=int(cfg["cond_ch"]), time_ch=int(cfg["time_ch"]),
            dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
            attn_impl=attn_impl, stem=str(cfg.get("stem", "none")),
            conv_impl="int8" if quantize == "int8" else "pad",
        )
        load_flax_params(model, params)
        self.model = model.to(self.device).eval().requires_grad_(False)
        if mesh is not None and axis_size(mesh, MODEL) > 1:
            from toycrystals_torch.parallel.tensor import shard_params

            shard_params(self.model, mesh)
        self.sde = VPSDE(
            beta_min=float(cfg.get("beta_min", 0.1)),
            beta_max=float(cfg.get("beta_max", 30.0)),
            logsnr_shift=float(cfg.get("logsnr_shift", 0.0)),
        )
        apply_fn = self.model
        self._extra_kw: dict[str, Any] = {}
        if self.sampler_name == "ddim":
            # ddim reads the raw net output itself (v is its well-conditioned route)
            self._extra_kw["prediction"] = param
        elif self.sampler_name == "rf":
            # an fm checkpoint samples on the shifted grid it trained for
            if float(cfg.get("fm_shift", 1.0)) != 1.0:
                self._extra_kw["t_shift"] = float(cfg["fm_shift"])
        elif param == "v":
            apply_fn = eps_apply_from_v(self.sde, apply_fn)
        self._apply_fn = apply_fn
        self._sampler_fn = _SAMPLERS[self.sampler_name]
        if out_dtype == "uint8":
            # quantise on the device: the pull to the host shrinks 4x
            inner = self._sampler_fn

            def _quantized(*args, **kw):
                return (inner(*args, **kw) * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)

            self._sampler_fn = _quantized

        mult = 1 if mesh is None else axis_size(mesh, AXIS)
        self.buckets = tuple(sorted({-(-max(1, int(b)) // mult) * mult for b in buckets}))
        self._lock = threading.Lock()  # one sampling call at a time per device
        self._store = None  # rank 0 of a served mesh: where dispatches are announced
        self._announced = 0
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "images": 0, "dispatches": 0}

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, **kw) -> "ScoreModelService":
        """The service of a self-describing checkpoint (its config, params and
        EMA); `kw` as for the constructor."""
        payload = load_score_payload(ckpt_path)
        cfg = payload.get("config")
        if not cfg:
            raise ValueError(f"{ckpt_path} has no embedded config; serving needs a "
                             "self-describing checkpoint (any trainer's output, or a "
                             "reference .pt)")
        state = payload["state"]
        service = cls(cfg, state["params"], ema_params=state.get("ema_params"), **kw)
        service.ckpt_path = str(ckpt_path)
        return service

    @property
    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
        s.update(buckets=list(self.buckets), sampler=self.sampler_name,
                 steps=self.steps, guidance_scale=self.guidance_scale,
                 t_end=self.t_end, img_size=self.img_size,
                 distilled=bool(self.config.get("distilled")),
                 quantize=self.quantize, out_dtype=self.out_dtype,
                 device=str(self.device),
                 mesh=None if self.mesh is None else self._mesh_shape())
        return s

    def _mesh_shape(self) -> list[int]:
        """[data, space] ranks, and the model ranks after them on a model axis."""
        shape = [axis_size(self.mesh, AXIS), axis_size(self.mesh, SPACE)]
        return shape + [axis_size(self.mesh, MODEL)] * (axis_size(self.mesh, MODEL) > 1)

    def describe(self) -> dict[str, Any]:
        keep = ("n_types", "y_cont_dim", "base_ch", "emb_dim", "param",
                "dtype", "img_size", "distilled", "distill_steps")
        return {k: self.config[k] for k in keep if k in self.config}

    def _pick_bucket(self, n: int) -> int:
        """The smallest bucket that holds n rows; the top one beyond it."""
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def conditions(self, types, thetas=None):
        """(y_cat, y_cont) rows from lattice types and rotation angles, in
        numpy. Scalars broadcast; theta lands at index 1 of y_cont."""
        y_cat = np.atleast_1d(np.asarray(types, np.int32))
        if thetas is None:
            thetas = np.zeros((y_cat.shape[0],), np.float32)
        th = np.atleast_1d(np.asarray(thetas, np.float32))
        n = max(y_cat.shape[0], th.shape[0])
        if y_cat.shape[0] == 1:
            y_cat = np.repeat(y_cat, n, axis=0)
        if th.shape[0] == 1:
            th = np.repeat(th, n, axis=0)
        if y_cat.shape[0] != th.shape[0]:
            raise ValueError(f"types ({y_cat.shape[0]}) and thetas "
                             f"({th.shape[0]}) do not broadcast")
        if n == 0:
            raise ValueError("empty request: need at least one lattice type")
        if int(y_cat.max()) >= self.n_types or int(y_cat.min()) < 0:
            raise ValueError(f"lattice type out of range [0, {self.n_types})")
        y_cont = np.zeros((n, self.y_cont_dim), np.float32)
        y_cont[:, 1] = th
        return y_cat, y_cont

    @property
    def noise_steps(self) -> int:
        """Leading size of a dispatch's z: one draw per step for the reverse
        SDE, none for the samplers that draw the initial x alone."""
        return self.steps if self.sampler_name == "sde" else 0

    def draw_noise(self, batch: int, generator: torch.Generator, lazy: bool = False):
        """(x_init [batch, H, W, 1], z [noise_steps, batch, H, W, 1]) from
        `generator` (on the service's device), in the sampler's order; with
        `lazy`, z is `StepDraws`, drawn as the sampler reads it."""
        s = self.img_size
        return draw_sampler_noise((batch, s, s, 1), self.noise_steps, generator, self.device,
                                  lazy=lazy)

    def sampler_callable(self, batch: int, img_shape=None):
        """The serving dispatch at one static batch (and `img_shape`, default
        the whole image; a rank of a space axis gives its own rows):
        ``run(y_cat int32 [batch], y_cont f32 [batch, D], x_init f32
        [batch, H, W, 1], z f32 [noise_steps, batch, H, W, 1]) -> [batch, H,
        W, 1]``, with the resolved sampler, steps, CFG and t_end baked in and
        the noise as an input (an exported graph takes no generator). z is
        read by the reverse SDE only. `sample()` runs it on `draw_noise`'s
        draws (z as `StepDraws`); toycrystals_torch/export.py exports it with
        z a tensor."""
        sampler_fn, apply_fn, sde = self._sampler_fn, self._apply_fn, self.sde
        shape = (int(batch), self.img_size, self.img_size, 1) if img_shape is None \
            else tuple(int(v) for v in img_shape)
        kw = dict(n_steps=self.steps, guidance_scale=self.guidance_scale, t_end=self.t_end,
                  n_types=self.n_types, clip_x0=self.clip_x0, **self._extra_kw)
        sde_noise = self.sampler_name == "sde"

        def run(y_cat, y_cont, x_init, z):
            return sampler_fn(apply_fn, sde, y_cat, y_cont, shape, None,
                              noise=(x_init, z) if sde_noise else x_init, **kw)

        return run

    def _dispatch(self, _apply_fn, _sde, y_cat, y_cont, img_shape, generator):
        """One call of `sampler_callable` on `generator`'s draws; it takes a
        sampler's arguments, so `sample_chunked` drives it as a sampler."""
        x_init, z = draw_sampler_noise(img_shape, self.noise_steps, generator, self.device,
                                       lazy=True)
        return self.sampler_callable(int(img_shape[0]), img_shape)(y_cat, y_cont, x_init, z)

    def sample(self, y_cat, y_cont, *, seed: int = 0) -> np.ndarray:
        """One image per condition row: (n, H, W, 1) float32 in [0, 1], or
        uint8 in [0, 255] (quantised on the device) with out_dtype="uint8".
        The request is padded to the nearest bucket and trimmed after; a
        request beyond the top bucket runs in top-bucket chunks, each with
        its own generator (`chunk_seed`). Deterministic given (weights,
        settings, seed, batch layout)."""
        seed = int(seed)
        if not 0 <= seed < 2**31:
            raise ValueError(f"seed must satisfy 0 <= seed < 2**31, got {seed}")
        n = int(np.shape(y_cat)[0])
        yc = np.asarray(y_cat, np.int32)
        yv = np.asarray(y_cont, np.float32)
        size, top = self.img_size, self.buckets[-1]
        if self.mesh is not None:
            return self._sample_mesh(yc, yv, seed)
        if n > top:
            with self._lock, torch.inference_mode():
                yc_t, yv_t = (torch.from_numpy(a).to(self.device) for a in (yc, yv))
                x = sample_chunked(self._dispatch, self._apply_fn, self.sde, yc_t, yv_t,
                                   (n, size, size, 1), seed, chunk=top)
            self._count(n, -(-n // top))
            return x
        # host-side pad, single dispatch, single pull
        bucket = self._pick_bucket(n)
        pad = bucket - n
        if pad:
            yc = np.concatenate([yc, np.repeat(yc[-1:], pad, axis=0)])
            yv = np.concatenate([yv, np.repeat(yv[-1:], pad, axis=0)])
        with self._lock, torch.inference_mode():
            yc_t, yv_t = (torch.from_numpy(a).to(self.device) for a in (yc, yv))
            gen = torch.Generator(device=self.device).manual_seed(seed)
            x = self._dispatch(self._apply_fn, self.sde, yc_t, yv_t, (bucket, size, size, 1),
                               gen)[:n].cpu().numpy()
        self._count(n, 1)
        return x

    def _sample_mesh(self, yc: np.ndarray, yv: np.ndarray, seed: int) -> np.ndarray:
        """`sample` on a mesh: `sample_chunked` at the request's bucket, on
        every rank; rank 0 of a served mesh first announces the dispatch."""
        n, size = yc.shape[0], self.img_size
        bucket = self._pick_bucket(n)
        with self._lock:
            if self._store is not None:
                self._announce((yc, yv, seed))
            with torch.inference_mode():
                yc_t, yv_t = (torch.from_numpy(a).to(self.device) for a in (yc, yv))
                x = sample_chunked(self._dispatch, self._apply_fn, self.sde, yc_t, yv_t,
                                   (n, size, size, 1), seed, chunk=bucket, mesh=self.mesh)
        self._count(n, -(-n // bucket))
        return x

    def lead(self) -> None:
        """Rank 0 of a served mesh: announce every later dispatch to the ranks
        in `follow`, on the process group's store."""
        if self.mesh is None:
            raise ValueError("lead() serves a mesh; this service has none")
        self._store = _group_store()

    def _announce(self, message) -> None:
        self._store.set(_ANNOUNCE_KEY.format(self._announced), pickle.dumps(message))
        self._announced += 1

    def stop_followers(self) -> None:
        """Rank 0: end the followers' loops (after its last dispatch)."""
        if self._store is not None:
            with self._lock:
                self._announce(None)

    def follow(self) -> None:
        """A rank other than 0 of a served mesh: run each dispatch that rank 0
        announces, in order, until it stops. Between dispatches the rank
        waits on the store with no deadline; a store that is gone (rank 0
        died) raises."""
        if self.mesh is None:
            raise ValueError("follow() serves a mesh; this service has none")
        store = _group_store()
        i = 0
        while True:
            key = _ANNOUNCE_KEY.format(i)
            while True:
                try:
                    store.wait([key], _FOLLOW_POLL)
                    break
                except RuntimeError:  # the wait timed out, or the store is gone
                    if store.check([key]):  # raises if the store is gone
                        break
            message = pickle.loads(store.get(key))
            i += 1
            if message is None:
                return
            yc, yv, seed = message
            self.sample(yc, yv, seed=seed)

    def _count(self, images: int, dispatches: int) -> None:
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["images"] += images
            self._stats["dispatches"] += dispatches

    def sample_conditions(self, types, thetas=None, *, seed: int = 0) -> np.ndarray:
        y_cat, y_cont = self.conditions(types, thetas)
        return self.sample(y_cat, y_cont, seed=seed)

    def warmup(self) -> None:
        """One request per bucket, so the first real request finds the CUDA
        kernels built and every shape's library algorithms chosen."""
        for b in self.buckets:
            self.sample_conditions([0] * b, seed=0)


class MicroBatcher:
    """Dynamic batching: coalesce concurrent requests into shared dispatches.

    Requests submitted within `window_ms` of each other, up to `max_batch`
    rows (default: the service's top bucket), are stacked on the host into
    one `service.sample` call and the results are split back to each caller
    in order. Dispatch k (from 1) samples with seed `base_seed + k`, so the
    results are i.i.d. across dispatches but depend on how requests happened
    to coalesce; `ScoreModelService.sample` is the reproducible path."""

    def __init__(self, service: ScoreModelService, *, window_ms: float = 5.0,
                 max_batch: int | None = None, base_seed: int = 0):
        self.service = service
        self.window_s = float(window_ms) / 1e3
        self.max_batch = int(max_batch or service.buckets[-1])
        self._q: queue.Queue = queue.Queue()
        self._dispatches = 0
        self._coalesced = 0
        self._base_seed = int(base_seed)
        self._closed = False
        self._close_lock = threading.Lock()  # no request may land behind the sentinel
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, types, thetas=None) -> Future:
        """Validate now (service.conditions) and enqueue; the Future resolves
        to (n, H, W, 1) in the service's out_dtype."""
        y_cat, y_cont = self.service.conditions(types, thetas)
        fut: Future = Future()
        with self._close_lock:
            if self._closed:
                # no worker would ever drain the queue: the Future would hang its caller
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((y_cat, y_cont, fut))
        return fut

    def close(self, timeout: float | None = None) -> None:
        """Stop taking requests, dispatch every one already submitted, and
        join the worker; later submits raise. A timeout abandons what is
        still in flight."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._q.put(None)
        self._worker.join(timeout=timeout)

    @property
    def stats(self) -> dict[str, Any]:
        return {"batched_dispatches": self._dispatches,
                "coalesced_requests": self._coalesced,
                "window_ms": self.window_s * 1e3, "max_batch": self.max_batch}

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            rows = item[0].shape[0]
            deadline = time.monotonic() + self.window_s
            while rows < self.max_batch:
                try:
                    nxt = self._q.get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    return
                batch.append(nxt)
                rows += nxt[0].shape[0]
            self._dispatch(batch)

    def _dispatch(self, batch) -> None:
        self._dispatches += 1
        self._coalesced += len(batch)
        seed = self._base_seed + self._dispatches
        try:
            # the concat stays on the host, before sample() takes the service's lock
            y_cat = np.concatenate([b[0] for b in batch], axis=0)
            y_cont = np.concatenate([b[1] for b in batch], axis=0)
            x = self.service.sample(y_cat, y_cont, seed=seed)
        except Exception as e:  # noqa: BLE001 - the failure goes to every caller
            for _, _, fut in batch:
                fut.set_exception(e)
            return
        i = 0
        for yc, _, fut in batch:
            n = yc.shape[0]
            fut.set_result(x[i:i + n])
            i += n


def _group_store():
    """The store of the default process group (the launcher's rendezvous)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("serving a mesh needs a process group")
    return dist.distributed_c10d._get_default_store()


def grid_png_bytes(x: np.ndarray) -> bytes:
    """Samples as a square grid PNG: utils/figures.py's 8-bit PNG of the
    pixels (2-px white gaps). uint8 input (an out_dtype="uint8" service) is
    divided by 255 first."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    side = int(math.ceil(math.sqrt(x.shape[0])))
    return _grid_png(x, side, side)


def raw_png_bytes(x: np.ndarray, ncols: int | None = None, pad: int = 2,
                  pad_value: float = 1.0) -> bytes:
    """Samples tiled into one 8-bit grayscale PNG with `pad`-px gaps of
    `pad_value`, `ncols` wide (default a square grid); float pixels quantise as
    round(x * 255), uint8 pixels pass through. The same bytes as JAX's."""
    x = np.asarray(x)
    u8_in = x.dtype == np.uint8
    if not u8_in:
        x = np.asarray(x, np.float32)
    if x.ndim == 4:
        x = x[..., 0]
    if x.ndim == 2:
        x = x[None]
    n, h, w = x.shape
    nc = int(ncols) if ncols else int(math.ceil(math.sqrt(n)))
    nr = -(-n // nc)
    canvas = np.full((nr * (h + pad) + pad, nc * (w + pad) + pad),
                     np.uint8(round(pad_value * 255.0)) if u8_in else pad_value,
                     np.uint8 if u8_in else np.float32)
    for i in range(n):
        r, c = divmod(i, nc)
        canvas[pad + r * (h + pad):pad + r * (h + pad) + h,
               pad + c * (w + pad):pad + c * (w + pad) + w] = x[i]
    u8 = canvas if u8_in else np.clip(canvas * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
    return png_gray(u8)


def npy_bytes(x: np.ndarray) -> bytes:
    """Samples as a `.npy` blob (`np.load(io.BytesIO(body))` gives them back
    bit for bit): float32 in [0, 1], or uint8 in [0, 255] from an
    out_dtype="uint8" service."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = np.asarray(x, np.float32)
    buf = io.BytesIO()
    np.save(buf, x)
    return buf.getvalue()
