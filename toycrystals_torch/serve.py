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
its `ckpt_path`.

Not ported yet (each raises NotImplementedError and is queued in ROADMAP.md):
int8 convs, meshes, orbax checkpoints, the MicroBatcher and the HTTP front
end.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from toycrystals_torch.models.flow_matching import sample_rectified_flow
from toycrystals_torch.models.sde_score_model import (
    VPSDE,
    CondUNetTiny,
    eps_apply_from_v,
    sample_chunked,
    sample_ddim,
    sample_dpmpp_2m,
    sample_probability_flow_ode,
    sample_reverse_sde_euler_maruyama,
)
from toycrystals_torch.utils.params import load_flax_params

DEFAULT_BUCKETS = (1, 4, 16, 64)

_REFERENCE_SERVE = {"sampler": "sde", "steps": 300,
                    "guidance_scale": 1.5, "t_end": 0.005}

_SAMPLERS = {"sde": sample_reverse_sde_euler_maruyama,
             "ode": sample_probability_flow_ode,
             "dpm": sample_dpmpp_2m,
             "ddim": sample_ddim,
             "rf": sample_rectified_flow}

_DEFERRED = "ROADMAP.md, 'Deferred from the serving slice'"


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
        if quantize == "int8":
            raise NotImplementedError(f"quantize='int8' is not ported yet ({_DEFERRED})")
        if quantize != "none":
            raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
        if mesh is not None:
            raise NotImplementedError(f"serving on a mesh is not ported yet ({_DEFERRED})")
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
        model = CondUNetTiny(
            n_types=self.n_types, y_cont_dim=self.y_cont_dim,
            base_ch=int(cfg["base_ch"]), emb_dim=int(cfg["emb_dim"]),
            cond_ch=int(cfg["cond_ch"]), time_ch=int(cfg["time_ch"]),
            dtype=torch.bfloat16 if dtype_name == "bfloat16" else torch.float32,
            attn_impl=attn_impl, stem=str(cfg.get("stem", "none")),
        )
        load_flax_params(model, params)
        self.model = model.to(self.device).eval().requires_grad_(False)
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

        self.buckets = tuple(sorted({max(1, int(b)) for b in buckets}))
        self._lock = threading.Lock()  # one sampling call at a time per device
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
        return cls(cfg, state["params"], ema_params=state.get("ema_params"), **kw)

    @property
    def stats(self) -> dict[str, Any]:
        with self._stats_lock:
            s = dict(self._stats)
        s.update(buckets=list(self.buckets), sampler=self.sampler_name,
                 steps=self.steps, guidance_scale=self.guidance_scale,
                 t_end=self.t_end, img_size=self.img_size,
                 distilled=bool(self.config.get("distilled")),
                 quantize=self.quantize, out_dtype=self.out_dtype,
                 device=str(self.device))
        return s

    def describe(self) -> dict[str, Any]:
        keep = ("n_types", "y_cont_dim", "base_ch", "emb_dim", "param",
                "dtype", "img_size", "distilled", "distill_steps")
        return {k: self.config[k] for k in keep if k in self.config}

    def _pick_bucket(self, n: int) -> int:
        """The smallest bucket that holds n rows (n <= the top bucket)."""
        return next(b for b in self.buckets if b >= n)

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
        kw = dict(n_steps=self.steps, guidance_scale=self.guidance_scale, t_end=self.t_end,
                  n_types=self.n_types, clip_x0=self.clip_x0, **self._extra_kw)
        size, top = self.img_size, self.buckets[-1]
        if n > top:
            with self._lock, torch.inference_mode():
                yc_t, yv_t = (torch.from_numpy(a).to(self.device) for a in (yc, yv))
                x = sample_chunked(self._sampler_fn, self._apply_fn, self.sde, yc_t, yv_t,
                                   (n, size, size, 1), seed, chunk=top, **kw)
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
            x = self._sampler_fn(self._apply_fn, self.sde, yc_t, yv_t,
                                 (bucket, size, size, 1), gen, **kw)[:n].cpu().numpy()
        self._count(n, 1)
        return x

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
    """Dynamic batching of concurrent requests: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"MicroBatcher is not ported yet ({_DEFERRED})")
