"""Export a service's sampler as one self-contained file, with torch.export.

Counterpart of toycrystals_tpu/export.py. What is exported is the serving
dispatch, `ScoreModelService.sampler_callable(batch)`, traced once by
`torch.export` with the weights in the graph's state and the sampler, steps,
guidance and t_end frozen. The sampler's step loop is one `scan`
(models/sde_score_model.py `run_steps`), so the graph holds one step,
whatever the steps, as JAX's module holds one `lax.scan`:

    graph(y_cat int32[batch], y_cont float32[batch, D],
          x_init float32[batch, H, W, 1], z float32[noise_steps, batch, H, W, 1])
      -> float32[batch, H, W, 1] in [0, 1]

`load_exported(path)` returns `(fn, meta)` with `fn(y_cat, y_cont, seed)`,
which draws (x_init, z) on the artefact's device from
`torch.Generator(device).manual_seed(seed)` in the service's order (x_init,
then one call per step: `models/sde_score_model.py:draw_sampler_noise`) and
runs the graph, so it gives what `service.sample(y_cat, y_cont, seed=seed)`
gives at that batch.

File format (`save_exported` / `load_exported`): a magic line, a big-endian
u64 length, a JSON meta block (sampler settings, shapes, platform, the
custom ops the graph calls, `"loop": "scan"`), then the bytes of
`torch.export.save`, which hold no example inputs. The write is atomic (tmp +
rename).

Deliberate differences from the JAX export:

- The noise is an input of the graph and is drawn outside it: an exported
  graph takes no `torch.Generator`. JAX builds its key inside the module.
- A CUDA export calls the custom ops `toycrystals::gn_silu` and
  `toycrystals::flash_sdpa_fwd`, so loading it needs `import
  toycrystals_torch.ops` (the registrations and the kernels), as JAX's TPU
  export embeds its Pallas custom call. A CPU export (`platforms=["cpu"]`)
  traces the plain versions and needs only torch.
- One artefact is traced for one device: `platforms` takes one of "cuda" or
  "cpu", the device the service runs on. Multi-platform modules are JAX's.
- The export traces the one-device dispatch, as JAX's does; a service on a
  mesh, or an export inside a mesh's dispatch scope (parallel/spatial.py),
  raises.

CLI: toycrystals_torch/scripts/export_sde_score_model.py.
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from toycrystals_torch.models.sde_score_model import draw_sampler_noise
from toycrystals_torch.parallel import spatial

MAGIC = b"TOYCRYSTALS-TORCH-EXPORT-V1\n"
PLATFORMS = ("cuda", "cpu")


class _Dispatch(nn.Module):
    """The dispatch as a module: the U-Net is a submodule, so its weights are
    the graph's parameters."""

    def __init__(self, model: nn.Module, run) -> None:
        super().__init__()
        self.model = model
        self._run = run

    def forward(self, y_cat, y_cont, x_init, z):
        return self._run(y_cat, y_cont, x_init, z)


def _platform(service, platforms: list[str] | None) -> str:
    dev = service.device.type
    if platforms is None:
        return dev
    plats = list(platforms)
    if len(plats) != 1 or plats[0] not in PLATFORMS:
        raise ValueError(f"an artefact is traced for one device, one of {PLATFORMS}; got "
                         f"{plats} (multi-platform modules are the JAX package's)")
    if plats[0] != dev:
        raise ValueError(f"the service runs on {service.device}; export for {dev!r}, or build "
                         f"the service on {plats[0]!r}")
    return dev


def _graphs(ep: torch.export.ExportedProgram) -> list[torch.fx.Graph]:
    """The graph and every subgraph it calls: the scan's step."""
    return [m.graph for m in ep.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]


def _drop_no_ops(ep: torch.export.ExportedProgram) -> None:
    """Remove what the trace records for every `.to()` that changes nothing,
    in the graph and in the scan's step: the `_assert_tensor_metadata` checks
    and the casts to the dtype a tensor already has. They are a third of the
    nodes of an f32 step and cost time in every later pass over the graph."""
    for g in _graphs(ep):
        for node in list(g.nodes):
            if node.op != "call_function":
                continue
            if node.target is torch.ops.aten._assert_tensor_metadata.default:
                g.erase_node(node)
            elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
                  and not node.kwargs and isinstance(node.args[0], torch.fx.Node)
                  and node.args[0].meta["val"].dtype == node.args[1]):
                node.replace_all_uses_with(node.args[0])
                g.erase_node(node)
        g.owning_module.recompile()


def export_service(service, batch: int,
                   platforms: list[str] | None = None) -> torch.export.ExportedProgram:
    """Export `service`'s dispatch at one static batch, its step loop as one
    `scan`. `platforms`: None (the service's device) or one of ["cuda"],
    ["cpu"], matching it. A service on a mesh, or a call inside a mesh's
    dispatch scope, raises: the artefact is the one-device dispatch."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    _platform(service, platforms)
    if service.mesh is not None or spatial.current() is not None:
        raise ValueError("an export traces the one-device dispatch; build the service "
                         "without a mesh and export outside a mesh's dispatch scope")
    b, dev = int(batch), service.device
    args = (torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b, service.y_cont_dim), dtype=torch.float32, device=dev),
            *service.draw_noise(b, torch.Generator(device=dev).manual_seed(0)))
    module = _Dispatch(service.model, service.sampler_callable(b))
    # the fake-tensor cache's hits cost more than they save on this trace: a
    # scan export takes a quarter to a third less time without it
    with torch.no_grad(), torch._dynamo.config.patch(fake_tensor_cache_enabled=False):
        ep = torch.export.export(module, args, strict=False)
    ep.example_inputs = None  # else torch.export.save writes them: z grows with the steps
    _drop_no_ops(ep)
    return ep


def graph_nodes(ep: torch.export.ExportedProgram) -> int:
    """Nodes of the graph and of the scan's step: the same at every step count."""
    return sum(len(g.nodes) for g in _graphs(ep))


def custom_ops(ep: torch.export.ExportedProgram) -> list[str]:
    """The `toycrystals::` ops the graph and its step call, e.g.
    "toycrystals.gn_silu.default"."""
    return sorted({str(n.target) for g in _graphs(ep) for n in g.nodes
                   if n.op == "call_function" and str(n.target).startswith("toycrystals.")})


def export_meta(service, batch: int, exported: torch.export.ExportedProgram) -> dict[str, Any]:
    """The JSON meta block written before the graph's bytes."""
    return {
        "format": "toycrystals-torch-export",
        "version": 2,
        "loop": "scan",
        "torch_version": torch.__version__,
        "platforms": [service.device.type],
        "batch": int(batch),
        "img_size": service.img_size,
        "n_types": service.n_types,
        "y_cont_dim": service.y_cont_dim,
        "sampler": service.sampler_name,
        "steps": service.steps,
        "noise_steps": service.noise_steps,
        "guidance_scale": service.guidance_scale,
        "t_end": service.t_end,
        "param": str(service.config.get("param", "eps")),
        "distilled": bool(service.config.get("distilled")),
        "ckpt": service.ckpt_path,
        "custom_ops": custom_ops(exported),
        "graph_nodes": graph_nodes(exported),
        "calling_convention": (
            "graph(y_cat int32[batch], y_cont float32[batch,y_cont_dim], "
            "x_init float32[batch,img_size,img_size,1], "
            "z float32[noise_steps,batch,img_size,img_size,1]) "
            "-> float32[batch,img_size,img_size,1]; load_exported draws x_init, then z[i] "
            "for each i, by randn from torch.Generator(device).manual_seed(seed)"),
    }


def save_exported(path: str | Path, exported: torch.export.ExportedProgram,
                  meta: dict[str, Any]) -> None:
    """Write MAGIC + u64 meta length + meta JSON + torch.export bytes,
    atomically (tmp + rename, as utils/checkpoint.py)."""
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    head = json.dumps(meta, sort_keys=True).encode()
    p = Path(path)
    tmp = p.with_name(p.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack(">Q", len(head)))
        f.write(head)
        f.write(buf.getbuffer())
    tmp.replace(p)


def read_container(raw: bytes, name: str = "artefact") -> tuple[dict[str, Any], bytes]:
    """(meta, torch.export bytes) of a container's bytes; a bad magic line
    raises ValueError."""
    if not raw.startswith(MAGIC):
        raise ValueError(f"{name} is not a toycrystals-torch export (bad magic; expected "
                         f"{MAGIC!r})")
    off = len(MAGIC)
    (hlen,) = struct.unpack(">Q", raw[off:off + 8])
    off += 8
    return json.loads(raw[off:off + hlen].decode()), raw[off + hlen:]


def _scan_steps(step, init, xs, additional_inputs):
    """What a loaded graph's scan runs: its `step` once per slice of xs, in
    order (a sampler's step returns its carry alone). torch 2.11's own eager
    scan first runs the step once more on the first slice, to learn its
    outputs' shapes: one more U-Net forward per call, which a sampler's
    launch count would show."""
    carry = tuple(init)
    for i in range(xs[0].shape[0]):
        carry = tuple(step(*carry, *(x.select(0, i) for x in xs), *additional_inputs))
    return carry


def load_exported(path: str | Path):
    """Read an artefact -> (fn, meta). `fn(y_cat, y_cont, seed)` draws the
    noise for `seed` on the artefact's device and runs the graph, returning
    a [batch, H, W, 1] f32 tensor there; `fn.graph_module(y_cat, y_cont,
    x_init, z)` is the graph itself."""
    import toycrystals_torch.ops  # noqa: F401 - the custom ops a CUDA graph calls

    meta, blob = read_container(Path(path).read_bytes(), str(path))
    module = torch.export.load(io.BytesIO(blob)).module()
    for node in module.graph.nodes:
        if node.op == "call_function" and node.target is torch.ops.higher_order.scan:
            node.target = _scan_steps
    module.recompile()
    device = torch.device(meta["platforms"][0])
    s = int(meta["img_size"])
    shape = (int(meta["batch"]), s, s, 1)

    def fn(y_cat, y_cont, seed: int) -> torch.Tensor:
        seed = int(seed)
        if not 0 <= seed < 2**31:
            raise ValueError(f"seed must satisfy 0 <= seed < 2**31, got {seed}")
        yc = torch.as_tensor(np.asarray(y_cat, np.int32), device=device)
        yv = torch.as_tensor(np.asarray(y_cont, np.float32), device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        x_init, z = draw_sampler_noise(shape, int(meta["noise_steps"]), gen, device)
        with torch.inference_mode():
            return module(yc, yv, x_init, z)

    fn.graph_module = module
    return fn, meta


def export_checkpoint(ckpt_path: str, out_path: str | Path, *, batch: int = 36,
                      platforms: list[str] | None = None, **service_kw) -> dict[str, Any]:
    """One shot: checkpoint -> artefact on disk; returns the meta.
    `service_kw` are `ScoreModelService` options (sampler, steps,
    guidance_scale, t_end, use_ema, dtype, device, ...); what is left None
    resolves from the checkpoint as serving does. The service runs on
    `platforms[0]` when given."""
    from toycrystals_torch.serve import ScoreModelService

    if platforms is not None and len(platforms) == 1:
        service_kw.setdefault("device", platforms[0])
    service_kw.setdefault("buckets", (int(batch),))
    service = ScoreModelService.from_checkpoint(ckpt_path, **service_kw)
    exported = export_service(service, batch, platforms)
    meta = export_meta(service, batch, exported)
    save_exported(out_path, exported, meta)
    return meta
