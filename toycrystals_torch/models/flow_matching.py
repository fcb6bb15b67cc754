"""Rectified flow of the score model, in PyTorch.

Counterpart of toycrystals_tpu/models/flow_matching.py. The `fm`
parameterization (`--param fm` of the trainer) runs the same CondUNetTiny on
the straight-line path x_t = (1 - t) x0 + t eps and regresses the velocity
eps - x0 (the loss branch is `diffusion_loss_eps_given(parameterization=
"fm")`). `sample_rectified_flow` integrates the learned velocity from t = 1
to t_end with Euler or Heun steps on a uniform grid taken through `shift_t`,
guidance combined on the velocity exactly as on eps (one doubled batch per
evaluation), then the x0 projection x0 = x - t v. Like the other samplers of
the port, it draws its noise from the `torch.Generator` it is given, or takes
it from `noise=`, and runs its steps through `run_steps` (one `scan` when
exported).
"""

from __future__ import annotations

import torch

from toycrystals_torch.models.sde_score_model import (
    ApplyFn,
    VPSDE,
    _check_t_end,
    _initial_x,
    _shape,
    predict_eps_cfg,
    run_steps,
)


def shift_t(t: torch.Tensor, shift: float) -> torch.Tensor:
    """Resolution timestep shift t' = s t / (1 + (s - 1) t): monotone on
    [0, 1] with fixed endpoints; s > 1 pushes mass towards t = 1 (the noise
    side) and subtracts 2 ln s of logSNR on the straight-line path."""
    s = float(shift)
    if s == 1.0:
        return t
    return s * t / (1.0 + (s - 1.0) * t)


def _maybe_clip_x0_fm(v_hat: torch.Tensor, x: torch.Tensor, tb: torch.Tensor,
                      clip_x0: bool) -> torch.Tensor:
    """Static x0 thresholding in flow space: clip the implied x0 = x - t v to
    [-1, 1] and re-derive v = (x - x0) / t. tb: [B, 1, 1, 1]."""
    if not clip_x0:
        return v_hat
    x0 = (x - tb * v_hat).clamp(-1.0, 1.0)
    return (x - x0) / tb.clamp(min=1e-6)


def sample_rectified_flow(
    apply_fn: ApplyFn, sde: VPSDE | None, y_cat: torch.Tensor, y_cont: torch.Tensor,
    img_shape, generator: torch.Generator | None = None, n_steps: int = 50,
    guidance_scale: float = 0.0, t_end: float = 1e-3, n_types: int = 4,
    clip_x0: bool = False, solver: str = "euler", t_shift: float = 1.0, noise=None,
) -> torch.Tensor:
    """Integrate the velocity field from noise (t = 1) to t_end, then project
    to x0; returns [B, H, W, 1] in [0, 1].

    `sde` is unused; it keeps the signature every sampler here shares, so
    `sample_chunked`, the CLIs and the service drive this one as the others.
    solver "euler" runs 1 evaluation per step, "heun" 2 (trapezoidal); the
    projection adds 1. t_shift evaluates the grid through `shift_t` (pass
    the checkpoint's fm_shift). noise: optional initial x [B, H, W, 1]."""
    del sde
    if solver not in ("euler", "heun"):
        raise ValueError(f"solver must be euler|heun, got {solver}")
    t_end = _check_t_end(t_end)
    shape = _shape(img_shape)
    dev = y_cat.device
    b = shape[0]
    gs = float(guidance_scale)
    ts = shift_t(torch.linspace(1.0, t_end, n_steps + 1, dtype=torch.float32, device=dev),
                 t_shift)
    x = _initial_x(noise, shape, generator, dev)

    def velocity(x, t):
        tb = t.expand(b)
        v = predict_eps_cfg(apply_fn, x, tb, y_cat, y_cont, gs, n_types)
        return _maybe_clip_x0_fm(v, x, tb.reshape(b, 1, 1, 1), clip_x0)

    def step(x, inputs):
        t, t_next = inputs
        dt = t_next - t  # negative: towards the data
        v1 = velocity(x, t)
        if solver == "euler":
            return x + dt * v1
        v2 = velocity(x + dt * v1, t_next)
        return x + 0.5 * dt * (v1 + v2)

    x = run_steps(step, x, (ts[:-1], ts[1:]))
    x0 = x - ts[-1] * velocity(x, ts[-1])
    return ((x0 + 1.0) * 0.5).clamp(0.0, 1.0)
