"""Rectified-flow helpers of the score model, in PyTorch.

Counterpart of toycrystals_tpu/models/flow_matching.py. Only `shift_t`, which
the training loss needs, is ported; the rectified-flow sampler is not yet
(ROADMAP.md, "Deferred from the serving slice").
"""

from __future__ import annotations

import torch


def shift_t(t: torch.Tensor, shift: float) -> torch.Tensor:
    """Resolution timestep shift t' = s t / (1 + (s - 1) t): monotone on
    [0, 1] with fixed endpoints; s > 1 pushes mass towards t = 1 (the noise
    side) and subtracts 2 ln s of logSNR on the straight-line path."""
    s = float(shift)
    if s == 1.0:
        return t
    return s * t / (1.0 + (s - 1.0) * t)
