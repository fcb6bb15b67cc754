"""Ops of the port: fused GroupNorm+SiLU kernel, circular conv, attention.

Importing this package registers the custom ops `toycrystals::gn_silu` and
`toycrystals::flash_sdpa_fwd` (ops/groupnorm.py, ops/attention.py), which a
CUDA graph exported by toycrystals_torch/export.py calls; nothing is built
until a kernel's first CUDA launch."""

from toycrystals_torch.ops import attention, groupnorm  # noqa: F401
