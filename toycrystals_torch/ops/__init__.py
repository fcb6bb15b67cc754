"""Ops of the port: fused GroupNorm+SiLU kernel, circular conv, attention."""
