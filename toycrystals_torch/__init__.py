"""PyTorch/CUDA port of toycrystals_tpu (see ROADMAP.md). Imports no JAX."""
