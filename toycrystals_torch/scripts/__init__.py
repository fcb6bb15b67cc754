"""The port's command-line entry points, run as `python -m toycrystals_torch.scripts.<name>`."""
