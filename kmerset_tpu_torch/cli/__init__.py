"""Command-line entry points of the port (run as `python -m
kmerset_tpu_torch.cli.<name>`)."""
