"""Command-line entry points: python -m svdfeature_tpu_torch.cli.<name>."""
