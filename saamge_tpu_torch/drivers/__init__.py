"""Command-line drivers of the port, twins of the JAX package's
``scripts/`` drivers (``python -m saamge_tpu_torch.drivers.<name>``)."""
