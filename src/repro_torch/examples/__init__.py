"""Runnable examples of the port, twins of the repository's `examples/`:
`python -m repro_torch.examples.<name>`."""
