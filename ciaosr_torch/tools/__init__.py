"""Command-line entry points of the port: ``python3 -m
ciaosr_torch.tools.test`` and ``python3 -m ciaosr_torch.tools.inference``."""
