"""Command-line entry points of the port: ``python3 -m
ciaosr_torch.tools.test``, ``python3 -m ciaosr_torch.tools.inference`` and
``python3 -m ciaosr_torch.tools.train``."""
