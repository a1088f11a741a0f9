"""The benchmark's plain references: float32 PyTorch that imports nothing
of the program under test (the CiaoSR generator, the overlap-average
tiling, one Adam + EMA training step)."""
