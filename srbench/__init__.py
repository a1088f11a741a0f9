"""The benchmark of the CiaoSR port (``ciaosr_torch``) on the card: one
command per cell (``python3 -m srbench.run``), driven by BENCHMARK.json
and the data files under this folder."""
