"""The kernels' launch helpers on the CPU: ``_build.function`` sets a C
entry point's ctypes prototype once and hands the same function back after,
and K1's prototype (``decoder.F3P_ARGTYPES``) matches the parameters of
``f3p_build`` in its CUDA source."""

import ctypes
import re

from ciaosr_torch.ops.kernels import _build
from ciaosr_torch.ops.kernels import decoder as dk


def test_function_sets_the_prototype_once(monkeypatch):
    class Fn:
        pass

    fn, loads = Fn(), []

    class Lib:
        f3p_build = fn

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    monkeypatch.setattr(_build, "_fns", {})
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert _build.function("f3p_build", "f3p_build", argtypes) is fn
    assert fn.restype is ctypes.c_int and fn.argtypes == argtypes
    fn.argtypes = None   # a later call neither loads nor sets it again
    assert _build.function("f3p_build", "f3p_build", argtypes) is fn
    assert fn.argtypes is None and loads == ["f3p_build"]


def test_f3p_prototype_matches_the_source():
    src = (_build.CSRC / "f3p_build.cu").read_text()
    params = re.search(r'extern "C" int f3p_build\((.*?)\)\s*\{', src,
                       re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert [p.split()[0] for p in params.split(",")].count("int") == 6
    assert kinds == dk.F3P_ARGTYPES
