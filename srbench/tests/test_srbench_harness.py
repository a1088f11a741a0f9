"""The benchmark's own files: BENCHMARK.json against its rules, the lookup
by name (a new cell, configuration, traffic and metric need new files and
entries only), and the imports (nothing of JAX; the reference nothing of
the program)."""

from __future__ import annotations

import ast
import json
import re
import shutil
import time

import pytest
import torch

from srbench.tests._tiny import ROOT, SEED, tiny_config, tiny_mix

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "ciaosr_tpu"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["srbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_keys_and_names(section, keys):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells_find_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] == 1
        assert (ROOT / configs[cell["config"]]["file"]).is_file()
        assert (ROOT / "srbench" / "traffic"
                / f"{cell['traffic']}.json").is_file()
        assert (ROOT / "srbench" / "limits" / f"{cell['name']}.json").is_file()
        reported = [n for n, m in e2e.items()
                    if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell["name"] in m["workloads"]
                   for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert (ROOT / "srbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert m["workloads"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}[
        "setup_s"] == 0.25


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "srbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_reference_standalone(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.parts:
        assert "ciaosr_torch" not in tops
        assert tops <= {"__future__", "math", "numpy", "torch", "srbench"}


def test_added_cell_is_found_by_name(tmp_path):
    """A throwaway configuration, traffic, metric and cell placed in a copy
    run with no file of the copy edited: only new files and entries."""
    from srbench.cells import Ctx, run
    from srbench.run import build_result, config_of, find_cell

    shutil.copytree(ROOT / "srbench", tmp_path / "srbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "srbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "srbench" / "configs" / "tinyrdn.json").write_text(
        json.dumps(tiny_config("rdn001")))
    (tmp_path / "srbench" / "traffic" / "tiny.photos.json").write_text(
        json.dumps(tiny_mix("x4.photos")))
    (tmp_path / "srbench" / "metrics" / "pictures_traced.py").write_text(
        "def read(t):\n    return float(t.ranged.info['items'])\n")
    limits = json.loads((ROOT / "srbench" / "limits"
                         / "rdn001.x4.photos.json").read_text())
    (tmp_path / "srbench" / "limits" / "tinyrdn.tiny.json").write_text(
        json.dumps(limits))
    bench["configs"].append({"name": "tinyrdn", "source": "test",
                             "file": "srbench/configs/tinyrdn.json",
                             "reduced": ["encoder"], "why": "test"})
    bench["workloads"].append({"name": "tinyrdn.tiny", "config": "tinyrdn",
                               "traffic": "tiny.photos", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "mp_per_s" == m["name"] or "image_p90_ms" == m["name"]:
            m["workloads"].append("tinyrdn.tiny")
    bench["per_layer"].append({"name": "pictures_traced", "unit": "count",
                               "better": "higher", "source":
                               "program_counter", "layer": "restorer",
                               "moves": "mp_per_s",
                               "workloads": ["tinyrdn.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = find_cell(bench, "tinyrdn.tiny")
    mix = json.loads((tmp_path / "srbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    for trace in (False, True):
        ctx = Ctx(root=tmp_path, workload=cell["name"],
                  cfg=config_of(tmp_path, bench, cell["config"]), mix=mix,
                  seed=SEED, seconds=0.3, trace=trace,
                  device=torch.device("cpu"), t_start=time.perf_counter())
        out = build_result(tmp_path, bench, cell, run(ctx), trace,
                           torch.device("cpu"))
        assert out["correct"], out["checks"]
        if trace:
            assert out["metrics"]["pictures_traced"]["value"] == \
                mix["trace_items"]
        else:
            assert set(out["metrics"]) == {"mp_per_s", "image_p90_ms",
                                           "setup_s"}
        assert list(out)[-1] == "checks"
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_run_refuses_without_a_card(monkeypatch, capsys):
    from srbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", "rdn001.x4.photos", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("config", ["rdn001", "swinir002"])
def test_traced_run_counts_the_window_as_the_ranges_do(config):
    """The window's operations are counted per picture, without hooks; the
    ranges' count over one pass of the loop is the same sum."""
    from srbench.cells import _picture_flops
    from srbench.flops import ciaosr as fl
    from srbench.reference.tiling import count_tiles
    from srbench.tests._tiny import run_tiny

    cfg, mix = tiny_config(config), tiny_mix("x4.photos")
    tr = run_tiny(config, "x4.photos", trace=True, cfg=cfg, mix=mix)["trace"]
    assert tr.ranged.info["items"] == tr.light.info["items"] == \
        mix["trace_items"] == len(mix["loop"])
    assert tr.info["items"] >= 1 and tr.info["step_flops"] > 0
    from srbench import generate
    tile = cfg["test_cfg"]["tile"]
    sizes = generate.photo_sizes(mix)
    want = sum(_picture_flops(
        fl.Widths.of(cfg["generator"]),
        count_tiles(*sizes[k], tile, cfg["test_cfg"]["tile_overlap"]),
        tile, mix["scale"]) for k in mix["loop"])
    assert tr.ranged.ranges.flops["step"] == pytest.approx(want, rel=1e-12)


def test_traced_train_run_reads_the_window_and_two_stretches():
    from srbench.tests._tiny import run_tiny

    mix = tiny_mix("train.l1")
    tr = run_tiny("swinir002", "train.l1", trace=True, mix=mix)["trace"]
    assert tr.info["steps"] >= 1 and tr.info["step_least_s"] > 0
    assert tr.light.info["steps"] == tr.ranged.info["steps"] == \
        mix["trace_steps"]
    assert tr.ranged.ranges.least_s["swin_block_bwd"] > 0


def test_unsupported_scale_and_trunk_are_refused():
    from srbench.flops import ciaosr as fl
    from srbench.tests._tiny import run_tiny

    with pytest.raises(ValueError, match="whole scale"):
        run_tiny("rdn001", "x4.photos",
                 mix=dict(tiny_mix("x4.photos"), scale=2.5))
    gen = dict(tiny_config("rdn001")["generator"])
    gen["encoder"] = dict(gen["encoder"], type="EDSR")
    with pytest.raises(ValueError, match="EDSR"):
        fl.Widths.of(gen)
