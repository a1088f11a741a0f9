"""``correct`` catches what it is there to catch: a run of a tiny cell on
the CPU, driven as the benchmark drives it, comes out correct, and with
the timed path broken underneath (each fault the cell can have) or the
float8 control in the program's place it comes out not correct, under
the real cells' limits. The card test reads the control at a cell's own
size."""

from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from srbench import faults
from srbench.correct import judge, load_limits
from srbench.tests._tiny import ROOT, run_tiny

EVAL = [("rdn001", "rdn001.x4.photos"), ("swinir002", "swinir002.x4.photos")]
TRAIN = "swinir002.train.l1"


def _judge(out, cell):
    return judge(out["numbers"], load_limits(ROOT, cell))


@pytest.mark.parametrize("config,cell", EVAL)
def test_eval_sound_run_is_correct(config, cell):
    ok, checks = _judge(run_tiny(config, "x4.photos"), cell)
    assert ok, checks


@pytest.mark.parametrize("config,cell", EVAL)
@pytest.mark.parametrize("fault", sorted(faults.EVAL))
def test_eval_faults_are_not_correct(config, cell, fault):
    out = run_tiny(config, "x4.photos", fault=faults.EVAL[fault])
    ok, checks = _judge(out, cell)
    assert not ok, checks


@pytest.mark.parametrize("config,cell", EVAL)
def test_eval_control_is_not_correct(config, cell):
    out = run_tiny(config, "x4.photos", control=True)
    ok, checks = judge(out["control"], load_limits(ROOT, cell))
    assert not ok, checks


def test_train_sound_run_is_correct():
    ok, checks = _judge(run_tiny("swinir002", "train.l1"), TRAIN)
    assert ok, checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_are_not_correct(fault):
    out = run_tiny("swinir002", "train.l1", fault=faults.TRAIN[fault])
    ok, checks = _judge(out, TRAIN)
    assert not ok, checks


def test_train_control_is_not_correct():
    out = run_tiny("swinir002", "train.l1", control=True)
    ok, checks = judge(out["control"], load_limits(ROOT, TRAIN))
    assert not ok, checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for _, c in EVAL] + [TRAIN])
def test_control_at_the_cells_size(card, cell, tmp_path):
    """The control and the program at the cell's own size on one seed: the
    program within every limit, the control over one of them."""
    import json

    out = tmp_path / "calib.jsonl"
    subprocess.run([sys.executable, "-m", "srbench.calibrate", "--workload",
                    cell, "--seeds", "7", "--seconds", "3", "--out",
                    str(out)], cwd=ROOT, check=True)
    line = json.loads(out.read_text().splitlines()[-1])
    limits = load_limits(ROOT, cell)
    assert judge(line["numbers"], limits)[0]
    assert not judge(line["control"], limits)[0]
