"""The port's TensorBoard scalars (``ciaosr_torch/train/tb_events.py``,
written by ``MetricLogger``) against the JAX package's ``MetricLogger``,
which writes through ``tensorboardX``:

* for the same metric stream (float32 losses, a log every 2 steps, extra
  fields beside), both event files read by tensorboard's
  ``EventAccumulator`` hold the same tags, steps and float32 values, the
  extra fields in neither; the port's reader reads both the same way, and
  the JSONL records' means;
* the framing (CRC32C's check value, the masked CRCs), the file name, a
  first ``brain.Event:2`` event, a readable file after every record and
  a cut last record ignored, a damaged one refused;
* only rank 0 writes;
* ``tools.train`` on the CPU writes ``<work_dir>/tb/`` events equal to
  its JSONL means.
"""

import json
import os
import re
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import \
    EventAccumulator

from ciaosr_torch.parallel.mesh import Mesh
from ciaosr_torch.tools import train as port_train
from ciaosr_torch.train import tb_events
from ciaosr_torch.train.trainer import MetricLogger
from ciaosr_tpu.train.trainer import MetricLogger as JaxMetricLogger
from tests.test_torch_trainer import cli_config  # noqa: F401 (fixture)


def _stream(n=9, seed=0):
    rng = np.random.default_rng(seed)
    return [{"loss_pix": rng.random(dtype=np.float32) * 0.3,
             "loss_perc": rng.random(dtype=np.float32) * 2} for _ in range(n)]


def _accumulated(logdir):
    ea = EventAccumulator(logdir)
    ea.Reload()
    return {tag: [(e.step, e.value) for e in ea.Scalars(tag)]
            for tag in ea.Tags()["scalars"]}


def test_scalars_match_jax_tensorboardx(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = MetricLogger(str(port_dir), interval=2, progress=lambda m: None)
    jax_logger = JaxMetricLogger(str(jax_dir), interval=2)
    for step, m in enumerate(_stream(), 1):
        extra = {"lr": 1e-4 * step}
        port.log(step, {k: torch.tensor(v) for k, v in m.items()}, extra)
        jax_logger.log(step, {k: jnp.asarray(v) for k, v in m.items()},
                       extra)
    jax_logger._tb.close()
    got, ref = _accumulated(str(port_dir / "tb")), _accumulated(
        str(jax_dir / "tb"))
    assert set(got) == set(ref) == {"loss_pix", "loss_perc"}
    for tag in ref:
        assert [s for s, _ in got[tag]] == [s for s, _ in ref[tag]] \
            == [2, 4, 6, 8]
        np.testing.assert_array_equal(
            np.float32([v for _, v in got[tag]]),
            np.float32([v for _, v in ref[tag]]))
    # the port's reader reads tensorboardX's file as it reads its own
    assert tb_events.read_scalars(str(jax_dir / "tb")) == ref
    assert tb_events.read_scalars(str(port_dir / "tb")) == got
    recs = [json.loads(line) for line in open(port_dir / "train_log.jsonl")]
    for tag in got:
        assert [v for _, v in got[tag]] == [float(np.float32(r[tag]))
                                            for r in recs]


def test_event_file_framing(tmp_path):
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    w = tb_events.EventWriter(str(tmp_path))
    name = os.path.basename(w.path)
    assert re.fullmatch(r"events\.out\.tfevents\.\d{10}\." +
                        re.escape(socket.gethostname()), name)
    first = tb_events.read_events(w.path)
    assert len(first) == 1 and first[0]["file_version"] == "brain.Event:2"
    for step in (1, 2, 3):      # readable after every record
        w.add_scalars({"a": step / 3, "b": -step}, step)
        evs = tb_events.read_events(w.path)
        assert [e["step"] for e in evs[1:]] == [s for s in range(1, step + 1)
                                                for _ in "ab"]
    assert evs[-1]["scalars"] == {"b": -3.0}
    assert evs[1]["scalars"] == {"a": float(np.float32(1 / 3))}
    data = open(w.path, "rb").read()
    with open(w.path, "wb") as f:   # a run killed inside its last record
        f.write(data[:-5])
    assert len(tb_events.read_events(w.path)) == len(evs) - 1
    damaged = bytearray(data)
    damaged[len(data) - 12] ^= 1
    with open(w.path, "wb") as f:
        f.write(bytes(damaged))
    with pytest.raises(ValueError, match="CRC"):
        tb_events.read_events(w.path)


def test_only_rank_0_writes(tmp_path):
    for rank in (0, 1):
        log = MetricLogger(str(tmp_path / f"r{rank}"), interval=1,
                           progress=lambda m: None,
                           mesh=Mesh(rank=rank, world=2))
        log.log(1, {"loss_pix": torch.tensor(0.5)})
    assert tb_events.read_scalars(str(tmp_path / "r0" / "tb")) == {
        "loss_pix": [(1, 0.25)]}
    assert not (tmp_path / "r1" / "tb").exists()
    assert not (tmp_path / "r1" / "train_log.jsonl").exists()


def test_train_cli_writes_tb_events(cli_config):  # noqa: F811
    """Three iterations through ``tools.train`` with an eval at 2: the
    tb/ scalars are the JSONL records' means (the losses and the eval's
    ``val_*``) at their steps, without the extra fields (``lr``,
    ``iters_per_s``)."""
    root, write = cli_config
    trainer = port_train.main([write(), "--device", "cpu", "--seed", "3",
                               "--total-iters", "3"])
    work = trainer.work_dir
    recs = [json.loads(line) for line in open(os.path.join(
        work, "train_log.jsonl"))]
    want = {}
    for r in recs:
        for k, v in r.items():
            if k not in ("step", "time", "lr", "iters_per_s"):
                want.setdefault(k, []).append((r["step"],
                                               float(np.float32(v))))
    assert {"loss_pix", "val_PSNR"} <= set(want)
    assert all("lr" in r for r in recs if "loss_pix" in r)
    assert tb_events.read_scalars(os.path.join(work, "tb")) == want
