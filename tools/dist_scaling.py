"""Every card of one machine, one process each over NCCL, against one
process on one card, by chip_smoke.py's dist worker (``dist_run``):

1. config 001 rdn through ``tools.train`` (batch 16 × 48², split over the
   ranks; DIST_ITERS iterations under --deterministic, evals at 2 and 4):
   every rank's weights bit for bit rank 0's, the losses within
   chip_smoke.DIST_LOSS_REL of one process and the weights within
   iterations × lr; the iterations and each rank's peak memory;
2. ``tools.test`` on a Set5-shaped folder and a seeded ``.pth``, the
   pictures strided over the ranks and gathered, then with
   ``--shard-tiles``: every rank's summary within DIST_METRIC_TOL of one
   process's;
3. the flagship's ``predict_tiled`` of the 256² picture at ×4 and ×2.5,
   tile_batch 4, its tiles sharded over the ranks: the ranks' pictures
   bit for bit, within REL_TOL of one process at tile_batch 1, and the
   warm ms a request against one process at tile_batch 4.

Run from the repository root on a machine with several cards (a
temporary working directory holds the data; nothing is downloaded):

    python3 tools/dist_scaling.py
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the repository root in place of tools/ (whose profile.py would shadow the
# standard library's, which torch imports)
sys.path[0] = str(ROOT)

import chip_smoke as cs  # noqa: E402
from ciaosr_torch.config import Config  # noqa: E402
from ciaosr_torch.data.imageio import imread  # noqa: E402
from ciaosr_torch.models.restorers import CiaoSRRestorer  # noqa: E402
from ciaosr_torch.ops.kernels import _build  # noqa: E402


def train(root: Path, n: int, derived: Path, cfg, evals) -> None:
    argv = [str(derived), "--deterministic", "--total-iters",
            str(cs.DIST_ITERS), "--work-dir"]
    runs = {}
    for name, ranks, extra in (("one", 0, []),
                               ("nccl", n, ["--launcher", "pytorch"])):
        work = root / f"work_{name}"
        res, secs = cs.dist_run(f"rdn train {name} ({ranks} ranks)", ranks,
                                "train", root / f"out_{name}",
                                argv + [str(work)] + extra)
        cs.dist_launches(f"rdn train {name}", res, evals(2))
        recs = cs.logged_records(work)
        runs[name] = (res, recs)
        cs.log(f"dist_scaling rdn train {name} ({max(ranks, 1)} card(s), "
               f"global batch 16 x 48^2): iterations 2 and 4 "
               f"{cs.iteration_ms(recs)} ms (loader wait included), each "
               f"rank's peak {[round(r['peak_gib'], 2) for r in res]} GiB, "
               f"devices {[r['device'] for r in res]}, command {secs:.1f} s")
    (one,), o_recs = runs["one"]
    res, recs = runs["nccl"]
    for r in res[1:]:
        cs.same_weights("rank against rank 0", r["weights"],
                        res[0]["weights"])
    losses = [[r["loss_pix"] for r in rs if "loss_pix" in r]
              for rs in (o_recs, recs)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses, strict=True))
    dw = max(float((v - one["weights"]["generator"][k]).abs().max())
             for k, v in res[0]["weights"]["generator"].items())
    w_tol = cs.DIST_ITERS * cfg.optimizers["lr"]
    cs.log(f"dist_scaling: {n} ranks over NCCL against one process: losses "
           f"max rel {rel:.3e} (<= {cs.DIST_LOSS_REL}), weights max|d| "
           f"{dw:.3e} (<= {w_tol}); every rank's weights rank 0's, bit for "
           "bit")
    if not (rel <= cs.DIST_LOSS_REL and dw <= w_tol):
        raise AssertionError("dist_scaling: training left its bounds")


def evaluate(root: Path, n: int, derived: Path, cfg, expected) -> None:
    ckpt = root / "rdn_dist.pth"
    cs.write_checkpoint(ckpt, cfg.model["generator"], seed=3)
    summaries = {}
    for name, ranks, extra in (
            ("one", 0, []), ("strided", n, ["--launcher", "pytorch"]),
            ("tiles", n, ["--launcher", "pytorch", "--shard-tiles"])):
        res, secs = cs.dist_run(f"rdn test {name} ({ranks} ranks)", ranks,
                                "test", root / f"out_test_{name}",
                                [str(derived), str(ckpt)] + extra)
        # sharded or not, the ranks decode every tile once between them
        cs.dist_launches(f"rdn test {name}", res, expected())
        got = [{k: v for k, v in r["summary"].items() if k != "elapsed_s"}
               for r in res]
        if any(g != got[0] for g in got):
            raise AssertionError(f"dist_scaling test {name}: the ranks "
                                 f"differ: {got}")
        summaries[name] = got[0]
        cs.log(f"dist_scaling rdn test {name}: evaluator "
               f"{[round(r['summary']['elapsed_s'], 3) for r in res]} s")
    cs.log(f"dist_scaling eval summaries: {summaries}")
    p = summaries["one"]
    for name in ("strided", "tiles"):
        g = summaries[name]
        if g["n_images"] != p["n_images"] or any(
                abs(g[k] - p[k]) > cs.DIST_METRIC_TOL
                for k in ("PSNR", "SSIM")):
            raise AssertionError(f"dist_scaling test {name}: {g} against "
                                 f"{p}")


def tiles(root: Path, n: int) -> None:
    res, _ = cs.dist_run(f"flagship predict_tiled tile_batch 4 ({n} ranks)",
                         n, "tiles", root / "out_tiles", [])
    one = CiaoSRRestorer(cs.FLAGSHIP, rgb_mean=cs.RGB_MEAN,
                         test_cfg=cs.TEST_CFG, device="cuda", seed=0)
    if {r["checksum"] for r in res} != {cs.weight_checksum(one.generator)}:
        raise AssertionError("dist_scaling tiles: other seeded weights")
    lq = np.random.default_rng(0).random((cs.IMG, cs.IMG, 3),
                                         dtype=np.float32)
    for i, s in enumerate(cs.DIST_SCALES):
        ref = one.predict_tiled(lq, s, cs.TILE, cs.OVERLAP)
        if any(not np.array_equal(r["outs"][i], res[0]["outs"][i])
               for r in res[1:]):
            raise AssertionError(f"dist_scaling tiles x{s}: ranks differ")
        e_abs, e_rel = cs.errors(torch.as_tensor(res[0]["outs"][i]),
                                 torch.as_tensor(ref))
        one.test_cfg = dict(cs.TEST_CFG, tile_batch=4)
        ms_one = cs.request_ms(lambda: one.predict_tiled(
            lq, s, cs.TILE, cs.OVERLAP))
        one.test_cfg = cs.TEST_CFG
        cs.log(f"dist_scaling predict_tiled x{s} {cs.IMG}^2 (4 tiles of "
               f"{cs.TILE}), tile_batch 4: {n} cards "
               f"{[round(r['ms'][i], 1) for r in res]} ms a request (each "
               f"rank), one card {ms_one:.1f} ms; against one process at "
               f"tile_batch 1 max|d|={e_abs:.3e} "
               f"max|d|/max|ref|={e_rel:.3e}")
        if not e_rel <= cs.REL_TOL:
            raise AssertionError(f"dist_scaling tiles x{s}: {e_rel:.3e}")


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print("dist_scaling: needs a machine with several cards",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.log(f"dist_scaling: {n} x {torch.cuda.get_device_name(0)}; build "
           f"{_build.build_all():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        cs.write_div2k(root)
        cs.write_set5(root)
        os.chdir(root)
        try:
            derived = root / "001_rdn_dist.py"
            derived.write_text(Path(cs.config_path(
                "001_localimplicitsr_rdn_")).read_text()
                + cs.TRAIN_CLI_OVERRIDES)
            cfg = Config.fromfile(str(derived))
            tile = cfg.test_cfg["tile"]
            val_lrs = [(h // 4, w // 4) for _, (h, w) in cs.CLI_SET5]
            test_lrs = [imread(f"data/Classical/Set5/LRbicx4/{name}.png"
                               ).shape[:2] for name, _ in cs.CLI_SET5]

            def evals(k):
                want: dict = {}
                for _ in range(k):
                    for key, v in cs.cli_expected(val_lrs, 4, tile, 64, 0,
                                                  {}).items():
                        want[key] = want.get(key, 0) + v
                return want

            train(root, n, derived, cfg, evals)
            evaluate(root, n, derived, cfg, lambda: cs.cli_expected(
                test_lrs, 4, tile, 64, 0, {}))
            tiles(root, n)
        finally:
            os.chdir(cwd)
    cs.log(f"dist_scaling: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
