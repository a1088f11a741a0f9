"""Restorers. ``CiaoSRRestorer`` around CiaoSRNet: normalization, the L1
training objective, dense-grid prediction at integer and rational scales,
the per-query fallback, overlap-average tiling and the metric protocol.
``BasicRestorer`` around a fixed-scale net (models/basic_sr.py): the plain
L1 objective, the window-padded full-image predict and the same metrics.

Counterparts of ciaosr_tpu/models/restorers.py::CiaoSRRestorer and
``BasicRestorer``. The modules hold their weights; there is no params
argument.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any

import numpy as np
import torch

from ciaosr_torch.config.registry import MODELS
from ciaosr_torch.core.color import tensor2img
from ciaosr_torch.core.coords import make_coord_cell
from ciaosr_torch.core.metrics import psnr, ssim
from ciaosr_torch.models.builder import build_generator
from ciaosr_torch.parallel.mesh import all_reduce_sum_

# phase-count ceilings of the dense rational decode: the plain route
# loops over the phases in Python (JAX's XLA ceiling); the kernel grids
# over them, so its ceiling only bounds the host tables
_MAX_GRID_PHASES = 128
_MAX_KERNEL_PHASES = 4096


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def as_scale_fraction(s) -> Fraction:
    """A user-facing scale (int, float, str '7/3', Fraction) as an exact
    Fraction. A float is snapped to the nearest rational with denominator
    ≤ 64 only when that lies within 1e-9 of it, so ``2.5`` and ``7/3`` (a
    Python float) become 5/2 and 7/3, and any other float stays exact."""
    if isinstance(s, (Fraction, int, str)):
        return Fraction(s)
    f = Fraction(s)
    snap = f.limit_denominator(64)
    return snap if abs(float(snap) - float(f)) < 1e-9 else f


def tile_layout(h: int, w: int, scale, tile: int,
                tile_overlap: int = 32) -> tuple[int, list[int], list[int]]:
    """``predict_tiled``'s tiles on an h × w LR image at ``scale`` p/q:
    the tile size and the tiles' row and column starts, on the image
    reflect-padded to a multiple of q."""
    q = as_scale_fraction(scale).denominator
    h, w = _ceil_to(h, q), _ceil_to(w, q)
    tile = min(tile, h, w) // q * q
    if tile <= 0:
        raise ValueError(f"tile too small for scale {scale}")
    stride = max(tile - tile_overlap, q) // q * q
    hs = sorted(set(list(range(0, h - tile, stride)) + [h - tile]))
    ws = sorted(set(list(range(0, w - tile, stride)) + [w - tile]))
    return tile, hs, ws


@MODELS.register(name="CiaoSR")
class CiaoSRRestorer:
    """Classical CiaoSR restorer. Runs on ``device`` (default: the
    CUDA device; raises without one unless ``device="cpu"``)."""

    allowed_metrics = {"PSNR": psnr, "SSIM": ssim}

    def __init__(self, generator: dict, rgb_mean=(0.4488, 0.4371, 0.4040),
                 rgb_std=(1.0, 1.0, 1.0), pixel_loss: dict | None = None,
                 train_cfg: Any = None, test_cfg: Any = None, *,
                 device=None, seed: int = 0):
        self.generator = build_generator(generator, device=device, seed=seed)
        self.device = next(self.generator.parameters()).device
        self.rgb_mean = torch.tensor(rgb_mean, dtype=torch.float32,
                                     device=self.device)
        self.rgb_std = torch.tensor(rgb_std, dtype=torch.float32,
                                    device=self.device)
        # stored as the JAX restorer stores them; ``train_forward`` computes
        # the L1 objective both packages compute
        self.pixel_loss_cfg = pixel_loss
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg or {}
        self.eval_bsize = self.generator.eval_bsize

    # ----------------------------------------------------------- forward --
    def normalize(self, img: torch.Tensor) -> torch.Tensor:
        return (img - self.rgb_mean) / self.rgb_std

    def denormalize(self, rgb: torch.Tensor) -> torch.Tensor:
        return rgb * self.rgb_std + self.rgb_mean

    def train_forward(self, lq: torch.Tensor, gt: torch.Tensor,
                      coord: torch.Tensor, cell: torch.Tensor):
        """The normalized L1 training objective (JAX ``train_forward``):
        lq (B, H, W, 3), gt (B, Q, 3) in [0, 1], coord / cell (B, Q, 2).
        Returns (loss, pred)."""
        pred = self.generator(self.normalize(lq), coord, cell)
        loss = torch.mean(torch.abs(pred - self.normalize(gt)))
        return loss, pred

    @torch.inference_mode()
    def _decode(self, lq_tiles: torch.Tensor, sy, sx=None) -> torch.Tensor:
        """Denormalized dense-grid decode at sy × sx, NOT clamped."""
        img = self.generator.decode_grid(self.normalize(lq_tiles), sy, sx)
        return self.denormalize(img)

    def grid_predict(self, lq_tiles: torch.Tensor, scale) -> torch.Tensor:
        """(N, h, w, 3) LR tiles in [0, 1] on the device → (N, h·s, w·s, 3)
        clamped to [0, 1] (JAX ``_grid_fn`` / ``_grid_rational_fn``); a
        rational scale p/q needs q | h and q | w."""
        return torch.clamp(self._decode(lq_tiles, as_scale_fraction(scale)),
                           0.0, 1.0)

    def _to_device(self, lq: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(lq, np.float32),
                               device=self.device)

    def predict(self, lq: np.ndarray, target_shape) -> np.ndarray:
        """Full-image arbitrary-scale SR: lq (H, W, 3) in [0, 1] →
        (th, tw, 3). Integer multiples take the integer dense decode;
        rational targets whose phase count py·px the route can grid take
        the rational dense decode; everything else the chunked per-query
        decode (``eval_bsize`` queries per chunk)."""
        th, tw = target_shape
        h, w = lq.shape[:2]
        sy, sx = Fraction(th, h), Fraction(tw, w)
        limit = _MAX_KERNEL_PHASES if self.generator.use_kernels \
            else _MAX_GRID_PHASES
        if sy >= 1 and sx >= 1 and (
                sy == sx and sy.denominator == 1
                or sy.numerator * sx.numerator <= limit):
            out = torch.clamp(self._decode(self._to_device(lq)[None], sy, sx),
                              0.0, 1.0)
            return out[0].cpu().numpy()
        return self._predict_queries(lq, th, tw)

    @torch.inference_mode()
    def _predict_queries(self, lq: np.ndarray, th: int,
                         tw: int) -> np.ndarray:
        """Per-query decode of the th × tw grid in chunks of eval_bsize
        queries; the last chunk is padded with coord 0 / cell 0.5. The
        features and CSA (None without non-local attention) are computed
        once for all chunks."""
        gen = self.generator
        q = th * tw
        chunk = min(self.eval_bsize or q, q)
        q_pad = _ceil_to(q, chunk)
        coord, cell = make_coord_cell((th, tw), device=self.device)
        if q_pad > q:
            coord = torch.cat([coord, coord.new_zeros(q_pad - q, 2)])
            cell = torch.cat([cell, cell.new_full((q_pad - q, 2), 0.5)])
        x = self.normalize(self._to_device(lq)[None])
        feature = gen.gen_feature(x)
        nl = gen.nl_feature(feature, use_kernel=gen.use_kernels)
        preds = [gen.query_rgb(feature, x, coord[None, i:i + chunk],
                               cell[None, i:i + chunk], nl)
                 for i in range(0, q_pad, chunk)]
        pred = torch.clamp(self.denormalize(torch.cat(preds, 1)), 0.0, 1.0)
        return pred[0, :q].reshape(th, tw, 3).cpu().numpy()

    @torch.inference_mode()
    def predict_tiled(self, lq: np.ndarray, scale, tile: int,
                      tile_overlap: int = 32, mesh=None) -> np.ndarray:
        """Overlap-average tiling with fixed (tile, tile) LR tiles at scale
        p/q. For q > 1 the image is reflect-padded to a multiple of q, the
        tile size and starts snap down to multiples of q (so every HR tile
        position hi·p/q is whole), and the output is cropped to
        round(h·p/q) × round(w·p/q). The tile outputs are averaged on the
        device and clamped once, after the average (a per-tile clamp would
        disagree wherever a prediction leaves [0, 1] under one tile but
        not its neighbour).

        Tiles are decoded in groups of ``test_cfg["tile_batch"]`` (default
        1), one decode a group, in JAX's raster order. Under a ``mesh``
        (parallel/mesh.py) of N ranks a group is widened to
        max(1, tile_batch // N)·N tiles and rank r decodes its r-th share
        of each group into its own sums, which one all-reduce a picture
        adds up before the average: every rank returns the whole picture."""
        scale = as_scale_fraction(scale)
        p, q = scale.numerator, scale.denominator
        h, w = lq.shape[:2]
        th, tw = round(h * p / q), round(w * p / q)
        if q > 1 and (h % q or w % q):
            hp, wp = _ceil_to(h, q), _ceil_to(w, q)
            lq = np.pad(lq, ((0, hp - h), (0, wp - w), (0, 0)),
                        mode="reflect")
            h, w = hp, wp
        tile, hs, ws = tile_layout(h, w, scale, tile, tile_overlap)
        tiles = [(hi, wi) for hi in hs for wi in ws]
        n, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
        share = max(1, int(self.test_cfg.get("tile_batch", 1)) // n)
        out_t = tile * p // q
        lq_t = self._to_device(lq)
        # the sums of the tile outputs (channels 0-2) and their count (3)
        sums = torch.zeros(h * p // q, w * p // q, 4, device=self.device)
        acc, cnt = sums[..., :3], sums[..., 3:]
        for i in range(0, len(tiles), share * n):
            mine = tiles[i + rank * share:i + (rank + 1) * share]
            if not mine:    # the last group may leave a rank nothing
                continue
            outs = self._decode(torch.stack(
                [lq_t[hi:hi + tile, wi:wi + tile] for hi, wi in mine]), scale)
            for (hi, wi), out in zip(mine, outs):
                y0, x0 = hi * p // q, wi * p // q
                acc[y0:y0 + out_t, x0:x0 + out_t] += out
                cnt[y0:y0 + out_t, x0:x0 + out_t] += 1.0
        all_reduce_sum_(mesh, sums)
        out = torch.clamp(acc / cnt, 0.0, 1.0).cpu().numpy()
        return out[:th, :tw]

    def forward_test(self, lq: np.ndarray, target_shape=None,
                     scale=None, mesh=None) -> np.ndarray:
        """Tiled when test_cfg.tile is set (the tiles sharded over
        ``mesh``'s ranks), otherwise full-image; scales may be int, float,
        str ('7/3') or Fraction."""
        cfg = self.test_cfg
        scale = scale if scale is not None else cfg.get("scale")
        if cfg.get("tile"):
            return self.predict_tiled(lq, as_scale_fraction(scale),
                                      int(cfg["tile"]),
                                      int(cfg.get("tile_overlap", 32)),
                                      mesh=mesh)
        if target_shape is None:
            s = float(as_scale_fraction(scale))
            target_shape = (round(lq.shape[0] * s), round(lq.shape[1] * s))
        return self.predict(lq, target_shape)

    def evaluate(self, output: np.ndarray, gt: np.ndarray) -> dict:
        """Metric protocol: uint8 BGR images, crop_border and convert_to
        from test_cfg."""
        cfg = self.test_cfg
        out_img, gt_img = tensor2img(output), tensor2img(gt)
        return {name: self.allowed_metrics[name](
                    out_img, gt_img, crop_border=cfg.get("crop_border", 0),
                    convert_to=cfg.get("convert_to"))
                for name in cfg.get("metrics", ["PSNR"])}


@MODELS.register(name="BasicRestorer")
class BasicRestorer:
    """Fixed-scale restorer around an lq → sr generator (EDSRNet or
    RDNNet): the L1 objective on whole images, a full-image ``predict``
    (the image reflect-padded to ``test_cfg['window_size']``, clamped,
    cropped back) and the PSNR / SSIM protocol. Runs on ``device``
    (default: the CUDA device; raises without one unless
    ``device="cpu"``)."""

    allowed_metrics = {"PSNR": psnr, "SSIM": ssim}
    batch_keys = ("lq", "gt")

    def __init__(self, generator: dict, pixel_loss: dict | None = None,
                 train_cfg: Any = None, test_cfg: Any = None, *,
                 device=None, seed: int = 0):
        self.generator = build_generator(generator, device=device, seed=seed)
        self.device = next(self.generator.parameters()).device
        # stored as the JAX restorer stores them; ``train_forward`` computes
        # the L1 objective both packages compute
        self.pixel_loss_cfg = pixel_loss
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg or {}

    def train_forward(self, lq: torch.Tensor, gt: torch.Tensor):
        """The mean |pred − gt| of lq (B, H, W, 3) and gt (B, H·s, W·s, 3)
        in [0, 1]. Returns (loss, pred)."""
        pred = self.generator(lq)
        return torch.mean(torch.abs(pred - gt)), pred

    @torch.inference_mode()
    def predict(self, lq: np.ndarray, target_shape=None) -> np.ndarray:
        """lq (H, W, 3) in [0, 1] → (H·s, W·s, 3) in [0, 1]: H and W
        reflect-padded up to multiples of ``test_cfg['window_size']``
        (default 1), the generator, a clamp, the output cropped back.
        ``target_shape`` is ignored: the scale is the generator's."""
        h, w = lq.shape[:2]
        win = int(self.test_cfg.get("window_size", 1) or 1)
        ph, pw = _ceil_to(h, win), _ceil_to(w, win)
        if (ph, pw) != (h, w):
            lq = np.pad(lq, ((0, ph - h), (0, pw - w), (0, 0)),
                        mode="reflect")
        x = torch.as_tensor(np.asarray(lq, np.float32), device=self.device)
        sr = torch.clamp(self.generator(x[None]), 0.0, 1.0)[0]
        s = self.generator.upscale_factor
        return sr[:h * s, :w * s].cpu().numpy()

    def forward_test(self, lq: np.ndarray, target_shape=None,
                     scale=None, mesh=None) -> np.ndarray:
        """The full-image ``predict``: nothing tiles, so ``mesh`` changes
        nothing (as in the JAX package)."""
        return self.predict(lq)

    evaluate = CiaoSRRestorer.evaluate
