"""Load reference ``.pth`` checkpoints into the port's generator.

Counterpart of ciaosr_tpu/convert/load.py. The port's modules use the
reference's key names and layouts, so nothing is converted: the mmcv meta
dict is unwrapped (``state_dict``), the EMA copy selected on request, the
``generator.`` prefix stripped (a raw SwinIR-family checkpoint, whose
keys the reference rewrites with ``'^' → 'generator.'``, is taken as it
is), and the keys audited (convert/audit.py) against the generator the
config builds. A fixed-scale generator (EDSRNet / RDNNet, a
``BasicRestorer`` config) loads from the port's own training
checkpoints only: the JAX package converts no reference ``.pth`` of one
either.
"""

from __future__ import annotations

import torch

from ciaosr_torch.convert.audit import audit


def strip_prefix(state_dict: dict, prefix: str = "generator.") -> dict:
    """Drop a module prefix; without it the keys are used as they are
    (the reference's ``revise_keys=(r'^', 'generator.')``)."""
    if any(k.startswith(prefix) for k in state_dict):
        return {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
    return dict(state_dict)


def generator_shapes(gen_cfg: dict) -> dict:
    """Key → shape of the ``state_dict()`` of the generator ``gen_cfg``
    builds (on the meta device: no storage, no init)."""
    from ciaosr_torch.models.builder import make_generator

    with torch.device("meta"):
        net = make_generator(gen_cfg)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def read_pth(path_or_raw) -> dict:
    """A ``.pth`` file's contents (tensors on the CPU); loaded contents
    are returned as they are."""
    if isinstance(path_or_raw, dict):
        return path_or_raw
    # mmcv checkpoints carry a meta dict of plain objects beside the
    # tensors, which weights_only (the default since PyTorch 2.6) refuses
    return torch.load(path_or_raw, map_location="cpu", weights_only=False)


def checkpoint_state_dict(path_or_raw) -> dict:
    """The tensors of a ``.pth`` file (or of its loaded contents): the
    mmcv ``state_dict`` entry, or the file's dict itself."""
    raw = read_pth(path_or_raw)
    return raw.get("state_dict", raw)


def is_port_checkpoint(raw: dict) -> bool:
    """Whether loaded contents are a checkpoint of the port's own
    training (train/checkpoint.py: a top-level ``step`` and the torch
    version in ``meta``)."""
    meta = raw.get("meta")
    return "step" in raw and isinstance(meta, dict) and "torch" in meta


def _fixed_scale(gen_cfg: dict) -> bool:
    """Whether ``gen_cfg`` is a fixed-scale net (EDSRNet, RDNNet); the
    encoder trunks in ``BACKBONES`` are not."""
    from ciaosr_torch.models.basic_sr import FIXED_SCALE

    return gen_cfg.get("type") in FIXED_SCALE


def has_ema(state_dict: dict) -> bool:
    """Whether a checkpoint's tensors hold RealCiaoSR's EMA copy."""
    return any(k.startswith("generator_ema.") for k in state_dict)


def load_torch_checkpoint(path, model_cfg: dict, *, ema: bool = False,
                          strict: bool = False, log=None) -> dict:
    """The state_dict of ``model_cfg['generator']`` from a ``.pth`` file
    (or its loaded contents), for ``generator.load_state_dict(...,
    strict=True)``. ``ema=True`` takes the EMA copy RealCiaoSR saves
    beside the live generator (the weights its inference uses);
    ``strict=True`` makes an unexplained key an error
    (convert/audit.py). A fixed-scale generator takes a checkpoint of the
    port's own training only (KeyError otherwise)."""
    raw = read_pth(path)
    if _fixed_scale(model_cfg["generator"]) and not is_port_checkpoint(raw):
        raise KeyError(
            f"a reference .pth of a {model_cfg['generator']['type']} "
            "(BasicRestorer) config is not loadable: its layout has no "
            "converter, in the JAX package either; the port loads the "
            "checkpoints of its own training runs (tools.train work_dirs)")
    sd = raw.get("state_dict", raw)

    if ema:
        pfx = "generator_ema."
        if not has_ema(sd):
            raise KeyError(
                "ema=True but the checkpoint has no generator_ema.* keys "
                "(not a RealCiaoSR GAN checkpoint?)")
        sd = {k[len(pfx):]: v for k, v in sd.items() if k.startswith(pfx)}

    prefix = "generator." if any(k.startswith("generator.") for k in sd) \
        else None
    return audit(strip_prefix(sd), generator_shapes(model_cfg["generator"]),
                 original_keys=list(sd), prefix=prefix, strict=strict,
                 log=log)
