"""Accountable checkpoint loading: which keys a load took, and why the
rest may be left.

Counterpart of ciaosr_tpu/convert/audit.py. The port's modules use the
reference's state_dict key names, so a key is consumed when the
generator's ``load_state_dict`` takes it, and the shapes are checked
against the generator's own ``state_dict()``:

  * a key the generator needs and the checkpoint lacks is an error
    (KeyError naming it), and so is a shape that differs;
  * a checkpoint key the generator does not take must be explained by a
    known-ignored rule (recomputed buffers, the SwinIR upsampler head the
    reference itself throws away, the CSA ``down`` conv of a scale not in
    ``multi_scale``), else it is reported, and with ``strict`` an error;
  * keys outside the ``generator.`` prefix must belong to a restorer
    submodule family the reference saves (EMA copy, discriminator, ...).
"""

from __future__ import annotations

import re

import numpy as np


class ConversionAuditError(RuntimeError):
    """Raised when a checkpoint's shapes do not match the generator, or in
    strict mode when it leaves keys unexplained."""


# Unread keys matching these rules are fine — each rule says why.
_IGNORED_RULES = (
    # SwinIR buffers the port recomputes
    (re.compile(r"\.relative_position_index$"), "buffer recomputed at trace"),
    (re.compile(r"\.attn_mask$"), "buffer recomputed at trace"),
    # Raw-SwinIR checkpoints carry the upsampler head + normalization
    # buffer that the reference builds then discards when used as a CiaoSR
    # encoder
    (re.compile(r"^(conv_before_upsample|upsample|conv_last|conv_up1|"
                r"conv_up2|conv_hr|conv_bicubic)\."),
     "SwinIR upsampler head — discarded by the reference too"),
    (re.compile(r"^mean$"), "SwinIR img-norm buffer — encoder-only use"),
    # The reference CSA always builds `down` even when 2 ∉ multi_scale;
    # it is untrained/unused in that configuration
    (re.compile(r"^cs_attn\.down(x\d+)?\.(weight|bias)$"),
     "CSA downsample conv for a scale not in multi_scale"),
    # CSA's L2-norm floor is a constant buffer in the reference
    # (escape_NaN = 1e-4); the port bakes the constant in
    (re.compile(r"^cs_attn\.escape_NaN$"), "constant buffer (1e-4 L2 floor)"),
)

# Top-level families legitimately stripped when extracting `generator.`
# from a full restorer checkpoint (RealCiaoSR saves all of these).
_STRIPPED_FAMILIES = re.compile(
    r"^(generator_ema|discriminator|perceptual_loss|step_counter|mean|std)"
    r"([.\b]|$)")


def classify_unconsumed(keys):
    """Split unread keys into (explained {key: reason}, unexplained [keys])."""
    explained, unexplained = {}, []
    for k in keys:
        for rx, why in _IGNORED_RULES:
            if rx.search(k):
                explained[k] = why
                break
        else:
            unexplained.append(k)
    return explained, unexplained


def classify_stripped(all_keys, prefix: str):
    """Split keys NOT under ``prefix`` into (known-other-module, unknown)."""
    other, unknown = [], []
    for k in all_keys:
        if k.startswith(prefix):
            continue
        (other if _STRIPPED_FAMILIES.match(k) else unknown).append(k)
    return other, unknown


def shape_mismatches(state_dict: dict, expected: dict) -> list[str]:
    """One line for each key of both whose shape differs from the
    generator's (``expected``: key → shape)."""
    lines = []
    for k in sorted(set(state_dict) & set(expected)):
        v = state_dict[k]
        got = tuple(getattr(v, "shape", np.shape(v)))
        if got != tuple(expected[k]):
            lines.append(f"{k}: shape {got} != model {tuple(expected[k])}")
    return lines


def report(n_consumed: int, unconsumed, *, original_keys=None,
           prefix: str | None = None, strict: bool = False,
           log=print) -> None:
    """Summarize consumption; in strict mode raise on anything unexplained.

    ``original_keys``/``prefix`` describe the pre-strip checkpoint so
    stripped non-generator families are accounted for too.
    """
    explained, unexplained = classify_unconsumed(unconsumed)
    other = unknown_stripped = []
    if original_keys is not None and prefix:
        other, unknown_stripped = classify_stripped(original_keys, prefix)

    log(f"[convert] consumed {n_consumed}/{n_consumed + len(unconsumed)} "
        f"generator keys; {len(explained)} ignored by rule"
        + (f"; {len(other)} keys in other modules "
           f"({', '.join(sorted({k.split('.')[0] for k in other}))})"
           if other else ""))
    for k, why in explained.items():
        log(f"[convert]   ignored {k}: {why}")

    problems = []
    if unexplained:
        problems.append("unconsumed generator keys (the load would drop "
                        "weights!): " + ", ".join(unexplained[:20]))
    if unknown_stripped:
        problems.append("unrecognized non-generator keys: "
                        + ", ".join(unknown_stripped[:20]))
    if problems:
        msg = "; ".join(problems)
        if strict:
            raise ConversionAuditError(msg)
        log(f"[convert] WARNING: {msg}")


def audit(state_dict: dict, expected: dict, *, original_keys=None,
          prefix: str | None = None, strict: bool = False,
          log=None) -> dict:
    """The generator's keys of ``state_dict`` (already stripped of its
    prefix), checked against ``expected`` (the generator's key → shape):
    raises KeyError for a missing key and ConversionAuditError for a shape
    that differs; then ``report``s the rest when ``strict`` or ``log``."""
    missing = [k for k in expected if k not in state_dict]
    if missing:
        raise KeyError(
            f"checkpoint key not found: {missing[0]!r} — the checkpoint "
            "does not match the model config (wrong encoder family, dims, "
            f"or a truncated file); {len(missing)} missing: "
            + ", ".join(missing[:20]))
    bad = shape_mismatches(state_dict, expected)
    if bad:
        raise ConversionAuditError("checkpoint shapes differ from the "
                                   "model's: " + "; ".join(bad[:20]))
    if strict or log is not None:
        report(len(expected), sorted(set(state_dict) - set(expected)),
               original_keys=original_keys, prefix=prefix, strict=strict,
               log=log or (lambda *_: None))
    return {k: state_dict[k] for k in expected}
