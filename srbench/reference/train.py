"""One plain training step of the generator: the L1 loss of the decoded
queries against their targets, backward, Adam (bias-corrected, as
published by Kingma and Ba), then the EMA copy e·m + p·(1 − m)."""

from __future__ import annotations

import torch


class Adam:
    """Adam over a list of tensors, in float32."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))


def l1_step(model, opt: Adam, ema: list, momentum: float, batch: dict,
            mean: torch.Tensor):
    """One step on ``batch`` (lq (B, H, W, 3), coord / cell (B, Q, 2) and
    the L1 target ``target`` (B, Q, 3), all in [0, 1] but coord / cell).
    Returns (loss, the gradients as Adam received them)."""
    params = opt.params
    x = (batch["lq"] - mean).permute(0, 3, 1, 2)
    pred = model(x, batch["coord"], batch["cell"])
    loss = torch.mean(torch.abs(pred - (batch["target"] - mean)))
    grads = torch.autograd.grad(loss, params)
    opt.step(grads)
    with torch.no_grad():
        for e, p in zip(ema, params):
            e.mul_(momentum).add_(p, alpha=1.0 - momentum)
    return loss.detach(), grads
