"""Adam written out: the moments' updates, bias correction by the step
count, eps outside the square root (Kingma and Ba, Algorithm 1), in place
on the leaves."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, leaves: list, lr: float, b1: float, b2: float, eps: float):
        self.leaves, self.lr, self.b1, self.b2, self.eps = leaves, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
