"""How far the wide gradient kernel (B2) and its f32 plain version each sit
from the plain version run in float64, leaf by leaf, on one CUDA card.

    python3 scripts/wide_grad_accuracy.py [--hidden 1024 2048 4096]

For each width: `chip_smoke.py` kernel_options' seeded B2 case (12,288
transposed rows, tile 128, seeds 41 and 42), the 12 leaves' relative
Frobenius errors of the kernel and of the f32 plain version against the
float64 one, and how much the critic's value-error sum cancels there
(sum |v - R| / |sum (v - R)| over the rows, in float64): the critic's bias
gradients are such sums, so their relative errors grow with it. One JSON
line a width, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402

LEAVES = ("actor_w1", "actor_b1", "actor_w2", "actor_b2", "actor_w3", "actor_b3",
          "critic_w1", "critic_b1", "critic_w2", "critic_b2", "critic_w3", "critic_b3")


def width_case(hidden: int) -> dict:
    obs, aux, g = smoke._seeded_t(8, 1536, 41)
    model = smoke._model(hidden, 42)
    blocks = torch.randperm(96, generator=g, device=smoke.DEVICE).to(torch.int32)
    kw = dict(tile=128, compute_dtype="f32", **smoke.ROW_KW)
    _, _, kernel = smoke.pf.fused_ppo_grad_t(model, obs, aux, blocks, **kw)
    _, _, plain = smoke.pf.ppo_grad_t_plain(model, obs, aux, blocks, **kw)
    f64 = copy.deepcopy(model).double()
    _, _, want = smoke.pf.ppo_grad_t_plain(f64, obs.double(), aux.double(), blocks, **kw)
    rows = smoke.pf._gather_rows(obs, blocks, 128).double()
    returns = smoke.pf._gather_rows(aux, blocks, 128)[:, 5].double()
    with torch.no_grad():
        verr = f64(rows)[1] - returns
    err = lambda got: {n: smoke.rel_fro(a.double(), b) for n, a, b in zip(LEAVES, got, want)}
    return {"hidden": hidden, "kernel_vs_f64": err(kernel), "plain_f32_vs_f64": err(plain),
            "value_error_cancellation": (verr.abs().sum() / verr.sum().abs()).item()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden", type=int, nargs="+", default=[1024, 2048, 4096])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wide_grad_accuracy: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for hidden in args.hidden:
        print(json.dumps(width_case(hidden)), flush=True)
    print(smoke.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
