"""Live terminal training dashboard — tail a training JSONL while it grows.

Counterpart of `apps/watch.py` in the JAX package (host only), over the
JSONL that the port's trainers write (`utils/metrics.JSONLLogger`, the same
schema). Capability match for the reference's live 5-panel matplotlib Event Viewer
(reference: visual_landing/rl_worker.py:427-453 — velocity-command/velocity
traces, reward curve, episode markers, redrawn every 20 policy calls) and
the state trainer's progress printout (controller/ppo.py:406-419), re-done
as a dependency-free ANSI terminal dashboard over the structured JSONL the
trainers append (utils/metrics.JSONLLogger): works over ssh, records
nothing extra, and never touches the training process.

Panels:
  1. eval reward        2. solved fraction (train batch + eval)
  3. actor/critic loss  4. episode length / episodes per update
  5. throughput (updates/min) + latest-row table

Usage: watch a live run (refreshes as lines land) or render once (--once,
the CI-testable path):
    python -m autonomous_quadrotor_environment_tpu_torch.apps.watch runs/ctrl/train_128_0.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 60) -> str:
    """Resample to `width` columns and render with eighth-blocks."""
    vals = [v for v in values if v is not None]
    if not vals:
        return "(no data)".ljust(width)
    if len(vals) > width:
        # mean-pool into width buckets
        step = len(vals) / width
        vals = [
            sum(vals[int(i * step): max(int((i + 1) * step), int(i * step) + 1)])
            / max(len(vals[int(i * step): max(int((i + 1) * step), int(i * step) + 1)]), 1)
            for i in range(width)
        ]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    out = "".join(BLOCKS[1 + int((v - lo) / span * (len(BLOCKS) - 2))] for v in vals)
    return out.ljust(width)


def read_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def _col(rows, key):
    # Drop JSON nulls too: a logged None would crash min()/format below.
    return [r[key] for r in rows if r.get(key) is not None]


def render(rows: list[dict], path: str) -> str:
    last = rows[-1] if rows else {}
    lines = []
    lines.append(f"── watch: {path}  ({len(rows)} log rows) " + "─" * 20)

    panels = [
        ("eval reward", "eval_reward"),
        ("eval solved", "eval_solved"),
        ("train solved frac", "solved_frac"),
        ("actor loss", "actor_loss"),
        ("critic loss", "critic_loss"),
        ("episode length", "eval_length"),
        ("episodes / update", "episodes"),
        ("reward / step", "reward_per_step"),
        ("reward / decision", "reward_per_decision"),
    ]
    for title, key in panels:
        col = _col(rows, key)
        if not col:
            continue
        lines.append(
            f"{title:>18} │{sparkline(col)}│ {col[-1]:>10.4g}  (min {min(col):.4g} max {max(col):.4g})"
        )

    ts = _col(rows, "ts")
    if len(ts) >= 2 and ts[-1] > ts[0]:
        upd = _col(rows, "update")
        if len(upd) >= 2:
            rate = (upd[-1] - upd[0]) / (ts[-1] - ts[0]) * 60.0
            lines.append(f"{'throughput':>18} │ {rate:,.1f} updates/min")
    keys = [k for k in last if k not in ("ts",)]
    kv = "  ".join(
        f"{k}={last[k]:.4g}" if isinstance(last[k], float) else f"{k}={last[k]}"
        for k in sorted(keys)[:10]
    )
    lines.append(f"{'latest':>18} │ {kv}")
    return "\n".join(lines)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("jsonl", help="training JSONL to tail")
    p.add_argument("--once", action="store_true", help="render once and exit")
    p.add_argument("--interval", type=float, default=2.0, help="refresh seconds")
    args = p.parse_args(argv)

    if args.once:
        out = render(read_rows(args.jsonl), args.jsonl)
        print(out)
        return out

    last_size = -1
    try:
        while True:
            size = os.path.getsize(args.jsonl) if os.path.exists(args.jsonl) else 0
            if size != last_size:
                last_size = size
                out = render(read_rows(args.jsonl), args.jsonl)
                sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
                sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass  # intentional: ^C is the normal way to leave the live dashboard
    return ""


if __name__ == "__main__":
    main()
