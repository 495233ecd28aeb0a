"""Operations and bytes of the hover controller's train step: the tanh
actor-critic (obs -> N -> N -> {4, 1}), its rollout and its PPO update."""

from __future__ import annotations

ACT = 4
ROWS = 128  # floats of one env's packed state in the rollout kernel's layout
MISC = 16   # floats of one env-step's rollout record besides its obs


def forward_flops(obs: int, hidden: int) -> int:
    """FLOP of one forward pass of actor and critic on one row (105,216 at
    obs 75, hidden 128)."""
    return 2 * (2 * (obs * hidden + hidden * hidden) + hidden * ACT + hidden * 1)


def rollout_flops(b: int, t: int, obs: int, hidden: int) -> float:
    """The rollout's forward passes: actor and critic at every env-step."""
    return float(b) * t * forward_flops(obs, hidden)


def grad_flops_per_row(obs: int, hidden: int) -> int:
    """FLOP per row of one minibatch gradient, per head: the forward
    products, the three weight gradients (as many again), and the data
    gradients through the second and third layers; the inputs take no
    gradient, so none goes through the first (277,248 at 75, 128)."""
    total = 0
    for out in (ACT, 1):
        forward = 2 * (obs * hidden + hidden * hidden + hidden * out)
        total += 2 * forward + 2 * (hidden * out + hidden * hidden)
    return total


def n_params(obs: int, hidden: int) -> int:
    return 2 * (obs * hidden + hidden + hidden * hidden + hidden) + (hidden * ACT + ACT) + (hidden + 1)


def step_flops(b: int, t: int, k_epochs: int, obs: int, hidden: int) -> float:
    """One train step: the rollout's forward passes and K epochs of
    gradients over all T x B rows (the update's minibatches cover the batch
    once an epoch)."""
    return rollout_flops(b, t, obs, hidden) + float(k_epochs) * b * t * grad_flops_per_row(obs, hidden)


def rollout_bytes(b: int, t: int, pool: int, obs: int, hidden: int) -> float:
    """Bytes the whole-rollout kernel must move, each once: the start
    states, the noise, the pool of fresh episodes and the weights read; the
    obs and records of every step and the final states written."""
    floats = ROWS * b + t * ACT * b + pool * ROWS * b + n_params(obs, hidden) \
        + t * obs * b + t * MISC * b + ROWS * b
    return 4.0 * floats


def grad_bytes(rows: int, n_blocks: int, obs: int, hidden: int) -> float:
    """Bytes of one minibatch gradient call, each once: the rows' obs and
    8 aux floats, the block ids and the weights read, the gradients
    written."""
    return 4.0 * (rows * (obs + 8) + n_blocks + 2 * n_params(obs, hidden))
