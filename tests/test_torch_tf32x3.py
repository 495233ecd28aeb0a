"""The 3xTF32 arithmetic of the PPO gradient kernels (B2, B3, B4), emulated
in PyTorch on the CPU: each f32 operand x splits into hi = tf32(x) and lo =
tf32(x - hi), where tf32 rounds to a 10-bit mantissa, to nearest with ties
away from zero (PTX `cvt.rna.tf32.f32`), and a product is lo hi + hi lo +
hi hi with f32 sums, in steps of the tensor cores' depth of 8, as
`csrc/ppo_grad.cuh` forms it.

- At the kernels' shapes the 3-term product is within 1e-6 relative
  Frobenius error of float64; single-pass TF32 is printed beside it.
- The whole gradient of a small minibatch, with the five tensor-core
  products of each head (X W1^T, H1 W2^T, g_h2 W2, g_h2^T H1, g_h1^T X, the
  weight gradients summed per 64-row chunk as the kernels do) formed through
  the split, is within 1e-5 relative Frobenius error per leaf of the f32
  plain version (autograd of `ppo_loss`), so the card's gate of 1e-4 holds
  with room to spare.

No JAX here."""

import math

import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as pf

STD, CLIP, ENT = 0.1, 0.2, 0.006
CHUNK, DEPTH = 64, 8  # the kernels' rows per chunk and MMA depth


def tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32` on float32 x: the nearest value with a 10-bit
    mantissa, ties away from zero (adding half of the dropped 13 bits to the
    magnitude, then clearing them); infinities and NaNs pass."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with f32 sums, depth step by depth step: lo hi, hi lo,
    hi hi, as each warp forms its tiles."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], DEPTH):
        s = slice(k, k + DEPTH)
        acc = acc + al[:, s] @ bh[s]
        acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single-pass TF32, for the record only."""
    return tf32(a) @ tf32(b)


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 2 - 2 ** -23, 1.0 + one_ulp * 1.5,
                      -(1.0 + one_ulp / 2), 3.4028235e38, float("inf"), -float("inf")], dtype=torch.float32)
    want = [1.0, 1.0 + one_ulp, 1.0, 1.0 + 2 * one_ulp, -(1.0 + one_ulp), None,
            float("inf"), -float("inf")]
    got = tf32(x)
    for g, w in zip(got.tolist(), want):
        if w is not None:
            assert g == w
    assert math.isinf(got[5].item())  # the largest float rounds past the largest TF32 value
    assert torch.isnan(tf32(torch.tensor([float("nan")]))).all()
    hi, lo = split(torch.tensor([math.pi, -1e-30, 12345.678], dtype=torch.float32))
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((lo.view(torch.int32) & 0x1FFF) == 0).all()


@pytest.mark.parametrize("m,k,n", [(64, 80, 128), (64, 128, 128), (128, 64, 128)])
def test_three_term_product_keeps_f32_accuracy(m, k, n):
    """X W1^T (K = 80, inputs 75-79 zero), H1 W2^T and g_h2 W2 (K = 128), and
    a chunk's weight gradient g_h2^T H1 (K = 64 rows)."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, n)) * 0.1).astype(np.float32))
    if k == 80:
        a[:, 75:] = 0.0
        b[75:] = 0.0
    want = a.double() @ b.double()
    err3, err1, err32 = rel_fro(mm3(a, b), want), rel_fro(mm1(a, b), want), rel_fro(a @ b, want)
    print(f"\n{m}x{k}x{n}: 3xTF32 {err3:.3e}, single-pass TF32 {err1:.3e}, f32 {err32:.3e}")
    assert err3 <= 1e-6


def _rows(n_rows: int, seed: int):
    """Seeded obs (n, 75) and aux (n, 8) rows with ratios on both sides of
    the clip band, and a seeded model's 12 leaves."""
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((n_rows, 75)) * 0.3).astype(np.float32)
    aux = np.zeros((n_rows, 8), np.float32)
    aux[:, 0:4] = rng.standard_normal((n_rows, 4)) * 0.2
    aux[:, 4] = rng.standard_normal(n_rows) * 0.1 + 1.6
    aux[:, 5:7] = rng.standard_normal((n_rows, 2))
    torch.manual_seed(seed)
    model = ActorCritic(hidden=128, action_std=STD)
    return model, torch.from_numpy(obs), torch.from_numpy(aux)


def _hand_grads(leaves, obs, aux, mm):
    """The kernels' hand-derived loss rows and backward, each head's five
    tensor-core products through ``mm``; the weight gradients summed chunk
    by chunk. Returns the 12 gradients in leaf order."""
    n = obs.shape[0]
    inv_std = 1.0 / STD
    lp_const = 4 * (math.log(STD) + 0.5 * math.log(2 * math.pi))
    lo, hi = 1.0 - CLIP, 1.0 + CLIP
    x = torch.zeros(n, 80)
    x[:, :75] = obs
    grads = []
    for head, (w1, b1, w2, b2, w3, b3) in enumerate((leaves[:6], leaves[6:])):
        w1p = torch.zeros(128, 80)
        w1p[:, :75] = w1
        b1, b2, b3 = b1.reshape(-1), b2.reshape(-1), b3.reshape(-1)
        h1 = torch.tanh(mm(x, w1p.t()) + b1)
        h2 = torch.tanh(mm(h1, w2.t()) + b2)
        out = h2 @ w3.t() + b3
        if head == 0:
            mean = torch.tanh(out)
            z = (aux[:, 0:4] - mean) * inv_std
            ratio = torch.exp(-0.5 * (z * z).sum(1) - lp_const - aux[:, 4])
            adv = aux[:, 6]
            surr1, surr2 = ratio * adv, ratio.clamp(lo, hi) * adv
            in_band = ((ratio > lo) & (ratio < hi)).float()
            g_ratio = -adv / n * torch.where(surr1 <= surr2, torch.ones_like(adv), in_band)
            go = (g_ratio * ratio)[:, None] * z * inv_std * (1 - mean * mean)
        else:
            go = (out - aux[:, 5:6]) / n
        g_h2 = (go @ w3) * (1 - h2 * h2)
        g_h1 = mm(g_h2, w2) * (1 - h1 * h1)
        dw1, dw2 = torch.zeros(128, 80), torch.zeros(128, 128)
        for r in range(0, n, CHUNK):
            s = slice(r, r + CHUNK)
            dw2 = dw2 + mm(g_h2[s].t(), h1[s])
            dw1 = dw1 + mm(g_h1[s].t(), x[s])
        grads += [dw1[:, :75], g_h1.sum(0), dw2, g_h2.sum(0), go.t() @ h2, go.sum(0)]
    return grads


def test_gradient_through_the_split_holds_the_plain_version():
    model, obs, aux = _rows(256, seed=7)
    leaves = [w.detach() for w in pf._leaves(model)]
    _, _, plain = pf.grads_on_rows(model, obs, aux, action_std=STD, clip_eps=CLIP,
                                   entropy_coef=ENT)
    hand = _hand_grads(leaves, obs, aux, mm32)
    split3 = _hand_grads(leaves, obs, aux, mm3)
    single = _hand_grads(leaves, obs, aux, mm1)
    err_hand = [rel_fro(a, b) for a, b in zip(hand, plain)]
    err3 = [rel_fro(a, b) for a, b in zip(split3, plain)]
    err1 = [rel_fro(a, b) for a, b in zip(single, plain)]
    print(f"\nper leaf vs the f32 plain version: f32 hand {max(err_hand):.3e}, "
          f"3xTF32 {max(err3):.3e}, single-pass TF32 {max(err1):.3e} "
          f"({', '.join(f'{e:.1e}' for e in err1)})")
    assert max(err_hand) <= 1e-5  # the hand backward is the plain version's
    assert max(err3) <= 1e-5
