"""The comparison's arithmetic: the gradient gap on shared rows by the
worst leaf, and the judge, which holds the numbers the traffic file gives
limits for."""

import math

import pytest
import torch

from portbench import compare


def test_grad_diff_is_the_worst_leaf_over_the_larger_of_its_norm_and_the_median():
    ref = [torch.full((4,), 1.0), torch.full((4,), 2.0), torch.full((4,), 1e-6)]
    assert compare.grad_diff([r.clone() for r in ref], ref) == 0.0
    big = [ref[0], ref[1] * 1.01, ref[2]]               # 1% of the largest leaf
    assert compare.grad_diff(big, ref) == pytest.approx(0.01)
    tiny = [ref[0], ref[1], ref[2] + 2e-3]              # a near-zero leaf, against the median
    assert compare.grad_diff(tiny, ref) == pytest.approx(2e-3 * 2 / 2.0)
    assert compare.grad_diff(ref[:2], ref) == math.inf
    assert compare.grad_diff([ref[0], ref[1], torch.full((4,), math.nan)], ref) == math.inf


def test_judge_holds_the_numbers_the_limits_name():
    ok, checks = compare.judge({"a": 1.0, "b": 5.0}, {"a": 2.0})
    assert ok and list(checks) == ["a"]
    ok, checks = compare.judge({"a": 1.0}, {"a": 2.0, "update_gap": 1e-3})
    assert not ok and checks["update_gap"]["value"] == 1e300
