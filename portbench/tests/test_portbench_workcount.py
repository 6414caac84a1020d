"""The work counts from shapes on the reference network."""
import pytest

from portbench.metrics import work

STAGE_COST_FULL_STEP = 1723.3e9  # the port's stage_cost, B=32 bf16 step


def test_frame_step_matches_stage_cost_but_the_discarded_encoding():
    """The port's `encode_memory_kernels` runs both kernel encoders on a
    new memory frame and keeps the cls one; stage_cost counts the reg
    side it throws away (3 convs on the 7x7 kernel), the reference
    does not."""
    ours = work.frame_step_flops(64, 256, 32)
    reg_side = 2 * 32 * 256 * 256 * 9 * (5 * 5 + 3 * 5 + 5 * 3)
    assert abs(ours + reg_side - STAGE_COST_FULL_STEP) < 0.05e9
    assert work.frame_step_flops(64, 256, 1) * 32 == pytest.approx(ours)


def test_k1_calls_by_formula():
    calls = work.k1_calls(32, 256, 7, 2)
    for (flops, nbytes), m in zip(calls, (1, 1, 7)):
        assert flops == 2 * 32 * m * 256 * 25 * 25 * 55
        out = 32 * m * 25 * 25 * 256
        ins = 32 * 256 * (29 * 29 + 27 * 29 + 29 * 27) \
            + 32 * m * 256 * (25 + 15 + 15)
        assert nbytes == 2 * (out + ins)


def test_train_step_backward_is_twice_its_forward_or_less():
    """Forward and backward; a grouped correlation's backward costs its
    forward twice (torch's formula would multiply it by its groups)."""
    total = work.train_step_flops(64, 256, 12, 4)
    assert 6.5e12 < total < 7.5e12
    assert work.train_step_flops(8, 32, 2, 2) < total / 100
