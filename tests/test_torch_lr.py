"""The port's learning-rate and momentum schedules
(e2enet_tpu_torch/training/lr.py) against the reference's
(e2enet_tpu/training/lr.py): plain Python on both sides, so every value
over epochs 0-1100 equal to the bit, and ReduceLROnPlateau's learning
rates and state equal over a seeded loss sequence that reduces the rate
more than twice."""
import numpy as np
import pytest

from e2enet_tpu.training import lr as jlr
from e2enet_tpu_torch.training import lr as tlr

EPOCHS = range(0, 1101)


@pytest.mark.parametrize("name, call", [
    ("poly_lr", lambda m, e: m.poly_lr(e, 1101, 1e-2, 0.9)),
    ("warmup_poly_lr", lambda m, e: m.warmup_poly_lr(e, 1101, 1e-2)),
    ("fixed_schedule_lr", lambda m, e: m.fixed_schedule_lr(e, 3e-4)),
    ("fixed_schedule2_lr", lambda m, e: m.fixed_schedule2_lr(e, 1101,
                                                             1e-2)),
    ("cycle_lr", lambda m, e: m.cycle_lr(e)),
    ("cycle_at_end_lr", lambda m, e: m.cycle_at_end_lr(e, 1e-2)),
    ("reduce_momentum", lambda m, e: m.reduce_momentum(e)),
    ("reduce_momentum_095", lambda m, e: m.reduce_momentum(e, 0.95)),
    ("ce_to_dice_weights", lambda m, e: m.ce_to_dice_weights(e, 1000))])
def test_schedule_equals_the_reference(name, call):
    got = [call(tlr, e) for e in EPOCHS]
    want = [call(jlr, e) for e in EPOCHS]
    assert got == want
    assert len(set(map(str, got))) > 2, f"{name} is constant"


def test_reduce_on_plateau_equals_the_reference():
    rng = np.random.RandomState(0)
    # a loss that falls, then stalls in noise for long stretches
    losses = np.concatenate([np.linspace(1.0, 0.5, 40),
                             0.5 + 0.002 * rng.rand(200)]).tolist()
    got, want = tlr.ReduceLROnPlateau(1e-2), jlr.ReduceLROnPlateau(1e-2)
    lrs = []
    for v in losses:
        lrs.append(got.step(v))
        assert lrs[-1] == want.step(v)
        assert got.state_dict() == want.state_dict()
    assert len(set(lrs)) >= 3, "fewer than two reductions"
    restored = tlr.ReduceLROnPlateau(1.0)
    restored.load_state_dict(got.state_dict())
    assert restored.state_dict() == want.state_dict()
