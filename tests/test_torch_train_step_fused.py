"""The port's train step against the reference's fused path: the
reference's make_train_step with its model's fused kernels (fused=True, in
interpret mode, float32, no quadrant layout), row masks at density 0.5,
two steps. The port computes the instance-norm statistics of its fused
levels as that path does (one pass), so it is held to it leaf by leaf as
tightly as the step-1 gradients of every comparison, 3e-4 relative L2, over
both steps (comparisons and helpers: test_torch_train_step.py). The fused
path itself lies within the 2e-2 per leaf that
test_torch_train_step.py::test_two_steps_match_reference_float32 allows the
port against the XLA path after step 2: this test holds it there.
"""
import pytest

pytest.importorskip("torch")

import test_torch_train_step as ts  # noqa: E402


def test_two_steps_match_reference_fused_path_float32():
    params, masks, x, targets = ts._setup(0.5)
    fused = ts._reference_steps(params, masks, x, targets, fused=True,
                                fused_interpret=True)
    p0, got, state, tmasks = ts._port_steps(params, masks, x, targets)
    ts._assert_two_steps(got, fused, p0, ts.GRAD_RTOL)
    ts._assert_masks_kept(state, tmasks)
    xla = ts._reference_steps(params, masks, x, targets)
    ts._assert_two_steps(fused, xla, p0, ts.MASKED_STEP2_RTOL)
