"""Each experiment's entry point measures the card and never falls back to
the CPU: without CUDA its `main` raises SystemExit before it makes any
tensor."""
import importlib

import pytest

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("name,argv", [
    ("shift_conv", []),
    ("exp_cf_fused", []),
    ("exp_cf_fused", ["--v2"]),
    ("exp_pipeline_fwd", []),
    ("exp_int8_mma", []),
])
def test_main_refuses_without_cuda(monkeypatch, name, argv):
    mod = importlib.import_module(f"e2enet_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv + ["--reps", "1"])
