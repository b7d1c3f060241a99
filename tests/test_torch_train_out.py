"""The port's row-masked trainer writes what it trains: two steps at width 8
on 32^3 on the CPU, and the masks-only .npz that --out writes loads through
models/masks.load_mask_artifact into a model of the same width, equal to
the trained masks; the run prints the trained plan. No jax."""
import numpy as np
import pytest

from e2enet_tpu_torch.models.masks import (BENCH_MASKS, load_mask_artifact,
                                           masked_params)
from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
from e2enet_tpu_torch.training import train_bench_masks as tbm


def test_trainer_out_round_trips(tmp_path, capsys):
    out = tmp_path / "masks.npz"
    model, state = tbm.main(["--steps", "2", "--update-frequency", "1",
                             "--n-batches", "1", "--batch", "1",
                             "--patch", "32", "32", "32", "--device", "cpu",
                             "--out", str(out)])
    printed = capsys.readouterr().out
    assert "trained plan: " in printed and "alive rows" in printed
    assert f"-> {out}" in printed
    fresh = ShiftUNetPlusPlus(1, tbm.NUM_CLASSES, tbm.POOLS,
                              base_num_features=8, device="cpu")
    loaded = load_mask_artifact(out, fresh)
    assert set(loaded) == set(state.masks) == set(masked_params(fresh))
    for name, m in state.masks.items():
        np.testing.assert_array_equal(loaded[name],
                                      m.detach().cpu().float().numpy())
    # the trained masks are sparse (density 0.2)
    assert any(float(m.sum()) < m.numel() for m in state.masks.values())


def test_trainer_refuses_the_committed_artifact():
    with pytest.raises(SystemExit):
        tbm.main(["--steps", "1", "--device", "cpu", "--out",
                  str(BENCH_MASKS)])
