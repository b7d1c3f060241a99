"""The port's planning modules (e2enet_tpu_torch/models/vram.py and
planning/) against the JAX package's on the CPU: the topology solver and
the VRAM proxy over the spacings and patches of tests/test_topology.py,
the target spacing and one stage's properties over isotropic and
anisotropic grids, and plan_experiment of every registered planner, 3D
and 2D, from one synthetic dataset_properties.pkl per dataset, equal
after the output folder's path is replaced. Nothing here is approximate:
every comparison is exact."""
import dataclasses
import os
import pickle

import numpy as np
import pytest

# each registers its planners
import e2enet_tpu.planning.alternative_planners  # noqa: F401
import e2enet_tpu_torch.planning.alternative_planners  # noqa: F401
from e2enet_tpu.models import vram as jvram
from e2enet_tpu.planning import planner2d as jp2d
from e2enet_tpu.planning import topology as jtopo
from e2enet_tpu.plans import Plans as JPlans
from e2enet_tpu.utils.registry import PLANNERS as JPLANNERS
from e2enet_tpu_torch.models import vram as tvram
from e2enet_tpu_torch.planning import planner2d as tp2d
from e2enet_tpu_torch.planning import topology as ttopo
from e2enet_tpu_torch.plans import Plans as TPlans
from e2enet_tpu_torch.plans import _to_jsonable
from e2enet_tpu_torch.utils.registry import PLANNERS as TPLANNERS
from e2enet_tpu_torch.utils.registry import PREPROCESSORS as TPREPROCESSORS

# the geometries of tests/test_topology.py::test_against_reference_solver
GEOMETRIES = [((1.0, 1.0, 1.0), (128, 128, 128)),
              ((3.0, 0.78, 0.78), (48, 192, 192)),
              ((1.0, 0.5, 0.5), (96, 160, 160)),
              ((5.0, 0.8, 0.8), (20, 192, 192)),
              ((2.5, 0.85, 0.85), (64, 128, 128))]


def same(a, b):
    """Exact equality of nested dicts / lists / arrays / scalars, types of
    containers aside (a tuple equals a list, an OrderedDict a dict)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("spacing,patch", GEOMETRIES)
def test_topology_matches(spacing, patch):
    ours = ttopo.get_pool_and_conv_props(spacing, patch, 4, 999)
    theirs = jtopo.get_pool_and_conv_props(spacing, patch, 4, 999)
    assert same(list(ours), list(theirs))
    for cap in (2, 3):
        assert same(list(ttopo.get_pool_and_conv_props(spacing, patch, 4,
                                                       cap)),
                    list(jtopo.get_pool_and_conv_props(spacing, patch, 4,
                                                       cap)))
    div = ttopo.get_shape_must_be_divisible_by(ours[0])
    assert same(div, jtopo.get_shape_must_be_divisible_by(theirs[0]))
    odd = [p + 3 for p in patch]
    assert same(ttopo.pad_shape(odd, div), jtopo.pad_shape(odd, div))
    assert same(ttopo.pad_shape(odd, 8), jtopo.pad_shape(odd, 8))
    assert ttopo.get_network_numpool(patch) == \
        jtopo.get_network_numpool(patch)
    assert ttopo.get_network_numpool(patch, 3, 6) == \
        jtopo.get_network_numpool(patch, 3, 6)


@pytest.mark.parametrize("spacing,patch", GEOMETRIES)
@pytest.mark.parametrize("deep_supervision,conv_per_stage",
                         [(False, 2), (True, 2), (False, 3)])
def test_vram_matches(spacing, patch, deep_supervision, conv_per_stage):
    npa, pools, _, shp, _ = jtopo.get_pool_and_conv_props(spacing, patch,
                                                          4, 999)
    args = (shp, npa, 32, 320, 2, 4, pools)
    kw = dict(deep_supervision=deep_supervision,
              conv_per_stage=conv_per_stage)
    ours = tvram.compute_approx_vram_consumption(*args, **kw)
    assert ours == jvram.compute_approx_vram_consumption(*args, **kw)
    assert type(ours) is np.int64
    assert (tvram.DEFAULT_BATCH_SIZE_3D, tvram.BASE_NUM_FEATURES_3D,
            tvram.MAX_NUM_FILTERS_3D, tvram.MAX_NUMPOOL_3D,
            tvram.use_this_for_batch_size_computation_3D) == (
        jvram.DEFAULT_BATCH_SIZE_3D, jvram.BASE_NUM_FEATURES_3D,
        jvram.MAX_NUM_FILTERS_3D, jvram.MAX_NUMPOOL_3D,
        jvram.use_this_for_batch_size_computation_3D)
    consts = ("DEFAULT_BATCH_SIZE_2D", "BASE_NUM_FEATURES_2D",
              "MAX_FILTERS_2D", "use_this_for_batch_size_computation_2D")
    assert [getattr(tp2d, c) for c in consts] == \
        [getattr(jp2d, c) for c in consts]
    for max_filters in (320, tp2d.MAX_FILTERS_2D):
        assert tp2d.compute_approx_vram_consumption_2d(
            shp[1:], npa[1:], 32, max_filters, 2, 4, [p[1:] for p in pools],
            conv_per_stage=conv_per_stage) == \
            jp2d.compute_approx_vram_consumption_2d(
                shp[1:], npa[1:], 32, max_filters, 2, 4,
                [p[1:] for p in pools], conv_per_stage=conv_per_stage)


def _properties(kind):
    """A synthetic dataset fingerprint (what DatasetAnalyzer writes)."""
    rng = np.random.RandomState({"ct_large": 0, "mr_aniso": 1,
                                 "ct_small": 2}[kind])
    n = 7
    if kind == "ct_large":
        # 1 mm-ish CT of ~400 x 480 x 480: a 3d_lowres stage is planned
        spacings = [np.array([1.0 + 0.25 * rng.rand(), 0.8, 0.8])
                    for _ in range(n)]
        sizes = [tuple(int(v) for v in (380 + rng.randint(60),
                                        460 + rng.randint(40),
                                        460 + rng.randint(40)))
                 for _ in range(n)]
        modalities = {0: "CT"}
        reductions = [0.9 + 0.1 * rng.rand() for _ in range(n)]
    elif kind == "mr_aniso":
        # two MR modalities, 4-6 mm along the array's last axis and about
        # 0.7 mm in plane, cropping to about half: the 10th-percentile
        # target spacing, a transpose, the nonzero mask
        spacings = [np.array([0.7 + 0.05 * rng.rand(), 0.7,
                              4.0 + 2 * rng.rand()]) for _ in range(n)]
        sizes = [(200 + rng.randint(40), 220 + rng.randint(40),
                  24 + rng.randint(8)) for _ in range(n)]
        modalities = {0: "FLAIR", 1: "T1w"}
        reductions = [0.4 + 0.2 * rng.rand() for _ in range(n)]
    else:
        spacings = [np.array([1.5, 1.0, 1.0]) for _ in range(n)]
        sizes = [(40 + rng.randint(8), 48, 44) for _ in range(n)]
        modalities = {0: "CT"}
        reductions = [1.0] * n
    ident = [f"case_{i:03d}" for i in range(n)]
    intensity = None
    if "CT" in modalities.values():
        intensity = {0: {"median": 40.0, "mean": 35.5, "sd": 120.25,
                         "mn": -1000.0, "mx": 1800.0,
                         "percentile_99_5": 900.0,
                         "percentile_00_5": -800.0,
                         "local_props": {i: {"mean": 1.0} for i in ident}}}
    return ident, {
        "all_sizes": sizes, "all_spacings": spacings,
        "all_classes": [1, 2, 3], "modalities": modalities,
        "intensityproperties": intensity,
        "size_reductions": dict(zip(ident, reductions))}


@pytest.fixture(scope="module", params=["ct_large", "mr_aniso", "ct_small"])
def cropped(request, tmp_path_factory):
    folder = tmp_path_factory.mktemp(f"cropped_{request.param}")
    ident, props = _properties(request.param)
    for i in ident:
        np.savez(folder / f"{i}.npz", data=np.zeros((2, 2, 2, 2)))
    with open(folder / "dataset_properties.pkl", "wb") as f:
        pickle.dump(props, f)
    return request.param, str(folder)


def test_registries_match():
    assert TPLANNERS.keys() == JPLANNERS.keys()
    assert len(TPLANNERS.keys()) == 8
    from e2enet_tpu.utils.registry import PREPROCESSORS as JPREPROCESSORS
    assert TPREPROCESSORS.keys() == JPREPROCESSORS.keys()


@pytest.mark.parametrize("name", sorted(JPLANNERS.keys()))
def test_plan_experiment_matches(cropped, name, tmp_path):
    kind, folder = cropped
    plans = {}
    for pkg, registry in (("jax", JPLANNERS), ("torch", TPLANNERS)):
        out = tmp_path / pkg
        planner = registry.get(name)(folder, str(out))
        got = planner.plan_experiment()
        assert os.path.isfile(planner.plans_fname)
        with open(planner.plans_fname) as f:
            text = f.read().replace(str(out), "<out>")
        plans[pkg] = (got, text, planner)
    (jgot, jtext, jpl), (tgot, ttext, tpl) = plans["jax"], plans["torch"]
    assert same(tpl.get_target_spacing(), jpl.get_target_spacing())
    assert ttext == jtext
    assert os.path.basename(tpl.plans_fname) == \
        os.path.basename(jpl.plans_fname)
    assert (tpl.transpose_forward, tpl.transpose_backward) == \
        (jpl.transpose_forward, jpl.transpose_backward)
    jd, td = _to_jsonable(jgot.to_dict()), _to_jsonable(tgot.to_dict())
    for d in (jd, td):
        d["preprocessed_data_folder"] = "<out>"
    assert same(td, jd)
    stages = tgot.plans_per_stage
    if kind == "ct_large" and "2D" not in name:
        assert len(stages) == 2, "the lowres branch did not run"
    if kind == "mr_aniso":
        assert all(tgot.use_mask_for_norm.values())
        if "customTargetSpacing" not in name:
            assert tgot.transpose_forward == [2, 0, 1]
            median_z = np.median([s[2] for s in _properties(kind)[1][
                "all_spacings"]])
            assert stages[len(stages) - 1].current_spacing[0] < median_z


@pytest.mark.parametrize("kind", ["ct_large", "mr_aniso", "ct_small"])
def test_properties_for_stage_matches(kind, tmp_path):
    """get_target_spacing and get_properties_for_stage at the dataset's
    target spacing and at coarser ones, 3D and 2D."""
    folder = tmp_path / "cropped"
    folder.mkdir()
    ident, props = _properties(kind)
    with open(folder / "dataset_properties.pkl", "wb") as f:
        pickle.dump(props, f)
    for name in ("ExperimentPlanner3D_v21", "ExperimentPlanner2D_v21",
                 "ExperimentPlanner3D_v21_3convs"):
        t = TPLANNERS.get(name)(str(folder), str(tmp_path / "t"))
        j = JPLANNERS.get(name)(str(folder), str(tmp_path / "j"))
        target = t.get_target_spacing()
        assert same(target, j.get_target_spacing())
        median = np.median(np.vstack(props["all_sizes"]), 0)
        for factor in (1.0, 1.37, 2.5):
            spacing = np.array(target) * factor
            for modalities, classes in ((1, 2), (4, 16)):
                args = (spacing, np.array(target), median, len(ident),
                        modalities, classes)
                assert dataclasses.asdict(t.get_properties_for_stage(
                    *args)) == dataclasses.asdict(
                    j.get_properties_for_stage(*args))


def test_plans_files_load_across(cropped, tmp_path):
    """Each package loads the other's plans file to the same Plans, with
    integer keys."""
    _, folder = cropped
    files = {}
    for pkg, registry in (("jax", JPLANNERS), ("torch", TPLANNERS)):
        planner = registry.get("ExperimentPlanner3D_v21")(
            folder, str(tmp_path / pkg))
        planner.plan_experiment()
        files[pkg] = planner.plans_fname
    for loader in (TPlans, JPlans):
        a, b = (loader.load(files[p]).to_dict() for p in ("jax", "torch"))
        for d in (a, b):
            d["preprocessed_data_folder"] = None
        assert same(_to_jsonable(a), _to_jsonable(b))
        for key in ("modalities", "normalization_schemes",
                    "use_mask_for_norm", "plans_per_stage"):
            assert all(type(k) is int for k in a[key]), key
