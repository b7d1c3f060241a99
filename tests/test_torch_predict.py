"""Folder prediction end to end: the port's predict_from_folder (through
e2enet_tpu_torch.cli.predict.main with --device cpu, or called directly
for a float32 model) against the JAX package's on the same input folder
and the same checkpoint, written by the JAX package's save_checkpoint.

Two tiny plans at width 8: A, pools [[2,2,2],[2,2,2]] with 32^3 patches;
B, pools [[1,2,2],[2,2,2]] with [16,32,32] patches (the anisotropic layout
of nnU-Net plans, which the port runs on its materialised up-link route).
Each with and without row masks. Two cases: one at the plan's spacing, one
anisotropic (its z spacing over three times its in-plane one) and smaller
than a patch, so padding and both resamplings run.

Tolerances. The fold-averaged probabilities at network resolution
(predict_case's output, captured in both packages): float32 models (JAX at
HIGHEST precision, TF32 off) within 1e-4; bfloat16 models within BF16_TOL.
The npz files hold those probabilities resampled and stored as float16,
so they compare within the same tolerance plus one float16 rounding of
the value (rtol 2^-10). Segmentations equal wherever the reference's top
two probabilities differ by more than the tolerance.
"""
import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import e2enet_tpu.inference.predictor as jpred  # noqa: E402
import e2enet_tpu_torch.inference.predictor as tpred  # noqa: E402
from e2enet_tpu.cli import predict as jcli  # noqa: E402
from e2enet_tpu.io.nifti import NiftiImage, read_nifti, write_nifti  # noqa
from e2enet_tpu.models.unetpp import build_network as jax_build  # noqa: E402
from e2enet_tpu.plans import Plans, StagePlan  # noqa: E402
from e2enet_tpu.training import dsff  # noqa: E402
from e2enet_tpu.training.checkpoint import save_checkpoint  # noqa: E402
from e2enet_tpu.training.train_state import create_train_state  # noqa: E402
from e2enet_tpu_torch.cli import predict as tcli  # noqa: E402

TASK = "Task097_PortPredict"
WIDTH = 8
NUM_FG = 3
F32_TOL = 1e-4
BF16_TOL = 2 ** -8 + 1e-3
PLANS = {"A": ([[2, 2, 2], [2, 2, 2]], [32, 32, 32]),
         "B": ([[1, 2, 2], [2, 2, 2]], [16, 32, 32])}
# (z, y, x) array shapes and ITK (x, y, z) spacings of the two cases
CASES = {"case_000": ((33, 32, 34), (1.0, 1.0, 1.0)),
         "case_001": ((12, 30, 28), (0.7, 0.7, 2.5))}


def make_plans(pools, patch) -> Plans:
    stage = StagePlan(
        batch_size=2, num_pool_per_axis=[sum(p[a] > 1 for p in pools)
                                         for a in range(3)],
        patch_size=list(patch), median_patient_size_in_voxels=[36, 34, 40],
        current_spacing=[1.0, 1.0, 1.0], original_spacing=[1.0, 1.0, 1.0],
        do_dummy_2D_data_aug=False, pool_op_kernel_sizes=pools,
        conv_kernel_sizes=[[1, 3, 3]] * (len(pools) + 1))
    return Plans(
        num_stages=1, num_modalities=1, modalities={0: "CT"},
        normalization_schemes={0: "CT"}, dataset_properties={},
        list_of_npz_files=[], original_spacings=[[1.0, 1.0, 1.0]],
        original_sizes=[[36, 34, 40]], preprocessed_data_folder=None,
        num_classes=NUM_FG, all_classes=list(range(1, NUM_FG + 1)),
        base_num_features=WIDTH, use_mask_for_norm={0: False},
        keep_only_largest_region=None, min_region_size_per_class=None,
        min_size_per_class=None, transpose_forward=[0, 1, 2],
        transpose_backward=[0, 1, 2], data_identifier="nnUNetData_plans_v2.1",
        plans_per_stage={0: stage},
        intensity_properties={0: {"mean": 0.2, "sd": 1.1,
                                  "percentile_00_5": -2.5,
                                  "percentile_99_5": 2.8}})


def numpy_params(net, patch, seed, channels=1):
    """The network's params tree filled from numpy: kernels 0.3 N(0, 1),
    biases and norm offsets 0.1 N(0, 1), norm scales 1 + 0.1 N(0, 1)."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *patch, channels), jnp.float32)
                            )["params"]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        a = rng.randn(*s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return 0.3 * a
        if name == "norm_scale":
            return 1.0 + 0.1 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def write_model(results, plan_name, masked, model="3d_fullres",
                cascade=False, seed=11, folds=(0,)):
    """A model folder under results/nnUNet/<model>/TASK, written by the JAX
    package, one checkpoint per fold (fold f: weights from seed + f, masks
    from key 3 + f); returns the model folder. A cascade model takes the
    lowres stage's one-hot labels beside the image."""
    pools, patch = PLANS[plan_name]
    plans = make_plans(pools, patch)
    stage = plans.plans_per_stage[0]
    n_in = 1 + (NUM_FG if cascade else 0)
    net = jax_build(stage, n_in, NUM_FG + 1, base_num_features=WIDTH,
                    compute_dtype=jnp.float32)
    folder = os.path.join(results, "nnUNet", model, TASK,
                          "TPUTrainer__nnUNetPlansv2.1")
    for f in folds:
        params = numpy_params(net, patch, seed=seed + f, channels=n_in)
        masks = (dsff.init_masks_row(params, 0.5, jax.random.PRNGKey(3 + f),
                                     density_48_override=0.5)
                 if masked else None)
        os.makedirs(os.path.join(folder, f"fold_{f}"))
        save_checkpoint(
            os.path.join(folder, f"fold_{f}",
                         "shiftConvPP_model_final_checkpoint.model"),
            create_train_state(params, masks), 3,
            {"all_tr_losses": [0.9, 0.7],
             "best_val_eval_criterion_MA": 0.5},
            {"init": {"fold": f, "stage": 0, "tconv": "shiftConvPP",
                      "base_num_features": WIDTH, "cascade": cascade},
             "name": "TPUTrainer", "class": "e2enet_tpu.TPUTrainer",
             "plans": plans.to_dict()})
    return folder


def write_cases(folder):
    os.makedirs(folder)
    rng = np.random.RandomState(4)
    for name, (shape, spacing) in CASES.items():
        z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                              indexing="ij")
        vol = 2.0 * np.sin(3 * x + 2 * y) * np.cos(2 * z) + rng.randn(*shape)
        write_nifti(os.path.join(folder, f"{name}_0000.nii.gz"),
                    NiftiImage(vol.astype(np.float32), spacing,
                               (10.0, -4.0, 2.5)))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while this module runs: the port's runs are small,
    and the suite runs its files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    base = tmp_path_factory.mktemp("predict")
    write_cases(str(base / "in"))
    return base


def model_env(env, monkeypatch, plan_name, masked):
    """Write the model once; point RESULTS_FOLDER at it."""
    results = env / f"results_{plan_name}{int(masked)}"
    if not results.exists():
        write_model(str(results), plan_name, masked)
    monkeypatch.setenv("RESULTS_FOLDER", str(results))
    return str(results)


def record(monkeypatch, module):
    """Capture every predict_case output of a predictor module."""
    out = []
    real = module.predict_case

    def spy(bundle, data, *a, **k):
        p = real(bundle, data, *a, **k)
        out.append(np.asarray(p, np.float32))
        return p

    monkeypatch.setattr(module, "predict_case", spy)
    return out


def top_two_gap(p):
    s = np.sort(p, axis=0)
    return s[-1] - s[-2]


def check_probs(port, ref, tol):
    """Within tol of the reference, and the same argmax wherever the
    reference's top two differ by more than tol."""
    assert len(port) == len(ref) == len(CASES)
    for a, b in zip(port, ref):
        assert a.shape == b.shape and a.shape[0] == NUM_FG + 1
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        sure = top_two_gap(b) > tol
        assert (a.argmax(0) == b.argmax(0))[sure].all()


def check_bf16_probs(port, ref, exact):
    """A bfloat16 run of the port against the reference's bfloat16 run,
    both measured from the reference's float32 run of the same folder (the
    rule chip_smoke.py applies on the card): the port's error at most 1.25x
    the reference's, in max and in mean; the same argmax as the float32 run
    wherever its top two differ by more than that error, and as the
    reference's bfloat16 run wherever they differ by more than both."""
    assert len(port) == len(ref) == len(exact) == len(CASES)
    for a, b, e in zip(port, ref, exact):
        assert a.shape == b.shape == e.shape
        err_a, err_b = np.abs(a - e), np.abs(b - e)
        print(f"bf16 error from float32: port max {err_a.max():.3g} mean "
              f"{err_a.mean():.3g}, reference max {err_b.max():.3g} mean "
              f"{err_b.mean():.3g}")
        assert err_a.max() <= 1.25 * err_b.max()
        assert err_a.mean() <= 1.25 * err_b.mean()
        gap = top_two_gap(e)
        assert (a.argmax(0) == e.argmax(0))[gap > 2 * err_a.max()].all()
        both = 2 * (err_a.max() + err_b.max())
        assert (a.argmax(0) == b.argmax(0))[gap > both].all()


def check_outputs(out_t, out_j, mode, tol):
    """The geometry of every written label map, its labels, and in normal
    mode the npz probabilities and the labels where the reference is
    sure."""
    for name, (shape, spacing) in CASES.items():
        a = read_nifti(os.path.join(out_t, f"{name}.nii.gz"))
        b = read_nifti(os.path.join(out_j, f"{name}.nii.gz"))
        assert a.array.shape == b.array.shape == shape
        np.testing.assert_allclose(a.spacing, spacing)
        np.testing.assert_allclose(a.spacing, b.spacing)
        np.testing.assert_allclose(a.origin, b.origin)
        np.testing.assert_allclose(a.direction, b.direction)
        assert a.array.min() >= 0 and a.array.max() <= NUM_FG
        if mode == "normal":
            pa = np.load(os.path.join(out_t, f"{name}.npz"))["softmax"]
            pb = np.load(os.path.join(out_j, f"{name}.npz"))["softmax"]
            pa, pb = pa.astype(np.float32), pb.astype(np.float32)
            np.testing.assert_allclose(pa, pb, rtol=2 ** -10, atol=tol)
            sure = top_two_gap(pb) > tol + 2 ** -10
            assert (a.array == b.array)[sure].all()


RUNS = [(p, m) for p in PLANS for m in (False, True)]


@pytest.fixture(scope="module")
def float32_reference(env):
    """The JAX package's float32 run (normal mode, TTA, npz) of a model,
    once per module: {(plan, masked): (predict_case outputs, out dir)}."""
    cache = {}

    def get(plan_name, masked):
        key = (plan_name, masked)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                results = model_env(env, mp, plan_name, masked)
                probs = record(mp, jpred)
                out = str(env / f"j32_{plan_name}{int(masked)}")
                jpred.predict_from_folder(model_folder(results),
                                          str(env / "in"), out, None, True,
                                          compute_dtype=jnp.float32)
            cache[key] = (probs, out)
        return cache[key]

    return get


def model_folder(results):
    return os.path.join(results, "nnUNet", "3d_fullres", TASK,
                        "TPUTrainer__nnUNetPlansv2.1")


@pytest.mark.parametrize("plan_name,masked", RUNS)
def test_float32_normal_mode_matches_reference(env, monkeypatch,
                                               float32_reference, plan_name,
                                               masked):
    """A float32 model, normal mode with TTA and npz: the exact mode."""
    ref_p, out_j = float32_reference(plan_name, masked)
    results = model_env(env, monkeypatch, plan_name, masked)
    port_p = record(monkeypatch, tpred)
    out_t = str(env / f"t32_{plan_name}{int(masked)}")
    torch.backends.cudnn.allow_tf32 = False
    tpred.predict_from_folder(model_folder(results), str(env / "in"), out_t,
                              None, True, compute_dtype=torch.float32,
                              device="cpu")
    check_probs(port_p, ref_p, F32_TOL)
    check_outputs(out_t, out_j, "normal", F32_TOL)


@pytest.mark.parametrize("plan_name,masked", RUNS)
def test_cli_fast_mode_matches_reference(env, monkeypatch, float32_reference,
                                         plan_name, masked):
    """The CLI's default bfloat16 model in fast mode (argmax at network
    resolution, the label map resampled), both CLIs on the same folder,
    without TTA (--disable_tta; TTA runs in the float32 and the
    --all_in_gpu tests)."""
    exact, _ = float32_reference(plan_name, masked)
    model_env(env, monkeypatch, plan_name, masked)
    ref_p = record(monkeypatch, jpred)
    port_p = record(monkeypatch, tpred)
    segs = []
    real_save = tpred.save_segmentation_nifti

    def save_spy(seg, out, props, order):
        segs.append((seg.copy(), copy.deepcopy(props)))
        return real_save(seg, out, props, order)

    monkeypatch.setattr(tpred, "save_segmentation_nifti", save_spy)
    out_j = str(env / f"jfast_{plan_name}{int(masked)}")
    out_t = str(env / f"tfast_{plan_name}{int(masked)}")
    args = ["-i", str(env / "in"), "-t", TASK, "--mode", "fast",
            "--disable_tta"]
    jcli.main(args + ["-o", out_j])
    tcli.main(args + ["-o", out_t, "--device", "cpu"])
    check_bf16_probs(port_p, ref_p, exact)
    check_outputs(out_t, out_j, "fast", None)
    # the written label maps are the JAX package's export of the port's
    # network-resolution argmax; equal files where the argmaxes are equal
    from e2enet_tpu.inference.export import save_segmentation_nifti
    for (seg, props), p_ref, name in zip(segs, ref_p, CASES):
        want = str(env / "want.nii.gz")
        save_segmentation_nifti(seg, want, props, 1)
        got = read_nifti(os.path.join(out_t, f"{name}.nii.gz")).array
        np.testing.assert_array_equal(got, read_nifti(want).array)
        if np.array_equal(seg, p_ref.argmax(0)):
            np.testing.assert_array_equal(
                got, read_nifti(os.path.join(out_j, f"{name}.nii.gz")).array)


@pytest.mark.parametrize("plan_name", ["A"])
def test_cli_all_in_gpu_matches_reference(env, monkeypatch, float32_reference,
                                          plan_name):
    """The users' fast mode, --all_in_gpu True, on the masked model: the
    bfloat16 probs head and float16 accumulators. Both CLIs in fast mode,
    since the reference cannot export a float16 softmax in normal mode
    where a case resamples its low-res axis on its own (scipy refuses
    float16; the port's resampling copy repairs that). Then the port's
    normal mode with -z on the same folder."""
    exact, _ = float32_reference(plan_name, True)
    model_env(env, monkeypatch, plan_name, True)
    ref_p = record(monkeypatch, jpred)
    port_p = record(monkeypatch, tpred)
    out_j = str(env / f"jgpu_{plan_name}")
    out_t = str(env / f"tgpu_{plan_name}")
    args = ["-i", str(env / "in"), "-t", TASK, "--all_in_gpu", "True"]
    jcli.main(args + ["-o", out_j, "--mode", "fast"])
    tcli.main(args + ["-o", out_t, "--mode", "fast", "--device", "cpu"])
    check_bf16_probs(port_p, ref_p, exact)
    check_outputs(out_t, out_j, "fast", None)
    out_n = str(env / f"tgpu_normal_{plan_name}")
    tcli.main(args + ["-o", out_n, "-z", "--device", "cpu"])
    for name in CASES:
        seg = read_nifti(os.path.join(out_n, f"{name}.nii.gz")).array
        probs = np.load(os.path.join(out_n, f"{name}.npz"))["softmax"]
        assert probs.dtype == np.float16 and np.isfinite(probs).all()
        assert probs.shape[1:] == seg.shape
        np.testing.assert_array_equal(seg, probs.argmax(0))


def test_cascade_matches_reference(env, monkeypatch, tmp_path):
    """The cascade's full-resolution stage on the lowres stage's labels
    (one-hot beside the image, resized to the preprocessed geometry), both
    packages on the JAX package's lowres output, float32, no TTA, fast
    mode; the lowres outputs of both agree where the reference is sure.
    The CLI's -m 3d_cascade_fullres runs the same two calls."""
    results = str(tmp_path / "results")
    lowres = write_model(results, "A", False, model="3d_lowres", seed=12)
    fullres = write_model(results, "A", True, model="3d_cascade_fullres",
                          cascade=True, seed=13)
    monkeypatch.setenv("RESULTS_FOLDER", results)
    kw = dict(do_tta=False, mode="fast")
    low_j, low_t = str(tmp_path / "low_j"), str(tmp_path / "low_t")
    ref_low = record(monkeypatch, jpred)
    port_low = record(monkeypatch, tpred)
    jpred.predict_from_folder(lowres, str(env / "in"), low_j, None, False,
                              compute_dtype=jnp.float32, **kw)
    tpred.predict_from_folder(lowres, str(env / "in"), low_t, None, False,
                              compute_dtype=torch.float32, device="cpu",
                              **kw)
    check_probs(port_low, ref_low, F32_TOL)
    ref_p = record(monkeypatch, jpred)
    port_p = record(monkeypatch, tpred)
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    jpred.predict_from_folder(fullres, str(env / "in"), out_j, None, False,
                              compute_dtype=jnp.float32,
                              segs_from_prev_stage_folder=low_j, **kw)
    tpred.predict_from_folder(fullres, str(env / "in"), out_t, None, False,
                              compute_dtype=torch.float32, device="cpu",
                              segs_from_prev_stage_folder=low_j, **kw)
    check_probs(port_p, ref_p, F32_TOL)
    check_outputs(out_t, out_j, "fast", None)
    with pytest.raises(AssertionError, match="cascade"):
        tpred.predict_from_folder(fullres, str(env / "in"), out_t, None,
                                  False, device="cpu", **kw)
    # the CLI runs the lowres stage first, into <output>_lowres
    cli_out = str(tmp_path / "cli")
    tcli.main(["-i", str(env / "in"), "-o", cli_out, "-t", TASK, "-m",
               "3d_cascade_fullres", "--disable_tta", "--device", "cpu"])
    for folder in (cli_out + "_lowres", cli_out):
        assert sorted(os.listdir(folder)) == [f"{c}.nii.gz" for c in CASES]


def test_two_folds_match_reference(env, monkeypatch, tmp_path):
    """Two folds with differently drawn row masks: each fold's model with
    its own masks baked in, no shared sparse plan (dense masked, as the
    JAX package runs them), the average over the folds; -f picks folds.
    float32, no TTA, fast mode."""
    folder = write_model(str(tmp_path / "results"), "B", True, seed=21,
                         folds=(0, 1))
    bundle = tpred.ModelBundle(folder, None, "shiftConvPP", device="cpu")
    assert len(bundle.fold_models) == 2 and bundle.sparse_plan is None
    one = tpred.ModelBundle(folder, [1], "shiftConvPP", device="cpu")
    assert len(one.fold_models) == 1 and one.sparse_plan is not None
    ref_p = record(monkeypatch, jpred)
    port_p = record(monkeypatch, tpred)
    kw = dict(do_tta=False, mode="fast")
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    jpred.predict_from_folder(folder, str(env / "in"), out_j, None, False,
                              compute_dtype=jnp.float32, **kw)
    tpred.predict_from_folder(folder, str(env / "in"), out_t, None, False,
                              compute_dtype=torch.float32, device="cpu",
                              **kw)
    check_probs(port_p, ref_p, F32_TOL)
    check_outputs(out_t, out_j, "fast", None)


def test_part_sharding_and_overwrite(env, monkeypatch):
    """--part_id/--num_parts take every num_parts-th case; with
    --overwrite_existing 0 a case whose output exists is skipped."""
    model_env(env, monkeypatch, "A", True)
    out = str(env / "parts")
    args = ["-i", str(env / "in"), "-o", out, "-t", TASK, "--mode",
            "fastest", "--device", "cpu"]
    done = tcli.main(args + ["--part_id", "1", "--num_parts", "2"])
    assert [os.path.basename(f) for f in done] == ["case_001.nii.gz"]
    assert sorted(os.listdir(out)) == ["case_001.nii.gz"]
    stamp = os.path.getmtime(os.path.join(out, "case_001.nii.gz"))
    done = tcli.main(args + ["--overwrite_existing", "0"])
    assert [os.path.basename(f) for f in done] == ["case_000.nii.gz"]
    assert os.path.getmtime(os.path.join(out, "case_001.nii.gz")) == stamp
    done = tcli.main(args)
    assert len(done) == 2


def test_refusals(env, monkeypatch, tmp_path):
    """A missing modality file, more than one device, and the card asked
    for where there is none."""
    model_env(env, monkeypatch, "A", False)
    base = ["-o", str(tmp_path / "out"), "-t", TASK, "--device", "cpu"]
    folder = tmp_path / "in"
    folder.mkdir()
    write_nifti(str(folder / "case_000_0001.nii.gz"),
                NiftiImage(np.zeros((4, 4, 4), np.float32), (1, 1, 1)))
    with pytest.raises(AssertionError, match="missing modality"):
        tcli.main(base + ["-i", str(folder)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tcli.main(base + ["-i", str(env / "in"), "--num_devices", "2"])
    bundle = tpred.ModelBundle(
        model_folder(os.environ["RESULTS_FOLDER"]), None, "shiftConvPP",
        device="cpu")
    data = np.zeros((1, 32, 32, 32), np.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tpred.predict_case(bundle, data, num_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["-i", str(env / "in"), "-o", str(tmp_path / "o2"),
                       "-t", TASK])
