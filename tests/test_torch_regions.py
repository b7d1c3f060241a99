"""The port's region pieces and pretrained transfer against the JAX
package's (tests/test_variants_zoo.py:87, :231, :243 and
tests/test_components.py:154 on the reference side):

- training/regions.py: resolve_regions, convert_seg_to_regions and
  regions_seg_from_probs equal on seeded labels and probabilities;
- ops/losses.hard_tp_fp_fn_regions equal, and the region losses on the
  region targets equal within 1e-6;
- evaluation/region_based_evaluation.py: the regions of both challenges,
  evaluate_case and evaluate_regions (summary.csv byte for byte, an empty
  region's NaN included) on seeded label maps;
- the sigmoid tile loop (ops/sliding, nonlin="sigmoid") within 1e-5 of
  the JAX package's predict_volume_tiled(nonlin="sigmoid") on a
  position-dependent toy model, without mirroring, with 8 data-flip
  passes and flip-free; sigmoid over a bfloat16 (probs) head raises
  TypeError, and the softmax path is unchanged;
- training/pretrained.py: transfer_matching_params moves the same leaves,
  and the same count, as the JAX function on weights carried across by
  models/weights.from_jax_params (a one-modality source into a
  four-modality, three-region target: the first block and the heads
  stay), from a flax tree with or without its "params" level;
  load_pretrained_weights reads a checkpoint of either package.
"""
import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from e2enet_tpu.evaluation import region_based_evaluation as jre  # noqa
from e2enet_tpu.models.unetpp import ShiftUNetPlusPlus as JaxNet  # noqa
from e2enet_tpu.ops import losses as jl  # noqa: E402
from e2enet_tpu.ops import sliding as js  # noqa: E402
from e2enet_tpu.training import pretrained as jpre  # noqa: E402
from e2enet_tpu.training import regions as jreg  # noqa: E402
from e2enet_tpu_torch.evaluation import \
    region_based_evaluation as tre  # noqa: E402
from e2enet_tpu_torch.io.nifti import NiftiImage, write_nifti  # noqa: E402
from e2enet_tpu_torch.models.weights import (from_jax_params,  # noqa: E402
                                             to_jax_params)
from e2enet_tpu_torch.ops import losses as tl  # noqa: E402
from e2enet_tpu_torch.ops import sliding as ts  # noqa: E402
from e2enet_tpu_torch.training import pretrained as tpre  # noqa: E402
from e2enet_tpu_torch.training import regions as treg  # noqa: E402
from test_torch_sliding import PATCH  # noqa: E402

BRATS = ((1, 2, 3), (2, 3), (3,))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_regions_equal():
    for spec in ("brats", {"a": [1, 2], "b": (2,)}):
        assert treg.resolve_regions(spec) == jreg.resolve_regions(spec)
    assert list(treg.resolve_regions("brats").values()) == list(BRATS)
    with pytest.raises(ValueError):
        treg.resolve_regions("kits")
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 4, (2, 6, 5, 7)).astype(np.int32)
    for regions in (BRATS, ((1, 2), (2,))):
        a = treg.convert_seg_to_regions(seg, regions)
        b = jreg.convert_seg_to_regions(seg, regions)
        assert a.dtype == b.dtype == np.float32
        assert a.shape == (*seg.shape, len(regions))
        np.testing.assert_array_equal(a, b)
    probs = rng.rand(3, 6, 5, 7).astype(np.float32)
    for order in ((1, 2, 3), (3, 1, 2)):
        a = treg.regions_seg_from_probs(probs, order)
        b = jreg.regions_seg_from_probs(probs, order)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_region_counts_and_losses_equal():
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 6, 5, 7, 3).astype(np.float32)
    seg = rng.randint(0, 4, (2, 6, 5, 7))
    t = jreg.convert_seg_to_regions(seg, BRATS)
    got = tl.hard_tp_fp_fn_regions(torch.from_numpy(logits),
                                   torch.from_numpy(t))
    want = jl.hard_tp_fp_fn_regions(jnp.asarray(logits), jnp.asarray(t))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (3,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pred = logits > 0
    np.testing.assert_array_equal(got[0].numpy(),
                                  (pred & (t > 0.5)).sum((0, 1, 2, 3)))
    for name, kw in (("dc_bce", dict(smooth=0.0)), ("dice_regions", {})):
        for bd in (False, True):
            a = tl.make_loss(name, bd, **kw)(torch.from_numpy(logits),
                                             torch.from_numpy(t))
            b = jl.make_loss(name, bd, **kw)(jnp.asarray(logits),
                                             jnp.asarray(t))
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_region_based_evaluation_equal(tmp_path):
    assert tre.get_brats_regions() == jre.get_brats_regions()
    assert tre.get_kits_regions() == jre.get_kits_regions()
    rng = np.random.RandomState(2)
    gt = tmp_path / "gt"
    out = {w: tmp_path / w for w in ("port", "jax")}
    for d in (gt, *out.values()):
        d.mkdir()
    for i in range(3):
        seg = rng.randint(0, 4, (8, 9, 7)).astype(np.uint8)
        pred = np.where(rng.rand(*seg.shape) < 0.3,
                        rng.randint(0, 4, seg.shape), seg).astype(np.uint8)
        if i == 2:
            # no enhancing tumor in either: its Dice is NaN
            seg[seg == 3] = 2
            pred[pred == 3] = 0
        write_nifti(str(gt / f"c{i}.nii.gz"), NiftiImage(seg, (1, 1, 1)))
        for d in out.values():
            write_nifti(str(d / f"c{i}.nii.gz"), NiftiImage(pred, (1, 1, 1)))
    a = tre.evaluate_case(str(out["port"] / "c0.nii.gz"),
                          str(gt / "c0.nii.gz"), BRATS)
    b = jre.evaluate_case(str(out["port"] / "c0.nii.gz"),
                          str(gt / "c0.nii.gz"), BRATS)
    assert a == b
    for regions in (jre.get_brats_regions(), jre.get_kits_regions()):
        ra = tre.evaluate_regions(str(out["port"]), str(gt), regions)
        rb = jre.evaluate_regions(str(out["jax"]), str(gt), regions)
        assert list(ra) == list(rb) == list(regions)
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])
        assert ((out["port"] / "summary.csv").read_bytes()
                == (out["jax"] / "summary.csv").read_bytes())
    text = (out["port"] / "summary.csv").read_text().splitlines()
    assert text[0] == "casename,kidney incl tumor,tumor"
    brats = tre.evaluate_regions(str(out["port"]), str(gt),
                                 tre.get_brats_regions())
    assert np.isnan(brats["enhancing tumor"][2])


def _toy():
    """Region logits x * a_r + B[d, h, w, r]: not flip-equivariant."""
    rng = np.random.RandomState(6)
    a = rng.randn(3).astype(np.float32)
    B = rng.randn(*PATCH, 3).astype(np.float32)
    ta, tB = torch.from_numpy(a), torch.from_numpy(B)

    def jax_apply(params, x):
        return x[..., :1] * jnp.asarray(a) + jnp.asarray(B)[None]

    def torch_apply(x):
        return x[..., :1] * ta + tB[None]
    return jax_apply, torch_apply


@pytest.mark.parametrize("mode", ["none", "data-flip", "flip-free"])
def test_sigmoid_tile_loop_matches(mode):
    """The region validation's tile loop: per-channel sigmoid
    probabilities accumulated as the JAX package's, within 1e-5."""
    from test_torch_sliding import _mirror_fns
    data = np.random.RandomState(3).randn(1, 24, 20, 20).astype(np.float32)
    jax_apply, torch_apply = _toy()
    mirror = mode != "none"
    jfns = tfns = None
    if mode == "flip-free":
        jfns, tfns = _mirror_fns(jax_apply, torch_apply)
    pred = js.make_tiled_predictor(jax_apply, PATCH, 3, do_mirroring=mirror,
                                   mirror_apply_fns=jfns, nonlin="sigmoid")
    ref = js.predict_volume_tiled(jax_apply, {}, data, PATCH, 3,
                                  do_mirroring=mirror, predictor=pred)
    out = ts.predict_volume_tiled(torch_apply, data, PATCH, 3, device="cpu",
                                  do_mirroring=mirror, mirror_apply_fns=tfns,
                                  nonlin="sigmoid")
    assert out.shape == ref.shape == (3, 24, 20, 20)
    assert out.min() >= 0 and out.max() <= 1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # not a softmax: the channels do not sum to 1
    assert np.abs(out.sum(0) - 1).max() > 0.1
    soft = ts.predict_volume_tiled(torch_apply, data, PATCH, 3, device="cpu",
                                   do_mirroring=mirror, mirror_apply_fns=tfns)
    np.testing.assert_allclose(soft.sum(0), 1, atol=1e-5)


def test_sigmoid_over_a_probs_head_raises():
    logits = torch.randn(2, 3, 4, 3)
    torch.testing.assert_close(ts.head_probs(logits, "sigmoid"),
                               torch.sigmoid(logits))
    probs = torch.softmax(logits, -1).bfloat16()
    assert torch.equal(ts.head_probs(probs), probs.float())
    with pytest.raises(TypeError, match="probs head"):
        ts.head_probs(probs, "sigmoid")
    with pytest.raises(ValueError):
        ts.head_probs(logits, "relu")
    data = np.zeros((1, 16, 16, 16), np.float32)

    def probs_head(x):
        return torch.softmax(torch.zeros((*x.shape[:4], 3)), -1).bfloat16()
    with pytest.raises(TypeError):
        ts.predict_volume_tiled(probs_head, data, PATCH, 3, device="cpu",
                                do_mirroring=False, nonlin="sigmoid")


def _jax_params(cin, k, seed):
    net = JaxNet(input_channels=cin, num_classes=k,
                 pool_op_kernel_sizes=((2, 2, 2),) * 2, base_num_features=4,
                 compute_dtype=jnp.float32, remat=False, quadrant=False)
    params = jax.jit(net.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 8, 8, 8, cin), jnp.float32))
    return jax.tree_util.tree_map(np.array, params["params"])


def test_transfer_matching_params_equals_the_reference(tmp_path, capsys):
    src = _jax_params(1, 4, 0)
    tgt = _jax_params(4, 3, 1)
    want, n_want = jpre.transfer_matching_params(tgt, src, verbose=False)
    want = from_jax_params(jax.tree_util.tree_map(np.array, want))
    t_tgt = from_jax_params(tgt)
    t_src = from_jax_params(src)
    moved = {k for k in t_tgt if not torch.equal(want[k], t_tgt[k])}
    assert "context0.block0.kernel" not in moved and moved
    assert all(k.startswith("context") for k in moved)
    for source in (src, {"params": src}):
        got, n = tpre.transfer_matching_params(t_tgt, source, verbose=False)
        assert n == n_want and set(got) == set(t_tgt)
        for k in got:
            assert got[k].dtype == t_tgt[k].dtype
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the same leaves, named
    got, _ = tpre.transfer_matching_params(t_tgt, src)
    names = {line.split()[1] for line in capsys.readouterr().out.splitlines()
             if line.startswith("transferred ")}
    assert names == {k.replace(".", "/") for k in got
                     if k.startswith("context") and k in t_src
                     and t_src[k].shape == t_tgt[k].shape}
    # the leaves not transferred are the target's own tensors
    kept = {k for k in got if k.replace(".", "/") not in names}
    assert kept and all(got[k] is t_tgt[k] for k in kept)
    # load_pretrained_weights from a checkpoint of either package
    from e2enet_tpu.training import checkpoint as jck
    from e2enet_tpu.training.train_state import create_train_state
    from e2enet_tpu_torch.training import checkpoint as tck
    paths = {"jax": str(tmp_path / "jax.model"),
             "port": str(tmp_path / "port.model")}
    jck.save_checkpoint(paths["jax"], create_train_state(src), 3)
    tck.save_checkpoint(paths["port"], to_jax_params(t_src), 3)
    for path in paths.values():
        got = tpre.load_pretrained_weights(copy.copy(t_tgt), path,
                                           verbose=False)
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert os.path.isfile(paths["port"])
