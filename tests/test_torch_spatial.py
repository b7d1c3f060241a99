"""Spatial-parallel training of the port (e2enet_tpu_torch/parallel/
halo.py, the (data x space) grid of mesh.py and collectives.py, the halo
rows of the fused block, its backward and the strided transition, and the
steps, losses and norms that reduce over the grid) on gloo ranks on the
CPU, against one rank on the whole batch and against the JAX package's
make_sharded_train_step on a ("data", "space") mesh.

Two spawned worlds serve the module (the `world` fixture, one per grid):
a 1 x 2 grid of two ranks and a 2 x 2 grid of four, each running every
case and returning each rank's results, so each spawn is paid once. Torch
is held to two threads per rank.

- The halo exchange (halo_rows_grad) on 2 and on 4 slabs: its rows and
  its adjoint equal slicing the whole tensor and its autograd, to the bit.
- The fused block (its autograd op: the forward with halo rows, the
  backward exchanging y and gy rows) and the strided transition (its halo
  row, the gradient returned through the exchange), float32 plain
  versions, on 2 slabs (1 x 2) and on 4 (the 2 x 2 world's four ranks as
  one space group, so two slabs are interior): each slab's output within
  1e-6 of the whole op's rows, the summed statistics within 1e-5
  relative, each slab's input gradient within 1e-6 of the whole
  gradient's rows and the summed weight and affine gradients within 1e-5
  relative.
- The model's forward (test_torch_train_step.py's small model, float32,
  with deep supervision) on both grids against one rank's rows and slabs,
  within 1e-5.
- Every STEP_CASES entry of test_torch_parallel.py (two steps; every
  loss, batch dice off, Ranger, Adam, the two schedules, batch norm, row
  masks) on both grids: the same state on every rank to the bit, one
  rank's within RANK_RTOL per leaf (the top-k losses and the row masks
  within SPARSE_RANK_RTOL, the losses also within LOSS_ATOL), and the JAX package's sharded step on
  the matching mesh (make_mesh(devices[:n], spatial_parallel=2)) within
  REF_RTOL, with test_torch_parallel.py's handling of GDL (the reference
  in float64) and of Dice squared and top-k (step 2 from the port's
  state; Dice and Adam: step 2 against the reference's one-device step,
  SPATIAL_STEP2_ONE_DEVICE). The 2 x 2 grid is held to the reference's 1 x 2 mesh: on four
  devices (2 x 2 or 1 x 4) the reference's sharded step takes its
  one-device loss but not its gradient (test_reference_four_device_mesh
  prints both; ROADMAP Queue 3).
- Trainer(num_devices=2, spatial_parallel=2) on dummy batches against one
  device's losses and online counts, and the train CLI with
  --num_devices 2 --spatial_parallel 2 --device cpu through one short
  epoch: rank 0 alone writes the fold, and its checkpoint loads back.
- ShiftUNet, the residual-encoder UNet and the switches that materialise
  every level (full 3D and one-flat-axis convs, group norm, FRN, batch
  norm): logits and gradients on both grids against one rank's.
- The grid's refusals and the dry run, which is a 1 x 2 grid at n = 2.
"""
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from e2enet_tpu_torch.ops import fused_block as tfb  # noqa: E402
from e2enet_tpu_torch.ops import qstride as tqs  # noqa: E402
from e2enet_tpu_torch.parallel import collectives, dryrun, halo  # noqa
from e2enet_tpu_torch.parallel import mesh  # noqa: E402
from test_torch_parallel import (LOSS_ATOL, RANK_LEAF_FLOOR,  # noqa: E402
                                 RANK_RTOL, REF_FLOAT64, REF_RTOL,
                                 REF_STEP2_FROM_PORT_STATE, STEP_CASES,
                                 THREADS, _assert_steps,
                                 _port_model_for, _reference_sharded_steps,
                                 _threads, inputs, one_rank,
                                 run_port_steps)
from test_torch_train_step import MASKED_STEP2_RTOL  # noqa: E402

# name -> (ranks, spatial_parallel)
GRIDS = {"1x2": (2, 2), "2x2": (4, 2)}
# the JAX package's sharded step each grid is held to (module docstring:
# on four devices its gradient is not its own one-device step's)
REFERENCE_MESH = {"1x2": dict(n_devices=2, spatial_parallel=2),
                  "2x2": dict(n_devices=2, spatial_parallel=2)}
SLAB_ATOL = 1e-6          # a slab's rows against the whole op's
SUM_RTOL = 1e-5           # summed statistics and weight gradients
FORWARD_RTOL = 1e-5       # the model's logits, per grid against one rank
# the cases whose gradient runs through fewer terms than the dense default:
# the top-k losses' through their k% voxels (10%), the row masks' through
# half the rows. The slabs' rounding averages less there: their worst
# leaves pass RANK_RTOL of their scale by rounding of the order of float32
# spacing of the largest leaf, where every other case holds within it
SPARSE_RANK_RTOL = 3e-5
SPARSE_CASES = ("loss_topk", "loss_dc_topk", "masked")
# the reference's own step 2 on a space-sharded mesh is further than
# REF_RTOL from its one-device step 2 for Dice and Adam, where its
# data-sharded mesh's is not (test_reference_space_mesh_step2 prints
# both), and so is its step 2 from the port's step-1 state: the grids'
# step 1 is held to the matching mesh, both steps to the reference's
# one-device steps
SPATIAL_STEP2_ONE_DEVICE = ("loss_dice", "adam")
TASK = "Task779_Spatial"
TASK_CASES = {f"case_{i:03d}": (20, 24, 22) for i in range(6)}
CLI_ARGS = ["--task", TASK, "--fold", "0", "--Tconv", "shiftConvPP",
            "--batches", "2", "--val_batches", "1", "--base_features", "8",
            "--fp32", "--epochs", "1", "--device", "cpu", "--num_devices",
            "2", "--spatial_parallel", "2"]
TRAINER_KW = dict(fold=0, base_num_features=8, fp16=False, max_num_epochs=2,
                  num_batches_per_epoch=2, num_val_batches_per_epoch=2,
                  seed=0, dummy_load=True)

# the ops' shapes: two parts (the first with a pending norm) of a block,
# N, D, H, W; H splits into 2 and 4 slabs of even height
OPS_SHAPE = (2, 4, 8, 6)
OPS_PARTS = (4, 4)
OPS_CO = 6


# --------------------------------------------------------------- inputs

def _ops_inputs():
    """Float64-seeded float32 inputs of the ops: parts, affine, kernel,
    bias, the cotangents of y and of the statistics, and the strided
    transition's x, affine, kernel, bias and cotangents."""
    rng = np.random.RandomState(7)
    N, D, H, W = OPS_SHAPE
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    C = sum(OPS_PARTS)
    return dict(
        parts=[f(N, D, H, W, c) for c in OPS_PARTS],
        mult=(1.0 + 0.2 * f(N, OPS_PARTS[0])), off=0.1 * f(N, OPS_PARTS[0]),
        kernel=0.3 * f(OPS_CO, C, 3, 3), bias=0.1 * f(OPS_CO),
        gy=f(N, D, H, W, OPS_CO), gstats=0.01 * f(N, OPS_CO, 2),
        sx=f(N, D, H, W, C), smult=1.0 + 0.2 * f(N, C),
        soff=0.1 * f(N, C), skernel=0.3 * f(2 * C, C, 3, 3),
        sbias=0.1 * f(2 * C), sgy=f(N, D // 2, H // 2, W // 2, 2 * C),
        sgstats=0.01 * f(N, 2 * C, 2))


def _tensors(ops, slab=None):
    """The ops' inputs as leaf tensors that want a gradient; slab
    (index, count): the H slab of the ones with an H axis."""
    def cut(a, f=1):
        if slab is None:
            return a
        i, n = slab
        L = a.shape[2] // n
        return a[:, :, i * L:(i + 1) * L]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()  # noqa
    out = {k: t(v) for k, v in ops.items()
           if k not in ("parts", "gy", "sgy", "sx")}
    out["parts"] = [t(cut(p)) for p in ops["parts"]]
    out["sx"] = t(cut(ops["sx"]))
    out["gy"] = torch.from_numpy(np.ascontiguousarray(cut(ops["gy"])))
    out["sgy"] = torch.from_numpy(np.ascontiguousarray(cut(ops["sgy"])))
    return out


def run_ops(ops, space=None):
    """The fused block and the strided transition, forward and backward,
    on this rank's slab of `space` (the whole tensors without): {name:
    numpy} of outputs, this slab's statistics and every gradient."""
    slab = None if space is None else (torch.distributed.get_rank(space),
                                       torch.distributed.get_world_size(
                                           space))
    t = _tensors(ops, slab)
    aff = (t["mult"], t["off"])
    halos, edge = None, (False, False)
    if space is not None:
        rows = [halo.halo_rows(p, space, 2, 1, 1) for p in t["parts"]]
        halos = tuple([r[i] for r in rows] for i in (0, 1))
        edge = halo.at_edge(space)
    y, stats = tfb.fused_shift_conv_block(
        t["parts"], t["kernel"], t["bias"], [aff, None], halos=halos,
        halo_edge=edge, space=space)
    loss = (y * t["gy"]).sum() + (stats * t["gstats"]).sum()
    wrt = t["parts"] + [t["kernel"], t["bias"], t["mult"], t["off"]]
    g = torch.autograd.grad(loss, wrt)
    out = {"y": y, "stats": stats, "gpart0": g[0], "gpart1": g[1],
           "gkernel": g[2], "gbias": g[3], "gmult": g[4], "goff": g[5]}
    # the strided transition: its top row through the differentiable
    # exchange, whose adjoint adds the row's gradient on its owner
    srow = (None, None)
    if space is not None:
        srow = halo.halo_rows_grad(t["sx"], space, 2, 1, 0)
    sy, sst = tqs.strided_fused(t["sx"], t["smult"], t["soff"],
                                t["skernel"], t["sbias"], (2, 2, 2),
                                halo=srow, edge=edge)
    loss = (sy * t["sgy"]).sum() + (sst * t["sgstats"]).sum()
    wrt = [t[k] for k in ("sx", "smult", "soff", "skernel", "sbias")]
    g = torch.autograd.grad(loss, wrt)
    out.update(sy=sy, sstats=sst, gsx=g[0], gsmult=g[1], gsoff=g[2],
               gskernel=g[3], gsbias=g[4])
    return {k: v.detach().numpy().copy() for k, v in out.items()}


HALO_SHAPE = (2, 3, 8, 4)     # N, C, H (axis 2, split), W


def run_halo(space, top, bottom):
    """This rank's halo rows of its slab of a seeded float64 tensor and
    the slab's gradient of a seeded weighting of them."""
    rng = np.random.RandomState(3)
    X = rng.randn(*HALO_SHAPE)
    r, n = torch.distributed.get_rank(space), \
        torch.distributed.get_world_size(space)
    wt, wb = (rng.randn(n, *HALO_SHAPE[:2], k, HALO_SHAPE[3])
              for k in (top, bottom))
    L = HALO_SHAPE[2] // n
    x = torch.from_numpy(X[:, :, r * L:(r + 1) * L].copy()).requires_grad_()
    a, b = halo.halo_rows_grad(x, space, 2, top, bottom)
    first, last = halo.at_edge(space)
    loss = x.sum() * 0.0
    if not first:
        loss = loss + (a * torch.from_numpy(wt[r])).sum()
    if not last:
        loss = loss + (b * torch.from_numpy(wb[r])).sum()
    loss.backward()
    # the edge's rows are zeros
    assert (first and not a.any()) or not first
    assert (last and not b.any()) or not last
    return (None if first else a.detach().numpy(),
            None if last else b.detach().numpy(), x.grad.numpy())


def _halo_want(n, top, bottom):
    """run_halo's results on every rank from the whole tensor: slices and
    their autograd."""
    rng = np.random.RandomState(3)
    X = torch.from_numpy(rng.randn(*HALO_SHAPE)).requires_grad_()
    wt, wb = (rng.randn(n, *HALO_SHAPE[:2], k, HALO_SHAPE[3])
              for k in (top, bottom))
    L = HALO_SHAPE[2] // n
    rows, loss = [], X.sum() * 0.0
    for r in range(n):
        a = X[:, :, r * L - top:r * L] if r > 0 else None
        b = X[:, :, (r + 1) * L:(r + 1) * L + bottom] if r < n - 1 else None
        if a is not None:
            loss = loss + (a * torch.from_numpy(wt[r])).sum()
        if b is not None:
            loss = loss + (b * torch.from_numpy(wb[r])).sum()
        rows.append((a, b))
    loss.backward()
    return [(None if a is None else a.detach().numpy(),
             None if b is None else b.detach().numpy(),
             X.grad[:, :, r * L:(r + 1) * L].numpy())
            for r, (a, b) in enumerate(rows)]


# ------------------------------------------------------------ the ranks

def run_forward(state_dict, x, grid=None):
    """The small model's deep-supervision logits on this rank's rows and
    slab (the whole batch without a grid)."""
    net = _port_model_for({}, {k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    if grid is not None:
        x, _ = mesh.shard_batch(x, [], grid)
    with torch.no_grad(), collectives.reducing(grid):
        outs = net(torch.from_numpy(np.ascontiguousarray(x)), do_ds=True)
    return [o.numpy() for o in outs]


# the other networks and switches, each a small float32 model: the plain
# conv helpers (ops/blocks.conv3d_*) with their halo rows and the norms
# over the slabs
NETWORKS = {
    "ori": ("unet", {}),
    "resenc": ("resenc", {}),
    "allConv3x3": ("unetpp", dict(conv_kernel=(3, 3, 3))),
    "313": ("unetpp", dict(conv_kernel=(3, 1, 3), do_shift=False)),
    "331": ("unetpp", dict(conv_kernel=(3, 3, 1), do_shift=False)),
    "group_norm": ("unetpp", dict(norm_op="group")),
    "frn": ("unetpp", dict(norm_op="frn")),
    "bn_relu": ("unetpp", dict(norm_op="batch", nonlin="relu")),
}
NETWORK_RTOL = 1e-5
# a bias ahead of a norm has a gradient that is zero but for rounding: at
# most this share of the largest gradient entry
BIAS_ZERO = 1e-3


def run_network(name, x, grid=None):
    """A network of NETWORKS (seed 0) on this rank's rows and slab: its
    deep-supervision logits and the gradient of their sum of squares,
    summed over the grid."""
    from e2enet_tpu_torch.models.resenc import ResidualUNet
    from e2enet_tpu_torch.models.unet import ShiftUNet
    from e2enet_tpu_torch.models.unetpp import ShiftUNetPlusPlus
    from e2enet_tpu_torch.parallel.collectives import all_reduce_sum_, all_sum
    kind, kw = NETWORKS[name]
    cls = {"unet": ShiftUNet, "resenc": ResidualUNet,
           "unetpp": ShiftUNetPlusPlus}[kind]
    net = cls(1, 3, ((2, 2, 2),) * 3, base_num_features=4,
              compute_dtype=torch.float32, device="cpu", **kw)
    net.reset_parameters(0)
    if grid is not None:
        x, _ = mesh.shard_batch(x, [], grid)
    with collectives.reducing(grid):
        outs = net(torch.from_numpy(np.ascontiguousarray(x)), do_ds=True)
        loss = all_sum(sum(o.square().sum() for o in outs))
    params = dict(net.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    if grid is not None:
        all_reduce_sum_(list(grads), grid.world)
    return ([o.detach().numpy() for o in outs],
            {n: g.numpy() for n, g in zip(params, grads)})


def _trainer_losses(task_dir, out, num_devices, spatial_parallel):
    """Two train iterations and one validation iteration of a dummy-load
    trainer: (train losses, validation loss, online tp/fp/fn)."""
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.training.trainer import Trainer
    tr = Trainer(Plans.load(os.path.join(task_dir,
                                         "nnUNetPlansv2.1_plans_3D.json")),
                 output_folder=out, dataset_directory=task_dir,
                 device="cpu", num_devices=num_devices,
                 spatial_parallel=spatial_parallel, **TRAINER_KW)
    tr.initialize(True)
    losses = [float(tr.run_iteration(tr.tr_gen, 1e-2, True))
              for _ in range(2)]
    tr._online_tp, tr._online_fp, tr._online_fn = [], [], []
    val = float(tr.run_iteration(tr.val_gen, 1e-2, False, True))
    counts = [float(t.sum()) for t in (tr._online_tp[0], tr._online_fp[0],
                                       tr._online_fn[0])]
    return losses, val, counts


def _rank_cases(sp, cases, ops, task):
    """Every case on this rank of a grid of spatial size sp."""
    torch.set_num_threads(THREADS)
    n = mesh.world_size()
    grid = mesh.make_grid(n, sp)
    out = {"threads": torch.get_num_threads()}
    out["halo"] = {k: run_halo(grid.space, *k) for k in ((1, 1), (2, 1))}
    out["ops"] = {"2": run_ops(ops, grid.space)}
    if n == 4:
        # four slabs: the whole world as one space group
        out["halo"]["4"] = run_halo(grid.world, 1, 1)
        out["ops"]["4"] = run_ops(ops, grid.world)
    d = cases["default"]
    out["forward"] = run_forward(d[1], d[3], grid)
    out["networks"] = {name: run_network(name, d[3], grid)
                       for name in NETWORKS}
    out["steps"] = {name: run_port_steps(*args, group=grid)[1]
                    for name, args in cases.items()}
    if n == 2:
        base, task_dir, env = task
        out["trainer"] = _trainer_losses(
            task_dir, os.path.join(base, "trainer_grid"), 2, 2)
        os.environ.update(env)
        from e2enet_tpu_torch.cli import train as ttrain
        ttrain.main(CLI_ARGS)
        out["dryrun"] = dryrun._rank_run("cpu")
    return out


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("spatial"))
    paths = chip_smoke.write_train_task(base, TASK, TASK_CASES, (16, 16, 16),
                                        [[2, 2, 2]] * 2, 3)
    env = {"nnUNet_preprocessed": paths["preprocessed"],
           "RESULTS_FOLDER": paths["results"]}
    return base, paths["task"], env


@pytest.fixture(scope="module")
def ops_inputs():
    return _ops_inputs()


@pytest.fixture(scope="module", params=list(GRIDS))
def world(request, inputs, ops_inputs, task):
    n, sp = GRIDS[request.param]
    cases = inputs[0]
    return request.param, mesh.launch(_rank_cases, n, "cpu", sp, cases,
                                      ops_inputs, task)


# ---------------------------------------------------------------- tests

def test_ranks_ran_two_threads(world):
    _, ranks = world
    assert [w["threads"] for w in ranks] == [THREADS] * len(ranks)


def test_halo_rows_equal_slicing(world):
    """halo_rows_grad's rows and adjoint on 2 slabs (each space group)
    and on 4 (the 2 x 2 world as one group) against slicing the whole
    tensor and its autograd, to the bit; zeros at the volume's edge."""
    name, ranks = world
    sp = GRIDS[name][1]
    for key in ((1, 1), (2, 1)):
        want = _halo_want(sp, *key)
        for r, w in enumerate(ranks):
            for got, exp in zip(w["halo"][key], want[r % sp]):
                assert (got is None) == (exp is None)
                if exp is not None:
                    assert np.array_equal(got, exp), (name, key, r)
    if "4" in ranks[0]["halo"]:
        want = _halo_want(4, 1, 1)
        for r, w in enumerate(ranks):
            for got, exp in zip(w["halo"]["4"], want[r]):
                assert (got is None) == (exp is None)
                if exp is not None:
                    assert np.array_equal(got, exp), ("4 slabs", r)


SUMMED = ("stats", "gkernel", "gbias", "gmult", "goff", "sstats",
          "gskernel", "gsbias", "gsmult", "gsoff")
SLABBED = ("y", "gpart0", "gpart1", "sy", "gsx")


def test_ops_on_slabs_equal_whole_op(world, ops_inputs):
    """The fused block and its backward (halo rows in, y and gy rows
    exchanged) and the strided transition (its halo row's gradient
    returned to its owner) on 2 and 4 slabs against the whole op: slabs
    within SLAB_ATOL, sums over the slabs within SUM_RTOL."""
    name, ranks = world
    want = run_ops(ops_inputs)
    sp = GRIDS[name][1]
    for key in ranks[0]["ops"]:
        n = int(key)
        group = (list(range(n)) if n == len(ranks)
                 else list(range(sp)))
        for k in SUMMED:
            got = sum(ranks[r]["ops"][key][k].astype(np.float64)
                      for r in group)
            np.testing.assert_allclose(got, want[k], rtol=SUM_RTOL,
                                       atol=SUM_RTOL * np.abs(want[k]).max(),
                                       err_msg=f"{name} {key} slabs {k}")
        for k in SLABBED:
            got = np.concatenate([ranks[r]["ops"][key][k] for r in group],
                                 axis=2)
            np.testing.assert_allclose(got, want[k], rtol=0,
                                       atol=SLAB_ATOL * max(
                                           1.0, np.abs(want[k]).max()),
                                       err_msg=f"{name} {key} slabs {k}")


def test_forward_equals_one_rank(world, inputs):
    """The model's deep-supervision logits on the grid, each rank's rows
    and slab, against one rank's on the whole batch."""
    name, ranks = world
    n, sp = GRIDS[name]
    d = inputs[0]["default"]
    want = run_forward(d[1], d[3])
    dp = n // sp
    for r, w in enumerate(ranks):
        i, j = r // sp, r % sp
        for got, full in zip(w["forward"], want):
            B, H = full.shape[0], full.shape[2]
            exp = full[i * B // dp:(i + 1) * B // dp,
                       :, j * H // sp:(j + 1) * H // sp]
            np.testing.assert_allclose(got, exp, rtol=FORWARD_RTOL,
                                       atol=FORWARD_RTOL * np.abs(
                                           full).max(), err_msg=name)


@pytest.mark.parametrize("name", list(NETWORKS))
def test_networks_equal_one_rank(world, inputs, name):
    """ShiftUNet, the residual-encoder UNet and the switches that
    materialise every level (full 3D and one-flat-axis convs, group norm,
    FRN, batch norm) on the grid: each rank's logits its rows and slab of
    one rank's, and the gradient of the summed squares over the grid one
    rank's, within NETWORK_RTOL (the logits per element, the gradient per
    leaf in L2; no network raises)."""
    grid_name, ranks = world
    n, sp = GRIDS[grid_name]
    x = inputs[0]["default"][3]
    want_outs, want_grads = run_network(name, x)
    dp = n // sp
    for r, w in enumerate(ranks):
        outs, grads = w["networks"][name]
        i, j = r // sp, r % sp
        for got, full in zip(outs, want_outs):
            B, H = full.shape[0], full.shape[2]
            exp = full[i * B // dp:(i + 1) * B // dp,
                       :, j * H // sp:(j + 1) * H // sp]
            np.testing.assert_allclose(got, exp, rtol=NETWORK_RTOL,
                                       atol=NETWORK_RTOL * np.abs(
                                           full).max(),
                                       err_msg=f"{grid_name} {name}")
        top = max(np.abs(v).max() for v in want_grads.values())
        for k, g in want_grads.items():
            if "bias" in k.rsplit(".", 1)[-1] and np.abs(g).max() <= (
                    BIAS_ZERO * top):
                continue    # a bias ahead of a norm: zero but for rounding
            err = np.linalg.norm(grads[k] - g) / np.linalg.norm(g)
            assert err <= NETWORK_RTOL, (grid_name, name, k, err)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_grid_equals_one_rank(world, one_rank, case):
    """Every rank of the grid ends with the same state, to the bit, within
    RANK_RTOL of one rank on the whole batch per leaf."""
    name, ranks = world
    r0 = ranks[0]["steps"][case]
    for w in ranks[1:]:
        for (b0, p0_, l0, n0), (b1, p1, l1, n1) in zip(r0, w["steps"][case]):
            assert l0 == l1 and n0 == n1, (name, case)
            for k in p0_:
                assert np.array_equal(p0_[k], p1[k]), (name, case, k)
            for f in b0:
                for k in b0[f]:
                    assert np.array_equal(b0[f][k], b1[f][k]), (name, f, k)
    p0, want = one_rank[case]
    rtol = SPARSE_RANK_RTOL if case in SPARSE_CASES else RANK_RTOL
    # the MCC loss is a near-cancelling difference (test_torch_parallel's
    # LOSS_ATOL): four float32 spacings of 1 beside RANK_RTOL
    _assert_steps(r0, want, p0, (rtol, rtol), f"{name} {case}",
                  RANK_LEAF_FLOOR, loss_atol=LOSS_ATOL)


_REFERENCE_RUNS = {}


def _reference(inputs, case, n_devices, spatial_parallel):
    """The reference's sharded steps of a case from its own initial state
    on an n_devices mesh of that spatial size (GDL in float64), computed
    once per module (both grids are held to the same mesh)."""
    key = (case, n_devices, spatial_parallel)
    if key not in _REFERENCE_RUNS:
        cases, refs, _ = inputs
        spec, _, _, x, targets = cases[case]
        params, masks = refs[case]
        # the reference's step donates its state: a copy of the masks
        masks = (None if masks is None else jax.tree_util.tree_map(
            lambda a: jnp.array(np.asarray(a)), masks))
        kw = dict(n_devices=n_devices, spatial_parallel=spatial_parallel)
        if case in REF_FLOAT64:
            with jax.enable_x64(True):
                out = _reference_sharded_steps(spec, params, masks, x,
                                               targets, dtype=jnp.float64,
                                               **kw)
        else:
            out = _reference_sharded_steps(spec, params, masks, x, targets,
                                           **kw)
        _REFERENCE_RUNS[key] = out
    return _REFERENCE_RUNS[key]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_grid_equals_reference_sharded_step(world, one_rank, inputs, case):
    """The grid against the JAX package's sharded step on a ("data",
    "space") mesh (REFERENCE_MESH: the matching 1 x 2 one for both grids,
    module docstring), at test_torch_parallel.py's tolerances."""
    name, ranks = world
    cases, refs, _ = inputs
    spec, _, _, x, targets = cases[case]
    params, masks = refs[case]
    got = ranks[0]["steps"][case]
    mesh_kw = REFERENCE_MESH[name]
    want = _reference(inputs, case, **mesh_kw)
    step2 = MASKED_STEP2_RTOL if masks is not None else REF_RTOL
    what = f"{name} {case}"
    if case in SPATIAL_STEP2_ONE_DEVICE:
        _assert_steps(got[:1], want[:1], one_rank[case][0], (REF_RTOL,),
                      what, loss_atol=LOSS_ATOL)
        want = _reference(inputs, case, 1, 1)
        _assert_steps(got, want, one_rank[case][0], (REF_RTOL, step2),
                      f"{what} against the reference's one device",
                      loss_atol=LOSS_ATOL)
        return
    if case in REF_STEP2_FROM_PORT_STATE:
        _assert_steps(got[:1], want[:1], one_rank[case][0], (REF_RTOL,),
                      what, loss_atol=LOSS_ATOL)
        want = _reference_sharded_steps(spec, params, masks, x, targets,
                                        start=got[0][:2], **mesh_kw)
        _assert_steps(got[1:], want, got[0][1], (step2,),
                      f"{what} from the port's step-1 state",
                      loss_atol=LOSS_ATOL)
        return
    _assert_steps(got, want, one_rank[case][0], (REF_RTOL, step2), what,
                  loss_atol=LOSS_ATOL)


def test_reference_four_device_mesh(inputs):
    """Why the 2 x 2 grid is held to the reference's 1 x 2 mesh: the JAX
    package's sharded step on four devices (a 2 x 2 or a 1 x 4 mesh)
    takes the loss of its one-device step but not its gradient. Printed
    here, with the 1 x 2 mesh's, which is its one-device step's."""
    one, two, four = (_reference(inputs, "default", n, sp)
                      for n, sp in ((1, 1), (2, 2), (4, 2)))
    print(f"reference step 1 (loss, grad norm): one device {one[0][2:]}, "
          f"1 x 2 {two[0][2:]}, 2 x 2 {four[0][2:]}")
    np.testing.assert_allclose(two[0][2:], one[0][2:], rtol=REF_RTOL)
    np.testing.assert_allclose(four[0][2], one[0][2], rtol=REF_RTOL)


@pytest.mark.parametrize("case", ["loss_dice", "adam"])
def test_reference_space_mesh_step2(inputs, case):
    """Why Dice and Adam take step 2 from the port's state against the
    reference: the reference's own step 2 on its 1 x 2 mesh, against its
    one-device step 2 and its 2 x 1 mesh's, worst leaf printed; step 1
    holds within REF_RTOL on both meshes."""
    runs = {(n, sp): _reference(inputs, case, n, sp)
            for n, sp in ((1, 1), (2, 1), (2, 2))}
    one = runs[(1, 1)]
    for key in ((2, 1), (2, 2)):
        worst = []
        for i in range(2):
            b, a = runs[key][i][0], one[i][0]
            worst.append(max(np.linalg.norm(b[f][k] - a[f][k])
                             / np.linalg.norm(a[f][k])
                             for f in a for k in a[f] if np.any(a[f][k])
                             and not k.endswith(".bias")))
        print(f"{case}: reference {key[0] // key[1]} x {key[1]} mesh "
              f"against one device, worst leaf: step 1 {worst[0]:.2e}, "
              f"step 2 {worst[1]:.2e}")
        assert worst[0] <= REF_RTOL, (case, key)


def test_trainer_grid_equals_one_device(world, task):
    """Trainer(num_devices=2, spatial_parallel=2) on dummy batches (each
    rank draws the whole batch from the same seed and keeps its slab):
    the same losses and online counts on both ranks, and one device's on
    the whole batch within 1e-5."""
    name, ranks = world
    if name != "1x2":
        pytest.skip("the trainer runs in the 1 x 2 world")
    base, task_dir, _ = task
    got = [w["trainer"] for w in ranks]
    assert got[0] == got[1]
    want = _trainer_losses(task_dir, os.path.join(base, "trainer_one"),
                           None, 1)
    np.testing.assert_allclose(got[0][0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[0][1], want[1], rtol=1e-5)
    assert got[0][2] == want[2]


def test_cli_trains_on_the_grid(world, task):
    """--num_devices 2 --spatial_parallel 2 --device cpu (its ranks: the 1
    x 2 world) trains one short epoch of a fold: rank 0 alone writes its
    log, checkpoints and validation, and the final checkpoint loads
    back."""
    name, _ = world
    if name != "1x2":
        pytest.skip("the CLI runs in the 1 x 2 world")
    from e2enet_tpu_torch.plans import Plans
    from e2enet_tpu_torch.training.trainer import Trainer
    base, task_dir, env = task
    fold = (Path(env["RESULTS_FOLDER"]) / "nnUNet" / "3d_fullres" / TASK
            / "TPUTrainer__nnUNetPlansv2.1" / "fold_0")
    logs = [f for f in os.listdir(fold) if f.startswith("training_log_")]
    assert len(logs) == 1
    log = open(fold / logs[0]).read()
    assert "a 1 x 2 (data x space) grid" in log
    assert (fold / "validation_raw" / "summary.json").is_file()
    tr = Trainer(Plans.load(os.path.join(task_dir,
                                         "nnUNetPlansv2.1_plans_3D.json")),
                 0, str(fold.parent), dataset_directory=task_dir,
                 device="cpu", base_num_features=8, fp16=False)
    tr.load_checkpoint_file("final_checkpoint", train=False)
    assert tr.epoch == 1 and int(tr.state.step) == 2
    assert np.all(np.isfinite(tr.all_tr_losses + tr.all_val_losses))


def test_dryrun_is_one_by_two(world):
    """The dry run at n = 2 is a 1 x 2 grid, as the JAX package's, with a
    finite loss equal on both ranks; its entry point defaults to the card
    and raises without one rather than moving to the CPU."""
    name, ranks = world
    assert dryrun.spatial_size(2) == 2 and dryrun.spatial_size(4) == 2
    assert dryrun.spatial_size(3) == 1
    if name == "1x2":
        losses = [w["dryrun"] for w in ranks]
        assert np.isfinite(losses[0]) and losses[0] == losses[1]
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="--device cpu"):
            dryrun.main(["--num_devices", "2"])


@pytest.mark.parametrize("args, match", [
    ((4, 3), "spatial_parallel=3 does not divide num_devices=4"),
    ((3, 2), "spatial_parallel=2 does not divide num_devices=3"),
    ((4, 2, 3), "batch 3 not divisible by the data-parallel size 2"),
    ((2, 2, 2, 12, 4), "patch H 12 does not split into 2 slabs"),
    ((2, 2, 2, 11, 1), "patch H 11 does not split into 2 slabs"),
])
def test_grid_refusals(args, match):
    """The grid refuses, naming the numbers: ranks that spatial_parallel
    does not divide, a batch the data rows do not divide (the JAX
    trainer's assert), and a patch H whose slabs the H pools do not
    divide."""
    with pytest.raises(ValueError, match=match):
        mesh.check_grid(*args)


def test_one_device_ignores_spatial_parallel():
    """As the JAX trainer (no mesh on one device), the grid of one rank
    has no space axis; the model's lazy route needs whole volumes."""
    assert mesh.check_grid(1, 1) == 1
    with collectives.reducing(None):
        assert collectives.space_size() == 1
