"""The port's tensor-parallel QAT training (parallel/tp_train.py, the
layout in parallel/mesh.py) in four processes on the CPU (gloo), held
against the port in one process and against the JAX package's step over
Mesh('data', 'model') with `param_shardings(..., tensor_parallel=True)`
(what `__graft_entry__.dryrun_multichip` trains).

tests/_torch_tp_train_worker.py runs the scenarios on each rank of the
meshes (2, 2) and (1, 4) in a group of four gloo processes and, at the
same time, (1, 2) and (2, 1) in a group of two, from shared inits on
seeded global batches, and saves what each rank computed, params and
momentum gathered whole; the tests here read the ranks' results:
  * param_shardings and int_param_shardings equal to JAX's PartitionSpecs
    leaf by leaf at model 2 and 4 (ResNet-18, ResNet-50, MobileNetV2 and
    MobileNetV1, 10 classes: the classifier stays whole at model 4, the
    depthwise layers always);
  * shard_params then gather_params gives the tree back;
  * the floating_wo_clip step of a ResNet-18 at 16 px (10 classes, global
    batch 16) against the port's one process and JAX's mesh step, with the
    limits of tests/test_torch_dist.py::test_float_dp_step_matches_one_
    process_and_jax; its second step from the same start;
  * layer chains in train mode (cut ResNet convs and classifier, a
    MobileNetV2 block whose depthwise layer runs whole) against one
    process: outputs and every gradient, alpha's too (whole MobileNetV2
    steps are not compared: at 32 px one ulp moves their updates by 2%);
  * the QAT train step and a calib step: every fraclen EMA equal to one
    process's, BN within QAT_BN_LIMIT, layer by layer (the QAT forward is
    chaotic end to end: it is not compared whole);
  * the eval forward against the replicated one within
    tests/test_parallel.py::test_tp_sharded_eval_matches_replicated's atol;
  * every rank's params, state and momentum bitwise alike after every
    step (the replicas along the data line, the gathered slices along the
    model line);
  * on a model axis of one rank, (2, 1), the mesh's step bitwise the
    data-parallel step.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
import _torch_tp_train_worker as worker

from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.parallel import batch_sharding, make_mesh, param_shardings as jax_param_shardings
from f8net_tpu.parallel import int_param_shardings as jax_int_param_shardings
from f8net_tpu.train import loop as jax_loop
from f8net_tpu.train import optim as jax_optim
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils.config import TrainConfig as JaxTrainConfig
from f8net_tpu_torch.export import qat_to_numpy
from f8net_tpu_torch.parallel.mesh import tp_layers
from f8net_tpu_torch.quant import reset_bn_for_calib
from f8net_tpu_torch.train import make_eval_step, make_train_step, sgd_init
from f8net_tpu_torch.train.optim import SGDState
from f8net_tpu_torch.utils import TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TP_MESHES = ((1, 2), (2, 2), (1, 4))
LINE_MESHES = ((1, 2), (1, 4))  # the model lines (a (2, 2) mesh's is (1, 2)'s)
# as tests/test_torch_dist.py: the QAT step's BN running statistics against
# one process, as a share of each tensor's largest element
QAT_BN_LIMIT = 1e-5
EVAL_ATOL = 2e-4  # tests/test_parallel.py::test_tp_sharded_eval_matches_replicated


def _mesh_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mesh_step(shape, p0, state0, cfg):
    """JAX's jitted step on Mesh(data, model): params out-channel sharded
    by param_shardings(..., tensor_parallel=True), state and momentum
    replicated, the global batch over 'data'."""
    d, m = shape
    pnp, snp = qat_to_numpy(p0, state0)
    jmodel = jax_get_model("resnet18", JaxQuantConfig(**cfg), worker.CLASSES, worker.SIZE)
    mesh = make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    repl, bsh = NamedSharding(mesh, P()), batch_sharding(mesh)
    psh = jax_param_shardings(jmodel.graph, pnp, mesh, tensor_parallel=True)
    jp = jax.tree_util.tree_map(lambda a, s: jax.device_put(jnp.asarray(a), s), pnp, psh,
                                is_leaf=lambda v: not isinstance(v, dict))
    images, labels = worker.global_batch(1)
    jstep = jax_loop.make_train_step(jmodel, jmodel.cfg, JaxTrainConfig(**worker.TRAIN_KW))
    jp, js, jo, jm = jstep(jp, jax.device_put(jax.tree.map(jnp.asarray, snp), repl),
                           jax.device_put(jax_optim.sgd_init(jp), repl),
                           jax.device_put(jnp.asarray(images), bsh),
                           jax.device_put(jnp.asarray(labels), bsh), 0.01)
    return (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js),
            jax.tree.map(np.asarray, jo.momentum), {k: float(v) for k, v in jm.items()})


def _one_process_steps(cfg, steps, family="resnet18", classes=worker.CLASSES, size=worker.SIZE,
                       batch=worker.GLOBAL_BATCH):
    """The worker's train_steps in one process on the global batches:
    (init params, [(params, state, momentum, metrics) per step])."""
    model, (params, state) = worker.init(cfg, family, classes, size)
    p0 = worker._copy(params)
    step = make_train_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW))
    opt = sgd_init(params)
    out = []
    for i in range(steps):
        images, labels = worker.global_batch(1 + i, batch, size, classes)
        params, state, opt, m = step(params, state, opt, torch.from_numpy(images),
                                     torch.from_numpy(labels), 0.01)
        out.append((worker._copy(params), worker._copy(state), worker._copy(opt.momentum),
                    {k: float(v) for k, v in m.items()}))
    return p0, out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the one-process references, {mesh: JAX's
    mesh step}): the ranks run while the JAX steps compile."""
    out = tmp_path_factory.mktemp("tp_train")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    groups = [(world, _free_port()) for world in worker.MESHES]
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_tp_train_worker.py"),
                               str(port), str(r), str(world), str(out)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for world, port in groups for r in range(world)]
    try:
        _, (_, state0) = worker.init(worker.FLOAT)
        p0, _ = _one_process_steps(worker.FLOAT, 0)
        # one compile at a time: XLA's own threads fill the cores the ranks
        # leave, and a rank held off its core stalls the others
        jax_steps = {m: _jax_mesh_step(m, p0, state0, worker.FLOAT) for m in TP_MESHES}
        refs = dict(
            float=_one_process_steps(worker.FLOAT, 1),
            qat=_one_process_steps(worker.QAT, 1),
            chains={case[0]: worker.chain(case) for case in worker.CHAINS},
            calib=_calib_reference(), eval=_eval_reference())
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:  # exact-PID cleanup only
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{p.args[2:5]} failed:\n{log[-4000:]}"
    # each rank's results, by mesh, from both groups (rank r of each)
    ranks = [{} for _ in range(WORLD)]
    for world, _ in groups:
        for r in range(world):
            path = out / f"w{world}-rank{r}.pt"
            ranks[r].update(torch.load(path, weights_only=False))
            os.remove(path)  # a rank 0 file holds about 0.3 GB of trees
    refs["second"] = _second_step_reference(ranks[0][(1, 2)]["float_steps"][0])
    return ranks, refs, jax_steps


def _second_step_reference(first):
    """One process's second float step from the mesh's first step's
    params, state and momentum (gathered): at 16 px one ulp of a layer's
    weights in step 1 moves the head's update in step 2 by 0.24% of its
    largest element, so step 2 is compared from the same start."""
    model, _ = worker.init(worker.FLOAT)
    params, state, mom = (worker._copy(t) for t in first[:3])
    step = make_train_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW))
    images, labels = worker.global_batch(2)
    p1 = worker._copy(params)
    params, state, opt, m = step(params, state, SGDState(mom), torch.from_numpy(images),
                                 torch.from_numpy(labels), 0.01)
    return p1, (params, state, opt.momentum, {k: float(v) for k, v in m.items()})


def _calib_reference():
    model, (params, state) = worker.init(worker.QAT)
    step = make_eval_step(model, model.cfg, TrainConfig(**worker.TRAIN_KW), mode="calib")
    images, labels = worker.global_batch(9)
    return step(params, reset_bn_for_calib(state), torch.from_numpy(images),
                torch.from_numpy(labels))[0]


def _eval_reference():
    model, (params, state) = worker.init(worker.QAT, classes=worker.EVAL_CLASSES,
                                         size=worker.EVAL_SIZE)
    with torch.no_grad():
        return model.apply(params, state, torch.from_numpy(worker.eval_images()), "eval")[0]


def _ranks_of(shape):
    return range(shape[0] * shape[1])


def _same(a, b, what):
    """Two {layer: {name: tensor}} trees bitwise equal."""
    assert list(a) == list(b), what
    for lname, sub in a.items():
        for k, v in sub.items():
            assert torch.equal(v, b[lname][k]), f"{what}: {lname}/{k}"


def _close(got, want, rtol, what):
    """Each tensor within rtol of the reference tensor's largest element."""
    for lname, sub in want.items():
        for k, w in sub.items():
            w = np.asarray(w)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(np.asarray(got[lname][k]), w, rtol=0, atol=rtol * scale,
                                       err_msg=f"{what}: {lname}/{k}")


def _spec_axis(spec):
    """A JAX PartitionSpec in the port's form: the axis cut over 'model',
    or None."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    assert len(axes) <= 1, spec
    return axes[0] if axes else None


@pytest.mark.parametrize("family", worker.LAYOUT_FAMILIES)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["model2", "model4"])
def test_layout_equals_jax_param_shardings(run, family, shape):
    """param_shardings (tensor_parallel and not) and int_param_shardings
    give JAX's PartitionSpec on every leaf; tp_layers names the layers
    whose weight is cut.  At model 4 the 10-class classifier stays whole;
    depthwise layers stay whole; alpha and every scalar stay whole."""
    got = run[0][0][shape]["layouts"][family]
    model, (params, _) = worker.init(worker.QAT, family, size=32)
    jmodel = jax_get_model(family, JaxQuantConfig(**worker.QAT), worker.CLASSES, 32)
    mesh = make_mesh(data=1, model=shape[1], devices=jax.devices()[:shape[1]])
    pnp = {l: {k: np.asarray(v) for k, v in sub.items()} for l, sub in params.items()}
    ints = {l: {k: v.numpy() for k, v in sub.items()}
            for l, sub in worker.int_shapes(model.graph).items()}
    want = {
        "params": jax_param_shardings(jmodel.graph, pnp, mesh, tensor_parallel=True),
        "replicated": jax_param_shardings(jmodel.graph, pnp, mesh),
        "ints": jax_int_param_shardings(jmodel.graph, ints, mesh),
    }
    for kind, tree in want.items():
        assert list(got[kind]) == list(tree), kind
        for lname, sub in tree.items():
            assert got[kind][lname] == {k: _spec_axis(s.spec) for k, s in sub.items()}, (kind,
                                                                                         lname)
    cut = {l for l, sub in got["params"].items() if sub["w"] is not None}
    assert got["layers"] == cut
    assert all(v is None for sub in got["replicated"].values() for v in sub.values())
    assert all(sub["alpha"] is None for sub in got["params"].values())
    dw = {s.name for s in model.graph if getattr(s, "is_depthwise", False)}
    assert len(dw) == {"mobilenet_v2": 17, "mobilenet_v1": 13}.get(family, 0) and not dw & cut
    assert ("classifier" in cut) == (shape[1] == 2)


@pytest.mark.parametrize("shape", LINE_MESHES, ids=_mesh_id)
def test_shard_then_gather_is_identity(run, shape):
    """gather_params(shard_params(tree)) is the tree, bitwise, for params
    and momentum; each rank holds 1/model of every cut leaf."""
    for r in _ranks_of(shape):
        got = run[0][r][shape]["round_trip"]
        assert got["params"] and got["momentum"], r
        assert got["local"]["head"]["w"] == (7, 7, 3, 64 // shape[1])
        assert got["local"]["head"]["alpha"] == ()


def _step_gaps_within(got, ref, p0, what):
    """The float step's limits (tests/test_torch_dist.py): loss 1e-5
    relative, BN state 1e-5 and each tensor's update and momentum 1e-4 of
    their largest elements; top-1 and row counts equal."""
    rp, rs, rmom, rm = ref
    tp_p, tp_s, tp_m, tp_metrics = got[:4]
    assert abs(tp_metrics["loss"] - rm["loss"]) <= 1e-5 * abs(rm["loss"]), what
    assert tp_metrics["top1"] == rm["top1"] and tp_metrics["n"] == rm["n"], what
    p0 = {l: {k: np.asarray(v) for k, v in sub.items()} for l, sub in p0.items()}
    upd = {l: {k: p0[l][k] - np.asarray(rp[l][k]) for k in sub} for l, sub in p0.items()}
    tp_upd = {l: {k: p0[l][k] - tp_p[l][k].numpy() for k in sub} for l, sub in p0.items()}
    _close(tp_upd, upd, 1e-4, f"update against {what}")
    _close(tp_m, {l: {k: np.asarray(v) for k, v in sub.items()} for l, sub in rmom.items()}, 1e-4,
           f"momentum against {what}")
    bn = {l: {k: np.asarray(v) for k, v in sub.items() if k in ("bn_mean", "bn_var")}
          for l, sub in rs.items()}
    _close(tp_s, bn, 1e-5, f"BN state against {what}")


@pytest.mark.parametrize("shape", TP_MESHES, ids=_mesh_id)
def test_float_tp_step_matches_one_process_and_jax(run, shape):
    """The floating_wo_clip step on the mesh, params out-channel sharded,
    against the port's one process and JAX's mesh step on the same global
    batch, within the DP test's limits (a whole leaf's update off by the
    model size fails them: the 10-class classifier's at model 4)."""
    ranks, refs, jax_steps = run
    p0, steps = refs["float"]
    got = ranks[0][shape]["float_steps"]
    assert got[0][3]["n"] == steps[0][3]["n"] == worker.GLOBAL_BATCH
    _step_gaps_within(got[0], steps[0], p0, "one process")
    _step_gaps_within(got[0], jax_steps[shape], p0, "JAX mesh")


def test_float_tp_second_step_matches_one_process(run):
    """The second float step on (1, 2) -- the sharded params and momentum
    updated in place by the first -- against one process's second step
    from the same params, state and momentum, within the same limits."""
    got = run[0][0][(1, 2)]["float_steps"]
    p1, second = run[1]["second"]
    _step_gaps_within(got[1], second, p1, "one process's second step")
    assert not torch.equal(got[0][0]["classifier"]["w"], got[1][0]["classifier"]["w"])


@pytest.mark.parametrize("shape,case", [((1, 2), c[0]) for c in worker.CHAINS]
                         + [((1, 4), c) for c in worker.CHAINS_AT_4],
                         ids=lambda v: _mesh_id(v) if isinstance(v, tuple) else v)
def test_layer_chain_gradients_match_one_process(run, shape, case):
    """A chain of layers in train mode on the mesh -- two cut ResNet convs
    (per-layer and per-channel fraclens: fs_next a scale, then a vector
    cut to the rank's channels), the classifier (whole at model 4), a
    MobileNetV2 block whose depthwise layer runs whole between a cut
    expand and a cut project layer (float and QAT) -- against one process
    on the same input and output gradient: the output within 1e-5 and
    every gradient (the input's, each touched layer's leaves: w, gamma,
    beta, bias, and alpha, which stays whole and gets its gradient
    through f) within 1e-4 of its largest element; the EMA updates equal
    and the BN updates within 1e-5.  A whole leaf's gradient summed once
    more over the model line fails it."""
    y, gx, grads, upd = run[0][0][shape]["chains"][case]
    ry, rgx, rgrads, rupd = run[1]["chains"][case]
    _close({"y": {"y": y}}, {"y": {"y": ry}}, 1e-5, f"{case} output")
    _close({"x": {"x": gx}}, {"x": {"x": rgx}}, 1e-4, f"{case} input gradient")
    assert list(grads) == list(rgrads)
    _close({l: {k: v for k, v in sub.items() if k != "alpha"} for l, sub in grads.items()},
           {l: {k: v for k, v in sub.items() if k != "alpha"} for l, sub in rgrads.items()},
           1e-4, f"{case} gradients")
    # the layers' alphas as one vector: a layer's own alpha cancels in its
    # BN fold, and its gradient through fs_self is noise about zero
    alphas = lambda t: torch.stack([sub["alpha"] for sub in t.values()])
    _close({"alpha": {"alpha": alphas(grads)}}, {"alpha": {"alpha": alphas(rgrads)}}, 1e-4,
           f"{case} alpha gradients")
    assert any(float(g["alpha"].abs()) > 0 for g in rgrads.values()) == ("float" not in case)
    assert list(upd) == list(rupd)
    for lname, sub in rupd.items():
        for k, v in sub.items():
            if k in ("bn_mean", "bn_var"):
                _close({lname: {k: upd[lname][k]}}, {lname: {k: v}}, 1e-5, f"{case} BN")
            else:
                assert torch.equal(upd[lname][k], v), (case, lname, k)


def _fraclens_and_bn(got, want, what):
    for lname, sub in want.items():
        assert torch.equal(got[lname]["input_fl_ema"], sub["input_fl_ema"]), f"{what}: {lname}"
    bn = {l: {k: v for k, v in sub.items() if k in ("bn_mean", "bn_var")}
          for l, sub in want.items()}
    _close(got, bn, QAT_BN_LIMIT, what)


@pytest.mark.parametrize("shape", TP_MESHES, ids=_mesh_id)
def test_qat_tp_step_fraclens_and_bn_state(run, shape):
    """The QAT train step on the mesh (and on (2, 2), whose data line
    spans the batch statistics too, a calib step) against one process on
    the global batch, layer by layer: every input fraclen's EMA equal, BN
    running statistics within QAT_BN_LIMIT of each tensor's largest
    element, the row count the global batch's."""
    ranks, refs, _ = run
    s, m = refs["qat"][1][0][1], refs["qat"][1][0][3]
    tp_s, tp_m = ranks[0][shape]["qat_steps"][0][1], ranks[0][shape]["qat_steps"][0][3]
    assert tp_m["n"] == m["n"] == worker.GLOBAL_BATCH
    _fraclens_and_bn(tp_s, s, "train")
    if shape == (2, 2):
        calib_s, calib_m = ranks[0][shape]["calib"]
        assert calib_m["n"] == worker.GLOBAL_BATCH
        _fraclens_and_bn(calib_s, refs["calib"], "calib")


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=_mesh_id)
def test_tp_eval_forward_matches_replicated(run, shape):
    """tests/test_parallel.py's TP eval case: every rank's logits (its data
    row's images) within atol 2e-4 of the replicated forward's; one
    all-gather per cut layer's output, two all-reduces per cut layer for
    its weight's std (the sum and count, then the squared deviations) and
    two for the classifier's standardization; f sums only backward."""
    ranks, refs, _ = run
    want = refs["eval"]
    d, m = shape
    model, _ = worker.init(worker.QAT, classes=worker.EVAL_CLASSES, size=worker.EVAL_SIZE)
    cut = len(tp_layers(model.graph, m))
    per = worker.EVAL_BATCH // d
    for r in _ranks_of(shape):
        logits, counts = ranks[r][shape]["eval"]
        row = r // m
        np.testing.assert_allclose(logits.numpy(), want[row * per:(row + 1) * per].numpy(),
                                   rtol=0, atol=EVAL_ATOL, err_msg=f"rank {r}")
        assert counts["all_gather"] == cut and counts["all_reduce"] == 2 * cut + 2, counts
        assert set(counts) == {"all_gather", "all_gather_bytes", "all_reduce",
                               "all_reduce_bytes"}, counts
    assert len({tuple(row) for row in want.tolist()}) == worker.EVAL_BATCH


@pytest.mark.parametrize("shape", TP_MESHES, ids=_mesh_id)
def test_tp_replicas_bitwise_equal(run, shape):
    """After every step every rank of the mesh holds the same gathered
    params, the same state and the same gathered momentum, bit for bit
    (their digests), and reports the same metrics; the calib state and
    eval logits of one data row too."""
    ranks = run[0]
    a = ranks[0][shape]
    for r in _ranks_of(shape)[1:]:
        b = ranks[r][shape]
        for kind in ("float_steps", "qat_steps"):
            for i, (x, y) in enumerate(zip(a[kind], b[kind])):
                for j, what in enumerate(("params", "state", "momentum")):
                    assert x[4][j] == y[4][j], f"{kind} step {i} {what}, rank {r}"
                assert x[3] == y[3], (kind, i, r)
        if "calib" in a:
            _same(a["calib"][0], b["calib"][0], f"calib state, rank {r}")
        if r < shape[1] and "eval" in a:
            assert torch.equal(a["eval"][0], b["eval"][0]), r


def test_model_axis_of_one_is_the_data_parallel_step(run):
    """make_train_step(mesh=) on a (2, 1) mesh: params, state, momentum
    (their digests) and metrics bitwise those of make_train_step(group=)
    over its data line's two ranks, on both alike."""
    first = run[0][0][(2, 1)]["dp"][0]
    for r in range(2):
        mesh_step, dp_step = run[0][r][(2, 1)]["dp"]
        assert mesh_step == dp_step == first, r
