"""One rank of tests/test_torch_tp_train.py's four-process run (gloo on the
CPU).

    python tests/_torch_tp_train_worker.py <port> <rank> <world> <outdir> [bf16]

Joins the group through `parallel.init_dist`, builds every mesh of
MESHES[world] in order (every rank builds every mesh; the test runs a
group of 4 and a group of 2 at once) and, on each mesh it is a rank of,
runs the port's tensor-parallel QAT training from the shared inits on its
data row's shard of seeded global batches (`run` says which case on which
mesh): the params' layout (param_shardings, int_param_shardings),
shard_params then gather_params, floating_wo_clip train steps and a QAT
train step of a ResNet-18 at 16 px, a calib step, layer chains in train
mode, a floating_wo_clip step of a MobileNetV2 at 32 px, the eval forward
of tests/test_parallel.py's TP case.  Each rank writes what
it computed to <outdir>/w<world>-rank<r>.pt: a step's params and momentum, gathered
whole, as digests (every rank) and as tensors where the tests read them
(rank 0 alone: a ResNet-18's tree is 45 MB).  With `bf16` (world 2,
tests/test_torch_bf16_conv.py) it runs one thing on (1, 2): a QAT train
step with `train_conv_bf16`.  Imports no JAX.
"""

import hashlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from f8net_tpu_torch.models import get_model  # noqa: E402
from f8net_tpu_torch.nn.quant_layers import Act, conv_bn_apply, linear_apply  # noqa: E402
from f8net_tpu_torch.nn.spec import LinearSpec  # noqa: E402
from f8net_tpu_torch.parallel import (  # noqa: E402
    gather_params, init_dist, int_param_shardings, make_mesh, param_shardings,
    shard_params,
)
from f8net_tpu_torch.parallel.mesh import shard_batch, tp_layers  # noqa: E402
from f8net_tpu_torch.parallel.tp_train import TensorParallel  # noqa: E402
from f8net_tpu_torch.quant import reset_bn_for_calib  # noqa: E402
from f8net_tpu_torch.train import make_eval_step, make_train_step, sgd_init  # noqa: E402
from f8net_tpu_torch.train.optim import SGDState  # noqa: E402
from f8net_tpu_torch.utils import QuantConfig, TrainConfig  # noqa: E402

# shared with tests/test_torch_tp_train.py
MESHES = {4: ((2, 2), (1, 4)), 2: ((1, 2), (2, 1))}  # by the group's size
GLOBAL_BATCH, SIZE, CLASSES = 16, 16, 10
EVAL_SIZE, EVAL_CLASSES, EVAL_BATCH = 32, 16, 4  # tests/test_parallel.py's TP eval case
FLOAT = dict(floating_wo_clip=True)
QAT = dict(format_from_metric=True, metric="std")
TRAIN_KW = dict(lr=0.01, weight_decay=4e-5, momentum=0.9, nesterov=True, topk=(1,))
FLOAT_STEPS = 2
PER_CHANNEL = dict(QAT, format_type="per_channel")
QAT_BF16 = dict(QAT, train_conv_bf16=True)
# layer chains whose train-mode forward and backward the tests compare
# with one process's: (name, config, family, layers, input shape); all on
# the model line of (1, 2), CHAINS_AT_4 on (1, 4)'s too
CHAINS = (
    ("r18-qat", QAT, "resnet18", ("stage_1_layer_0.body.0", "stage_1_layer_0.body.1"),
     (4, 8, 8, 64)),
    ("r18-qat-per-channel", PER_CHANNEL, "resnet18",
     ("stage_1_layer_0.body.0", "stage_1_layer_0.body.1"), (4, 8, 8, 64)),
    ("r18-qat-classifier", QAT, "resnet18", ("classifier",), (4, 512)),
    ("mbv2-float-block", FLOAT, "mobilenet_v2",
     ("stage_1_layer_0.body.0", "stage_1_layer_0.body.1", "stage_1_layer_0.body.2"),
     (4, 8, 8, 16)),
    ("mbv2-qat-block", QAT, "mobilenet_v2",
     ("stage_1_layer_0.body.0", "stage_1_layer_0.body.1", "stage_1_layer_0.body.2"),
     (4, 8, 8, 16)),
)
LAYOUT_FAMILIES = ("resnet18", "resnet50", "mobilenet_v2", "mobilenet_v1")
CHAINS_AT_4 = ("r18-qat-per-channel", "r18-qat-classifier", "mbv2-qat-block")


def global_batch(seed, n=GLOBAL_BATCH, size=SIZE, classes=CLASSES):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, size, size, 3).astype(np.float32),
            rng.randint(0, classes, n).astype(np.int32))


def eval_images(seed=1):
    return np.random.RandomState(seed).rand(EVAL_BATCH, EVAL_SIZE, EVAL_SIZE, 3).astype(np.float32)


def init(cfg, family="resnet18", classes=CLASSES, size=SIZE, seed=0):
    model = get_model(family, QuantConfig(**cfg), num_classes=classes, image_size=size)
    return model, model.init(torch.Generator().manual_seed(seed), device="cpu")


def int_shapes(graph):
    """Zero int params {w: int8, b: int32} of the graph's shapes: what
    int_param_shardings reads."""
    return {s.name: {"w": torch.zeros(s.weight_shape(), dtype=torch.int8),
                     "b": torch.zeros(s.weight_shape()[-1], dtype=torch.int32)} for s in graph}


def _copy(tree):
    return {l: {k: v.detach().clone() for k, v in sub.items()} for l, sub in tree.items()}


def digest(tree):
    """{layer: {leaf: sha256 of the tensor's bytes}}: bitwise equality of
    trees across ranks without saving them."""
    return {l: {k: hashlib.sha256(v.detach().numpy().tobytes()).hexdigest()
                for k, v in sub.items()} for l, sub in tree.items()}


def step_result(trees, metrics, keep):
    """(params, state, momentum, metrics, digests of the three): the trees
    whose index is in `keep` on rank 0, None elsewhere."""
    lead = torch.distributed.get_rank() == 0
    kept = [_copy(t) if lead and i in keep else None for i, t in enumerate(trees)]
    return (*kept, {k: float(v) for k, v in metrics.items()}, [digest(t) for t in trees])


def _rows(mesh, *arrays):
    return [torch.from_numpy(shard_batch(mesh, a)) for a in arrays]


def layouts(mesh):
    """param_shardings and int_param_shardings of each of LAYOUT_FAMILIES
    (10 classes) on this mesh, tp_layers, and the layouts without
    tensor_parallel."""
    out = {}
    for family in LAYOUT_FAMILIES:
        model, (params, _) = init(QAT, family, size=32)
        out[family] = dict(
            params=param_shardings(model.graph, params, mesh, tensor_parallel=True),
            ints=int_param_shardings(model.graph, int_shapes(model.graph), mesh),
            replicated=param_shardings(model.graph, params, mesh),
            layers=tp_layers(model.graph, mesh.size("model")))
    return out


def train_steps(cfg, mesh, steps, family="resnet18", classes=CLASSES, size=SIZE,
                batch=GLOBAL_BATCH, keep=(0, 1, 2)):
    """`steps` train steps from the shared init on the mesh, the params and
    momentum this rank's slices; step_result after each step, params and
    momentum gathered whole."""
    model, (params, state) = init(cfg, family, classes, size)
    specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
    params = shard_params(params, specs, mesh)
    step = make_train_step(model, model.cfg, TrainConfig(**TRAIN_KW), mesh=mesh)
    opt = sgd_init(params)
    out = []
    for i in range(steps):
        x, y = _rows(mesh, *global_batch(1 + i, batch, size, classes))
        params, state, opt, m = step(params, state, opt, x, y, 0.01)
        out.append(step_result((gather_params(params, specs, mesh), state,
                                gather_params(opt.momentum, specs, mesh)), m, keep))
    return out


def calib_step(mesh):
    """One calib-mode step of the QAT ResNet-18 on reset BN state."""
    model, (params, state) = init(QAT)
    specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
    step = make_eval_step(model, model.cfg, TrainConfig(**TRAIN_KW), mode="calib", mesh=mesh)
    x, y = _rows(mesh, *global_batch(9))
    state, m = step(shard_params(params, specs, mesh), reset_bn_for_calib(state), x, y)
    return _copy(state), {k: float(v) for k, v in m.items()}


def eval_forward(mesh):
    """tests/test_parallel.py's TP case: the eval forward of a QAT
    ResNet-18 (16 classes, 32 px) on this rank's rows of 4 images."""
    model, (params, state) = init(QAT, classes=EVAL_CLASSES, size=EVAL_SIZE)
    specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
    (x,) = _rows(mesh, eval_images())
    mesh.reset_counts()
    with torch.no_grad():
        logits, _ = model.apply(shard_params(params, specs, mesh), state, x, "eval", mesh=mesh)
    return logits, dict(mesh.counts)


def chain(case, mesh=None, seed=5):
    """One CHAINS case in train mode: the layers applied in order to a
    seeded input, the loss sum(y * dy) for a seeded dy, its backward.
    Returns (y, the input's gradient, {layer: {leaf: gradient}} gathered
    whole, the state updates).  With a mesh: the layers the layout cuts on
    this rank's param slices (y whole through g); without one, one
    process."""
    _, cfg, family, names, shape = case
    model, (params, state) = init(cfg, family, size=32)
    specs, tp = None, TensorParallel(model.graph, mesh)
    if mesh is not None:
        specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
        params = shard_params(params, specs, mesh)
    for sub in params.values():
        for v in sub.values():
            v.requires_grad_(True)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).requires_grad_(True)
    a, updates = Act(x), {}
    for name in names:
        apply = linear_apply if isinstance(model.graph[name], LinearSpec) else conv_bn_apply
        merged = {l: dict(v, **updates.get(l, {})) for l, v in state.items()}
        a, upd = apply(model.graph, model.cfg, name, params, merged, a, "train", None, tp.of(name))
        for l, u in upd.items():
            updates.setdefault(l, {}).update(u)
    dy = torch.randn(a.x.shape, generator=g)
    torch.sum(a.x * dy).backward()
    grads = {l: {k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in sub.items()}
             for l, sub in params.items()}
    if specs is not None:
        grads = gather_params(grads, specs, mesh)
    touched = ({l for l in names} | {model.graph[l].following for l in names}
               | {model.graph[l].master for l in names}) - {None}
    return (a.x.detach(), x.grad, {l: grads[l] for l in sorted(touched)},
            {l: {k: v.detach() for k, v in u.items()} for l, u in updates.items()})


def round_trip(mesh):
    """shard_params then gather_params of the QAT ResNet-18's params and
    of an SGD state's momentum (drawn): whether each gives back its tree."""
    model, (params, _) = init(QAT)
    specs = param_shardings(model.graph, params, mesh, tensor_parallel=True)
    g = torch.Generator().manual_seed(3)
    mom = SGDState({l: {k: torch.randn(v.shape, generator=g) for k, v in sub.items()}
                    for l, sub in params.items()}).momentum
    same = lambda a, b: all(torch.equal(v, b[l][k]) for l, sub in a.items() for k, v in sub.items())
    local = shard_params(params, specs, mesh)
    return dict(params=same(gather_params(local, specs, mesh), params),
                momentum=same(gather_params(shard_params(mom, specs, mesh), specs, mesh), mom),
                local={l: {k: tuple(v.shape) for k, v in sub.items()} for l, sub in local.items()})


def data_parallel_steps(mesh):
    """On a model axis of one rank: the mesh's float step and the
    data-parallel step over its data line's process group (digests and
    metrics)."""
    model, (params, state) = init(FLOAT)
    p2, s2 = _copy(params), _copy(state)
    kw = dict(model=model, cfg=model.cfg, tcfg=TrainConfig(**TRAIN_KW))
    x, y = _rows(mesh, *global_batch(1))
    a = make_train_step(**kw, mesh=mesh)(params, state, sgd_init(params), x, y, 0.01)
    b = make_train_step(**kw, group=mesh.groups["data"])(p2, s2, sgd_init(p2), x, y, 0.01)
    return [step_result((t[0], t[1], t[2].momentum), t[3], ())[3:] for t in (a, b)]


def run(mesh):
    """Every mesh: the float and QAT steps.  Where the model line has 2
    ranks, (1, 2) and (2, 2), the eval forward; where the data line has
    ranks, (2, 2), the calib step.  The model line's own cases on (1, 2)
    and (1, 4) (a (2, 2) mesh's model line is (1, 2)'s): the layouts, the
    round trips, the chains; on (1, 2) the second float step.  On a model
    axis of one rank, the data-parallel comparison."""
    if mesh.size("model") == 1:
        return dict(dp=data_parallel_steps(mesh))
    line2 = mesh.size("model") == 2
    res = dict(
        float_steps=train_steps(FLOAT, mesh, FLOAT_STEPS if line2 else 1),
        qat_steps=train_steps(QAT, mesh, 1, keep=(1,)))
    if line2:
        res.update(eval=eval_forward(mesh))
    if mesh.size("data") > 1:
        res.update(calib=calib_step(mesh))
    else:
        res.update(layouts=layouts(mesh), round_trip=round_trip(mesh),
                   chains={case[0]: chain(case, mesh) for case in CHAINS
                           if line2 or case[0] in CHAINS_AT_4})
    return res


def main():
    port, rank, world, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    bf16 = sys.argv[5:] == ["bf16"]
    torch.set_num_threads(1)
    init_dist(f"tcp://127.0.0.1:{port}", rank, world, backend="gloo")
    if bf16:
        res = {(1, 2): dict(qat_bf16_steps=train_steps(QAT_BF16, make_mesh(1, 2, device="cpu"),
                                                       1, keep=(1,)))}
    else:
        meshes = [make_mesh(d, m, device="cpu") for d, m in MESHES[world]]
        res = {shape: run(mesh) for shape, mesh in zip(MESHES[world], meshes) if mesh.member}
    torch.save(res, os.path.join(outdir, f"w{world}-rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok")


if __name__ == "__main__":
    main()
