"""The plain reference against the port's engine on the CPU, bitwise, at a
small size, for both configurations in both rungs the reference knows
(the cells run ResNet-50 strict and MobileNetV2 int8-boundary)."""

import json

import pytest
import torch

from benchmark.harness import program, weights
from benchmark.manifest import HERE
from benchmark.reference import IntNet, requant


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small(name, side):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, image_size=side)


@pytest.mark.parametrize("name,side", [("resnet50", 32), ("resnet50", 64),
                                       ("mobilenet_v2", 32), ("mobilenet_v2", 64)])
@pytest.mark.parametrize("rung", ["strict", "int8"])
def test_reference_equals_the_port_engine_bitwise(name, side, rung):
    options = {"strict": {}, "int8": {"int8_boundary": True}}[rung]  # IntEngine's, per rung
    cfg = small(name, side)
    x = torch.randint(0, 256, (3, side, side, 3), generator=weights.generator(9, "t", "cpu"),
                      dtype=torch.uint8)
    records, params = weights.make_plan(cfg, 2**40 + 17, x)
    got = program.engine(cfg, records, params, options, "cpu")(x)
    ref = IntNet(cfg, params, {r[0]: r[1:] for r in records}, rung)
    want = ref.logits(x, rows=2)
    assert torch.equal(got, want)
    assert ref.clamped < cfg["quant"]["max_clamp_share"]
    assert ref.zero < cfg["quant"]["max_zero_share"]
    # a comparison that can fail: the rungs differ, and so does the control
    other = IntNet(cfg, params, {r[0]: r[1:] for r in records},
                   "int8" if rung == "strict" else "strict").logits(x)
    four = IntNet(cfg, params, {r[0]: r[1:] for r in records}, rung, operand_bits=4).logits(x)
    assert not torch.equal(other, want) and not torch.equal(four, want)


def test_requant_rounds_half_to_even_and_clamps():
    x = torch.tensor([-6, -5, -3, -2, 2, 3, 5, 6, 1000, -1000], dtype=torch.int64)
    assert requant(x, 1, True).tolist() == [-3, -2, -2, -1, 1, 2, 2, 3, 127, -127]
    assert requant(x, 1, False).tolist() == [0, 0, 0, 0, 1, 2, 2, 3, 255, 0]
    assert requant(torch.tensor([3]), -2, True).tolist() == [12]


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in [*(HERE / "reference").rglob("*.py"), *(HERE / "families").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                for m in mods:
                    assert m.split(".")[0] not in ("f8net_tpu_torch", "f8net_tpu", "jax"), path
