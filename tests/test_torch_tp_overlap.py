"""The port's tensor-parallel int8 matmuls (parallel/tp_overlap.py) on four
gloo ranks on the CPU, bitwise against the JAX package's
`f8net_tpu.parallel.tp_overlap` on the virtual 8-device mesh, at the shapes
of tests/test_tp_overlap.py: the Megatron pair with its one all-reduce
(and no other collective), and the ring with its p - 1 sends and
receives per rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from _torch_mp import start_ranks

from f8net_tpu.parallel import make_mesh as jax_make_mesh
from f8net_tpu.parallel.tp_overlap import tp_paired_matmul_int8, tp_ring_matmul_int8

M, K, N, O = 16, 64, 128, 96
PAIRED_KW = dict(net1=6, net2=7, signed1=False, signed2=True)
RING_KW = dict(net=5, signed=True)
# name: (kind, (data, model), operand set)
CASES = {
    "paired-1x4": ("paired", (1, 4), "paired"),
    "paired-2x2": ("paired", (2, 2), "paired"),
    "paired-2x2-narrow": ("paired", (2, 2), "narrow"),  # O = 10: K1's columns
    "ring-1x4": ("ring", (1, 4), "ring"),
    "ring-1x2": ("ring", (1, 2), "ring"),
}


def operands():
    rng = np.random.RandomState(0)
    i8 = lambda *shape: rng.randint(-127, 128, shape).astype(np.int8)
    i32 = lambda n: rng.randint(-1000, 1000, (n,)).astype(np.int32)
    return {
        "paired": dict(x=i8(M, K), w1=i8(K, N), b1=i32(N), w2=i8(N, O), b2=i32(O)),
        "narrow": dict(x=i8(4, 32), w1=i8(32, 64), b1=i32(64), w2=i8(64, 10), b2=i32(10)),
        "ring": dict(x=i8(M, K), w=i8(K, N), b=i32(N)),
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ops = operands()
    cases = [dict(name=name, kind=kind, mesh=mesh, ops=which,
                  kw=PAIRED_KW if kind == "paired" else RING_KW)
             for name, (kind, mesh, which) in CASES.items()]
    return start_ranks(tmp_path_factory.mktemp("overlap"), dict(cases=cases, ops=ops))(), ops


def jax_reference(kind, mesh, op):
    d, m = mesh
    jmesh = jax_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    a = {k: jnp.asarray(v) for k, v in op.items()}
    if kind == "paired":
        fn = jax.jit(lambda *v: tp_paired_matmul_int8(jmesh, *v, **PAIRED_KW))
        return np.asarray(fn(a["x"], a["w1"], a["b1"], a["w2"], a["b2"]))
    fn = jax.jit(lambda *v: tp_ring_matmul_int8(jmesh, *v, **RING_KW))
    return np.asarray(fn(a["x"], a["w"], a["b"]))


@pytest.mark.parametrize("name", list(CASES))
def test_equals_jax_tp_overlap(run, name):
    """Each rank's output bitwise the JAX primitive's: the paired matmul's
    whole (M, O) on every rank, the ring's this rank's N/p columns."""
    ranks, ops = run
    kind, (d, m), which = CASES[name]
    want = jax_reference(kind, (d, m), ops[which])
    for r in range(d * m):
        got = ranks[r][name]["y"].numpy()
        if kind == "ring":
            n = want.shape[1] // m
            want_r = want[:, (r % m) * n:(r % m + 1) * n]
        else:
            want_r = want
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want_r, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_collectives(run, name):
    """The pair: one all-reduce, nothing else.  The ring: p - 1 sends and
    p - 1 receives per rank, no all-reduce or all-gather."""
    ranks, ops = run
    kind, (d, m), _ = CASES[name]
    for r in range(d * m):
        counts = ranks[r][name]["counts"]
        if kind == "paired":
            assert set(counts) == {"all_reduce", "all_reduce_bytes"} and counts["all_reduce"] == 1
        else:
            assert set(counts) == {"send", "send_bytes", "recv", "recv_bytes"}, counts
            assert counts["send"] == counts["recv"] == m - 1, counts
