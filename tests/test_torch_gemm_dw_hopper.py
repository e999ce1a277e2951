"""K1's and K4's Hopper designs on the CPU: their planners, K1's packed
weights and the plain versions that compute as the kernels' plans cut the
work, bitwise (tolerance 0) against the Pallas kernels they replace run in
interpret mode (`f8net_tpu.ops.pallas_gemm.int8_gemm`,
`f8net_tpu.ops.pallas_dw.pallas_depthwise_int8`), as
tests/test_pallas_{gemm,dw}.py run them.  Small shapes only; the planners
are checked at the main paths' 224-px shapes without computing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.ops.pallas_dw import pallas_depthwise_int8
from f8net_tpu.ops.pallas_gemm import int8_gemm as pallas_int8_gemm
from f8net_tpu_torch.ops import dw as dw_ops
from f8net_tpu_torch.ops import gemm as gemm_ops
from f8net_tpu_torch.ops.dw import DwPlan, dw_int8, dw_int8_plain
from f8net_tpu_torch.ops.gemm import int8_gemm, int8_gemm_plain, pack_k1_weight

IMAX = (1 << 31) - 1


def _t(a):
    return torch.from_numpy(np.array(a))


# every K1 call of the three paths at 224 px per image (M / batch, K, N):
# the classifiers of ResNet-18, MobileNetV2 and ResNet-50, and MobileNetV2's
# 1x1 convs off K7 (block 0 project, block 1 project, block 3 expand)
K1_CALLS = [(1, 512, 1000, "skinny"), (1, 1280, 1000, "skinny"), (1, 2048, 1000, "skinny"),
            (12544, 32, 16, "narrow"), (3136, 96, 24, "narrow"), (3136, 24, 144, "narrow")]


def _coverage_ok(plan, m, k, n):
    """Every output element reduced over [0, k) exactly once: each output
    tile's reduction ranges partition [0, k), and the tiles partition the
    output."""
    cover = np.zeros((m, n), np.int64)
    ranges = {}
    for r0, r1, c0, c1, lo, hi in gemm_ops.k1_work(plan, m, k, n):
        assert 0 <= r0 < r1 <= m and 0 <= c0 < c1 <= n and 0 <= lo < hi <= k
        ranges.setdefault((r0, c0), []).append((lo, hi))
        cover[r0:r1, c0:c1] += hi - lo
    for parts in ranges.values():
        parts.sort()
        assert parts[0][0] == 0 and parts[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    return bool((cover == k).all())


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("mb,k,n,form", K1_CALLS + [(1, 512, 10, "skinny"),
                                                   (300, 24, 16, "narrow"),
                                                   (300, 20, 10, "general")])
def test_plan_k1_covers_every_output_once(batch, mb, k, n, form):
    m = mb * batch
    plan = gemm_ops.plan_k1(m, k, n)
    assert plan.form == form
    assert gemm_ops.plan_fits(plan, m, k, n)
    assert plan in gemm_ops.k1_candidates(m, k, n)
    if plan.form == "skinny":  # one block per 8 columns, the reduction in 64-byte chunks
        assert plan.grid == plan.ntiles == -(-n // 8) and plan.bn == 8
        assert len(gemm_ops.k1_parts(plan, k)) == -(-k // gemm_ops.CHUNK)
    if plan.form == "narrow":  # the weights and the ring fit one block
        assert gemm_ops.narrow_smem(k, n) <= gemm_ops.SMEM_LIMIT
    assert _coverage_ok(plan, m, k, n)
    for cand in gemm_ops.k1_candidates(m, k, n):
        assert gemm_ops.plan_fits(cand, m, k, n) and _coverage_ok(cand, m, k, n)


def test_pack_k1_weight_layout():
    rng = np.random.RandomState(0)
    w = _t(rng.randint(-127, 128, (24, 10)).astype(np.int8))
    p = pack_k1_weight(w)
    assert p.shape == (24, 10) and tuple(p.data.shape) == (16, 32)
    assert torch.equal(p.data[:10, :24], w.t())
    assert not p.data[10:].any() and not p.data[:, 24:].any()  # zero pads
    assert torch.equal(gemm_ops.unpack_k1_weight(p), w)


EPIS = [
    dict(epilogue="int32"),
    dict(epilogue="int32", relu=True),
    dict(epilogue="requant8", net=7, out_signed=True),
    dict(epilogue="requant8", net=9, out_signed=False, relu=True),
]


def _plans(m, k, n):
    """The plans a case runs under: plan_k1's, and for the narrow form a
    persistent block walking every tile."""
    plans = [gemm_ops.plan_k1(m, k, n)]
    if plans[0].form == "narrow":  # a persistent block walking several tiles
        plans.append(gemm_ops.narrow_plan(m, k, n, 1))
    return plans


# (M, K, N, form): skinny over 4 chunks of K; narrow at K = 24 (padded to 32) and 96;
# a 10-class head (N % 8 != 0) skinny and general; K % 16 != 0 in general
K1_CASES = [(8, 256, 40, "skinny"), (300, 24, 16, "narrow"), (130, 96, 24, "narrow"),
            (5, 64, 10, "skinny"), (70, 20, 10, "general"), (200, 64, 72, "general")]


@pytest.mark.parametrize("m,k,n,form", K1_CASES)
def test_int8_gemm_plans_vs_pallas(m, k, n, form):
    rng = np.random.RandomState(m + k + n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    b = rng.randint(-(1 << 16), 1 << 16, (n,)).astype(np.int32)
    wp = pack_k1_weight(_t(w))
    assert gemm_ops.plan_k1(m, k, n).form == form
    for kw in EPIS:
        want = np.asarray(pallas_int8_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True, **kw))
        np.testing.assert_array_equal(int8_gemm_plain(_t(x), wp, _t(b), **kw).numpy(), want)
        for plan in _plans(m, k, n):
            got = int8_gemm(_t(x), wp, _t(b), plan=plan, **kw)
            assert got.dtype == (torch.int32 if kw["epilogue"] == "int32" else torch.int8)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{plan} {kw}")


def test_split_k_wraps_only_after_the_full_sum():
    """The skinny form's partial sums over 64-byte chunks of K (the 4 warps'
    partials) are added in int32 before one bias add and epilogue: with a
    bias near INT32_MAX only the full sum wraps, and a part that added the
    bias itself (or requantized its partial) would differ."""
    m, k, n = 4, 512, 16
    x = np.full((m, k), 127, np.int8)
    x[1] = -128
    w = np.full((k, n), 127, np.int8)
    w[:, 1::2] = -127
    b = np.full((n,), IMAX - 1000, np.int32)
    b[1::2] = -IMAX + 1000
    wp = pack_k1_weight(_t(w))
    plan = gemm_ops.plan_k1(m, k, n)
    assert plan.form == "skinny" and len(gemm_ops.k1_parts(plan, k)) == 8
    for kw in (dict(epilogue="int32"), dict(epilogue="requant8", net=20, out_signed=True)):
        want = np.asarray(pallas_int8_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True, **kw))
        got = int8_gemm(_t(x), wp, _t(b), plan=plan, **kw).numpy()
        np.testing.assert_array_equal(got, want)
    acc = x.astype(np.int64) @ w.astype(np.int64)
    assert ((acc + b) > IMAX).any() and ((acc + b) < -IMAX - 1).any()  # the sum wraps
    per_split = sum(  # the wrong order: bias added to every split's partial
        (x[:, lo:hi].astype(np.int64) @ w[lo:hi].astype(np.int64) + b).astype(np.int32)
        .astype(np.int64) for lo, hi in gemm_ops.k1_parts(plan, k))
    assert not np.array_equal(per_split.astype(np.int32), np.asarray(
        pallas_int8_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)))


# (n, h, w, c, k, stride, padding): MobileNetV2's five K4 calls at 224 px
# (per image), and 5x5 / 7x7 kernels
DW_CALLS = [(112, 112, 32, 3, 1, 1), (112, 112, 96, 3, 2, 1), (56, 56, 144, 3, 2, 1),
            (28, 28, 192, 3, 2, 1), (14, 14, 576, 3, 2, 1), (28, 28, 192, 5, 1, 2),
            (14, 14, 576, 7, 2, 3), (56, 56, 144, 5, 2, 2), (7, 7, 960, 7, 1, 3)]


def _dw_tiles_ok(plan, n, h, w, c, k, stride, padding):
    """Every output pixel and channel computed by exactly one tile, and every
    tap of every output of a tile (and the window a thread reads) inside
    that tile's halo."""
    g = dw_ops.dw_geometry(h, w, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    cover = np.zeros((n, g.oh, g.ow, g.cg), np.int64)
    npx, run = dw_ops.dw_npx(k, stride), dw_ops.RUN[stride]
    for img, oy0, ox0, c0, iy0, ix0 in dw_ops.dw_tiles(plan, n, h, w, c, k, stride, padding):
        oy1, ox1 = min(oy0 + plan.th, g.oh), min(ox0 + plan.tw, g.ow)
        cover[img, oy0:oy1, ox0:ox1, c0 // plan.cb] += 1
        assert (oy0 * stride - padding) >= iy0 and (oy1 - 1) * stride - padding + k <= iy0 + g.ih
        assert (ox0 * stride - padding) >= ix0 and (ox1 - 1) * stride - padding + k <= ix0 + g.iwp
        # the last run of the tile reads npx pixels from its start
        assert (plan.tw - run) * stride + npx <= g.iwp
    return bool((cover == 1).all())


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("h,w,c,k,stride,padding", DW_CALLS)
def test_plan_dw_covers_every_output_once(batch, h, w, c, k, stride, padding):
    plan = dw_ops.plan_dw(batch, h, w, c, k, stride, padding)
    assert plan in dw_ops.dw_candidates(batch, h, w, c, k, stride, padding)
    assert dw_ops.plan_fits(plan, batch, h, w, c, k, stride, padding)
    g = dw_ops.dw_geometry(h, w, c, k, stride, padding, plan.th, plan.tw, plan.cb, plan.rowb)
    assert 64 <= g.threads <= dw_ops.MAX_THREADS and plan.rowb >= g.iwp * plan.cb
    assert plan.grid <= batch * g.tiles_per_image
    assert _dw_tiles_ok(plan, batch, h, w, c, k, stride, padding)


def test_dw_halo_division_exact_where_plans_allow():
    """K4's halo loader divides a chunk index r by d = cb / 16 as (r *
    ceil(2^16 / d)) >> 16: exact for every cb <= MAX_CB and r below
    MAX_HALO_CHUNKS, not for wider channel blocks, which plan_fits refuses."""
    r = np.arange(dw_ops.MAX_HALO_CHUNKS, dtype=np.int64)

    def exact(d):
        return bool((((r * -(-65536 // d)) >> 16) == r // d).all())

    assert all(exact(cb // 16) for cb in range(16, dw_ops.MAX_CB + 1, 16))
    assert not exact(992 // 16)
    plan = DwPlan(1, 16, 992, 19840, 1)
    g = dw_ops.dw_geometry(4, 16, 992, 3, 1, 1, plan.th, plan.tw, plan.cb, plan.rowb)
    assert g.iwp * plan.cb // 16 <= dw_ops.MAX_HALO_CHUNKS and g.threads <= dw_ops.MAX_THREADS
    assert not dw_ops.plan_fits(plan, 1, 4, 16, 992, 3, 1, 1)
    assert dw_ops.plan_fits(plan._replace(cb=32, rowb=640), 1, 4, 16, 992, 3, 1, 1)


# (n, h, w, c, k, stride, padding, pad_value, epilogue kwargs): odd sizes,
# both strides, the packed zero -128 and 0 at the border
DW_CASES = [
    (2, 9, 11, 32, 3, 1, 1, -128, dict(epilogue="int32")),
    (1, 11, 7, 48, 3, 2, 1, 0, dict(epilogue="requant8", net=6, out_signed=True)),
    (2, 8, 8, 16, 5, 1, 2, -128, dict(epilogue="requant8", net=7, out_signed=False, relu=True)),
    (1, 13, 13, 32, 7, 2, 3, 0, dict(epilogue="int32", relu=True)),
    (1, 15, 15, 16, 3, 2, 1, -128, dict(epilogue="requant8", net=5, out_signed=False)),
]


@pytest.mark.parametrize("n,h,w,c,k,stride,padding,pad_value,epi", DW_CASES)
def test_dw_tiled_plain_vs_pallas(n, h, w, c, k, stride, padding, pad_value, epi):
    rng = np.random.RandomState(h * w + c + k + stride)
    x = rng.randint(-128, 128, (n, h, w, c)).astype(np.int8)
    wt = rng.randint(-127, 128, (k, k, 1, c)).astype(np.int8)
    b = rng.randint(-(1 << 14), 1 << 14, (c,)).astype(np.int32)
    kw = dict(stride=stride, padding=padding, pad_value=pad_value, **epi)
    want = np.asarray(pallas_depthwise_int8(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), boh=4, interpret=True, **kw))
    np.testing.assert_array_equal(dw_int8_plain(_t(x), _t(wt), _t(b), **kw).numpy(), want)
    run = dw_ops.RUN[stride]
    small = DwPlan(2, run, 16, dw_ops.row_bytes(2, run, 16, k, stride), 3)
    for plan in (dw_ops.plan_dw(n, h, w, c, k, stride, padding), small):
        assert dw_ops.plan_fits(plan, n, h, w, c, k, stride, padding)
        assert _dw_tiles_ok(plan, n, h, w, c, k, stride, padding)
        got = dw_int8(_t(x), _t(wt), _t(b), plan=plan, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(plan))


def test_engine_hands_k1_its_packed_weights():
    """MobileNetV2 at 32 px on the CPU: every K1 call -- the classifier and
    the 1x1 convs off K7 -- carries a weight the engine packed at
    construction, and the logits are the plain path's."""
    import chip_smoke
    from f8net_tpu_torch.engine import IntEngine

    images = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32))
    model, plan, params, _ = chip_smoke.load_synthetic_model(
        3, 32, 10, "cpu", images, model_name="mobilenet_v2")
    eng = IntEngine(model, plan, params, device="cpu")
    logits, ref, _, calls, _ = chip_smoke.engine_phase(eng, eng.condition_input(images))
    chip_smoke.check_logits(logits, ref, 2, 10)
    packed = {id(w) for w in eng._packed.values()}
    k1 = [args for name, args, _ in calls if name == "int8_gemm"]
    assert len(k1) == chip_smoke.LAUNCHES_PER_FORWARD["mobilenet_v2"]["int8_gemm"]
    assert all(isinstance(a[1], gemm_ops.PackedK1Weight) and id(a[1]) in packed for a in k1)
