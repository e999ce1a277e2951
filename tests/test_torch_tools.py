"""The port's offline tools (f8net_tpu_torch.tools) against the JAX
package's (f8net_tpu.tools), on the CPU.

The Monte-Carlo study draws with numpy in both packages and quantizes with
each package's fix_quant -- exact float32 arithmetic (a power-of-two scale,
round-half-to-even, a clamp) -- so its error tables, optimal fraclens and
fitted coefficients must be equal bit for bit, at the sizes and seeds of
tests/test_tools.py.  The fraclen profile is text from one report.  The
folded weights are float products and a quotient of a square root (the
port's correctly rounded `sqrt_rn`), so their statistics agree within
rtol 1e-6, on the port's Model.init carried to JAX with state and BN
parameters drawn from a seed.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

from f8net_tpu.models import get_model as jax_get_model
from f8net_tpu.tools import error_analysis as jax_ea
from f8net_tpu.tools import fraclen_visual as jax_fv
from f8net_tpu.tools import weight_boxplot as jax_wb
from f8net_tpu.utils import QuantConfig as JaxQuantConfig
from f8net_tpu.utils.reporting import parse_fraclen_report as jax_parse
from f8net_tpu_torch.export import qat_from_numpy, qat_to_numpy
from f8net_tpu_torch.models import get_model
from f8net_tpu_torch.tools import error_analysis, fraclen_visual, weight_boxplot
from f8net_tpu_torch.utils import QuantConfig
from f8net_tpu_torch.utils.reporting import fraclen_report, parse_fraclen_report

CFG = dict(format_from_metric=True, metric="std")
SIGMAS = np.logspace(-1.5, 2.5, 41)  # tests/test_tools.py's grid


@pytest.mark.parametrize("signed", [True, False])
def test_sweep_equals_jax(signed):
    """One sweep at n = 2000: sigmas, optimal fraclens (after the
    leading-zero fix), the error table and the mae/rms statistics, bitwise."""
    got = error_analysis.sweep(n=2000, signed=signed, sigmas=SIGMAS, device="cpu")
    want = jax_ea.sweep(n=2000, signed=signed, sigmas=SIGMAS)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    for m in ("std", "mae", "rms"):
        np.testing.assert_array_equal(got[3][m], want[3][m])
    assert error_analysis.fit_threshold_coeff(*got[:2]) == jax_ea.fit_threshold_coeff(*want[:2])
    assert got[1][0] == (7 if signed else 8)  # small sigma: the finest grid wins


def test_leading_zero_fix_matches_jax():
    """The tiny-sigma region where the error aliases to fl = 0: both
    packages replace the leading zeros by the largest fraclen alike."""
    sigmas = np.logspace(-9, 1, 21)
    got = error_analysis.sweep(n=500, signed=True, sigmas=sigmas, device="cpu")
    want = jax_ea.sweep(n=500, signed=True, sigmas=sigmas)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])


def test_fit_all_metrics_equals_jax():
    """All six coefficients at n = 2000, equal."""
    got = error_analysis.fit_all_metrics(n=2000, device="cpu")
    want = jax_ea.fit_all_metrics(n=2000)
    assert got == want


@pytest.mark.parametrize("argv", [["--n", "1000", "--single", "--signed"],
                                  ["--n", "1000", "--single", "--unsigned"],
                                  ["--n", "1000"]], ids=["single-signed", "single-unsigned", "fits"])
def test_error_analysis_main_prints_the_jax_lines(argv, capsys):
    jax_ea.main(argv)
    want = capsys.readouterr().out
    error_analysis.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == want and want.count("\n") > 5


def test_cuda_is_the_default_device():
    """Without a card the default device raises: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        error_analysis.quant_rel_error(0.1, 4, 10, True)


@pytest.fixture(scope="module")
def carried():
    """{family: (port model, params, state as numpy)}: Model.init at 32 px
    and 10 classes, with every BN mean, variance, gamma and beta and every
    PACT alpha redrawn from a seed (the init's are constants)."""
    rng = np.random.RandomState(5)
    out = {}
    for family in ("mobilenet_v1", "resnet18"):
        model = get_model(family, QuantConfig(**CFG), num_classes=10, image_size=32)
        params, state = qat_to_numpy(*model.init(torch.Generator().manual_seed(3), device="cpu"))
        for name, entry in state.items():
            if "bn_var" in entry:
                entry["bn_var"] = rng.uniform(0.2, 3.0, entry["bn_var"].shape).astype(np.float32)
                entry["bn_mean"] = (0.3 * rng.randn(*entry["bn_mean"].shape)).astype(np.float32)
        for name, entry in params.items():
            for key, lo, hi in (("gamma", 0.3, 2.0), ("beta", -0.5, 0.5), ("alpha", 2.0, 12.0)):
                if key in entry:
                    entry[key] = rng.uniform(lo, hi, entry[key].shape).astype(np.float32)
        out[family] = (model, params, state)
    return out


@pytest.mark.parametrize("family", ["mobilenet_v1", "resnet18"])
def test_folded_weight_stats_equal_jax(carried, family):
    model, params, state = carried[family]
    got = weight_boxplot.folded_weight_stats(model, *qat_from_numpy(params, state, device="cpu"))
    jmodel = jax_get_model(family, JaxQuantConfig(**CFG), 10, 32)
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    want = jax_wb.folded_weight_stats(jmodel, j(params), j(state))
    assert list(got) == list(want) and len(got) == len(model.conv_order) - 1
    for name in want:
        for key, v in want[name].items():
            np.testing.assert_allclose(got[name][key], v, rtol=1e-6, err_msg=f"{name} {key}")
        st = got[name]
        assert st["min"] <= st["q25"] <= st["median"] <= st["q75"] <= st["max"] and st["std"] > 0


def _report(carried, family):
    model, params, state = carried[family]
    buf = io.StringIO()
    fraclen_report(model, *qat_from_numpy(params, state, device="cpu"),
                   print_fn=lambda t: buf.write(t + "\n"))
    return model, buf.getvalue()


@pytest.mark.parametrize("family", ["mobilenet_v1", "resnet18"])
def test_profile_table_equals_jax(carried, family, tmp_path, capsys):
    """The profile table of one fraclen report, each package parsing it:
    the same text; and the two CLIs' output on the report file."""
    model, text = _report(carried, family)
    got = fraclen_visual.profile_table(parse_fraclen_report(text))
    assert got == jax_fv.profile_table(jax_parse(text))
    assert len(got.splitlines()) == len(model.graph.names()) + 1
    path = os.path.join(tmp_path, "report.txt")
    with open(path, "w") as f:
        f.write(text)
    jax_fv.main([path])
    want = capsys.readouterr().out
    fraclen_visual.main([path])
    assert capsys.readouterr().out == want == got + "\n"


def test_plots_write_pngs(carried, tmp_path):
    """plot_profile and plot_boxes each write a PNG."""
    model, params, state = carried["mobilenet_v1"]
    _, text = _report(carried, "mobilenet_v1")
    stats = weight_boxplot.folded_weight_stats(model, *qat_from_numpy(params, state, device="cpu"))
    for fn, arg, name in ((fraclen_visual.plot_profile, parse_fraclen_report(text), "fl.png"),
                          (weight_boxplot.plot_boxes, stats, "box.png")):
        path = os.path.join(tmp_path, name)
        fn(arg, path)
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
