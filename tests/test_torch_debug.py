"""The port's numeric-health and profiling utilities against the JAX
package's (stvd/utils/debug.py, stvd/utils/profiling.py), on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.utils import debug as jdebug
from stvd_torch.utils import debug as tdebug
from stvd_torch.utils import profiling as tprofiling


def numpy_grads():
    """A nested gradient tree with finite leaves, a NaN and an inf."""
    rng = np.random.RandomState(0)
    g = {"W": rng.randn(4, 6).astype(np.float32),
         "b": rng.randn(6).astype(np.float32),
         "c_att": np.float32(0.25),
         "enc": {"U": rng.randn(3, 3).astype(np.float32),
                 "bias": rng.randn(3).astype(np.float32)},
         "stack": [rng.randn(2).astype(np.float32),
                   rng.randn(2, 2).astype(np.float32)]}
    g["enc"]["U"][1, 2] = np.nan
    g["stack"][1][0, 0] = -np.inf
    return g


def tree(g, leaf):
    if isinstance(g, dict):
        return {k: tree(v, leaf) for k, v in g.items()}
    if isinstance(g, list):
        return [tree(v, leaf) for v in g]
    return leaf(g)


def test_grad_stats_match_jax():
    """The same leaf names (keys and indices joined by '/', dicts in
    sorted order) and the same l2, absmax and nan flags."""
    g = numpy_grads()
    ref = jdebug.grad_stats(tree(g, jnp.asarray))
    got = tdebug.grad_stats(tree(g, lambda x: torch.tensor(np.asarray(x))))
    assert list(got) == list(ref)
    assert list(got) == ["W", "b", "c_att", "enc/U", "enc/bias", "stack/0",
                         "stack/1"]
    for k in ref:
        assert bool(got[k]["nan"]) == bool(ref[k]["nan"]), k
        for stat in ("l2", "absmax"):
            np.testing.assert_allclose(float(got[k][stat]),
                                       float(ref[k][stat]), rtol=1e-6,
                                       err_msg=f"{k} {stat}")


@pytest.mark.parametrize("bad", [True, False])
def test_report_bad_grads_prints_what_jax_prints(capsys, bad):
    g = numpy_grads()
    if not bad:
        g["enc"]["U"][1, 2] = 0.0
        g["stack"][1][0, 0] = 0.0
    jdebug.report_bad_grads(tree(g, jnp.asarray))
    want = capsys.readouterr().out
    tdebug.report_bad_grads(tree(g, lambda x: torch.tensor(np.asarray(x))))
    got = capsys.readouterr().out
    assert got == want
    assert got.count("[grad-nan]") == (2 if bad else 0)


def test_enable_nan_debug_raises_on_a_nan_backward():
    """``enable_nan_debug`` is autograd's anomaly mode with its NaN
    check: a backward operation that returns a NaN raises; the returned
    object restores the mode it found, and then the NaN passes."""
    x = torch.tensor([-1.0], requires_grad=True)
    with tdebug.enable_nan_debug(True):
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).sum().backward()
    assert torch.isnan(x.grad).all()


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    """``trace(logdir)`` records the block through ``torch.profiler`` and
    writes one Chrome trace file that names the block's operations;
    ``start_trace`` and its profiler's ``stop()`` do the same across
    calls."""
    import json
    logdir = tmp_path / "tr"
    with tprofiling.trace(str(logdir)):
        a = torch.randn(64, 64)
        (a @ a).sum()
    files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((logdir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    prof = tprofiling.start_trace(str(tmp_path / "tr2"))
    torch.ones(3).cumsum(0)
    prof.stop()
    assert os.listdir(tmp_path / "tr2")
