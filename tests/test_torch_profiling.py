"""PyTorch port, the observability utils (``utils/profiling.py``) against
the JAX package's: ``effective_bandwidth`` and ``solve_report`` equal for
the same inputs, ``assert_finite``'s two errors on tensors and solver infos,
``timed``, ``report_env``'s keys and ``trace`` writing a Chrome trace."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from justrelax_tpu.utils import profiling as jprofiling
from justrelax_tpu_torch.utils import profiling


class _Info:
    def __init__(self, iters, err):
        self.iters = iters
        self.err = err


@pytest.mark.parametrize("ni,t_iter,n_fields,dtype_bytes", [
    ((1024, 1024), 1.0e-3, 23, 8), ((126, 126, 126), 1.04e-4, 22, 4), ((7, 5), 0.0, 14, 8)])
def test_effective_bandwidth_matches_jax(ni, t_iter, n_fields, dtype_bytes):
    assert profiling.effective_bandwidth(ni, t_iter, n_fields, dtype_bytes) == \
        jprofiling.effective_bandwidth(ni, t_iter, n_fields, dtype_bytes)


@pytest.mark.parametrize("peak", [None, 3350.0])
def test_solve_report_matches_jax(peak):
    for iters, err, wall in ((1000, 1.0e-9, 0.5), (0, 3.0e-3, 1.0e-3)):
        info = _Info(torch.tensor(iters), torch.tensor(err, dtype=torch.float64))
        got = profiling.solve_report(info, (256, 128), wall, n_fields=25, dtype_bytes=4,
                                     hbm_peak_gbs=peak)
        want = jprofiling.solve_report(_Info(jnp.asarray(iters), jnp.asarray(err)), (256, 128),
                                       wall, n_fields=25, dtype_bytes=4, hbm_peak_gbs=peak)
        assert got == want


def test_assert_finite():
    profiling.assert_finite(_Info(1, torch.tensor(1.0e-6)), torch.ones(3, 3),
                            np.ones(2))  # clean
    with pytest.raises(FloatingPointError, match="NaN"):
        profiling.assert_finite(_Info(1, torch.tensor(float("nan"))))
    with pytest.raises(FloatingPointError, match="NaN"):
        profiling.assert_finite(torch.tensor([1.0, float("inf")]), context="thermal")
    with pytest.raises(FloatingPointError, match="divergence in dyrel"):
        profiling.assert_finite(_Info(1, torch.tensor(1.0e12)), context="dyrel")


def test_timed_and_report_env(capsys):
    out = {}
    with profiling.timed(out, "solve_s"):
        torch.ones(64, 64).sum()
    assert out["solve_s"] > 0
    env = profiling.report_env()
    assert set(env) == {"torch", "cuda", "backend", "devices", "n_devices", "default_dtype"}
    assert env["torch"] == torch.__version__ and int(env["n_devices"]) >= 1
    assert "torch" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert (env["backend"], env["devices"]) == ("cpu", "cpu")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    path = tmp_path / "trace" / "trace.json"
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
