"""The PyTorch twins of the stream and AR examples
(``examples/{quickstart,edge_stream_analytics,fleet_stream_analytics}
_torch.py``) against the reference examples, on the CPU.

Each reference example runs in a subprocess (``JAX_PLATFORMS=cpu``, the
fleet's 8 forced host devices, 120 s); its twin runs here through
``main(device="cpu")``.  The printed result lines must be equal, line
for line, less those that carry wall times (latency percentiles, the
dispatch span, the frames rate) and the trace counts, which are no
target (the reference prints 2 for the fleet on jax 0.9.0).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import edge_stream_analytics_torch  # noqa: E402
import fleet_stream_analytics_torch  # noqa: E402
import quickstart_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: lines that carry wall times or trace counts
_TIMED = re.compile(r"\d+us\b|traced \d+ time|frames/s")


def reference_env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)          # the fleet example sets its own
    return env


def _reference(name: str) -> list:
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                       env=reference_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return _results(r.stdout)


def _results(out: str) -> list:
    return [line for line in out.splitlines() if not _TIMED.search(line)]


@pytest.mark.parametrize("name,twin,quoted", [
    ("quickstart.py", quickstart_torch, "wildcard query hits: 4"),
    ("edge_stream_analytics.py", edge_stream_analytics_torch,
     "120 windows -> 25 escalated to core (12 hit the core capacity "
     "limit)"),
    ("fleet_stream_analytics.py", fleet_stream_analytics_torch,
     "per-bridge escalations: [0, 0, 12, 12, 12, 12, 0, 0]"),
])
def test_example_prints_the_reference_results(capsys, name, twin, quoted):
    want = _reference(name)
    capsys.readouterr()
    res = twin.main(device="cpu")
    got = _results(capsys.readouterr().out)
    assert got == want
    assert any(quoted in line for line in got)
    assert isinstance(res, dict) and res
