"""The port stands alone: no module of ``repro_torch``, nothing
``chip_smoke.py`` imports and no ``examples/*_torch.py`` may load
``jax`` or the JAX package ``repro`` (the machine with the card has no
JAX)."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import repro_torch
    names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for name in names:
        __import__(name)
    bad = sorted(m for m in sys.modules
                 if m == "repro" or m.startswith(("repro.", "jax", "jaxlib")))
    bad = [m for m in bad if sys.modules[m] is not None]
    print(len(names), "modules;", "leaked:", bad)
    print(" ".join(names))
    sys.exit(1 if bad else 0)
""")

#: modules the import walk must reach (the control plane's and the
#: training slices among them), beside its count
CONTROL_SLICE = ("repro_torch.stream.fleet.control",
                 "repro_torch.runtime.straggler", "repro_torch.runtime.health",
                 "repro_torch.obs.events", "repro_torch.obs.slo",
                 "repro_torch.obs.export", "repro_torch.obs.costmodel",
                 "repro_torch.kernels.cost")
TRAIN_SLICE = ("repro_torch.optim", "repro_torch.optim.adamw",
               "repro_torch.optim.schedule", "repro_torch.checkpoint",
               "repro_torch.checkpoint.manager", "repro_torch.data.pipeline",
               "repro_torch.runtime.compression", "repro_torch.launch.train")
LAUNCH_SLICE = tuple(f"repro_torch.launch.{m}" for m in (
    "mesh", "specs", "shardctx", "sharding", "partition", "hlo", "probe",
    "dryrun")) \
    + ("repro_torch.kernels.dedupe_window.ref",)


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 89, r.stdout
    walked = set(r.stdout.splitlines()[1].split())
    assert set(CONTROL_SLICE) <= walked
    assert set(TRAIN_SLICE) <= walked
    assert set(LAUNCH_SLICE) <= walked


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            roots.add("__import__")
    return roots


def test_chip_smoke_imports_neither_jax_nor_repro():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro", "__import__"}, roots


def test_torch_examples_import_neither_jax_nor_repro():
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert [p.name for p in twins] == [
        "disaster_recovery_torch.py", "edge_stream_analytics_torch.py",
        "federated_stream_train_torch.py", "fleet_stream_analytics_torch.py",
        "quickstart_torch.py"]
    for path in twins:
        roots = _imported_roots(path)
        assert "repro_torch" in roots, path.name
        assert not roots & {"jax", "jaxlib", "repro", "__import__"}, \
            (path.name, roots)
