"""The port imports neither JAX nor anything of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {root!r})
import chip_smoke
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 58      # every submodule was walked
