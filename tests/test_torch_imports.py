"""The port imports neither JAX nor anything of the JAX package, nor
``msgpack`` (its checkpoints carry their own codec)."""
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
assert "msgpack" not in sys.modules, "msgpack imported"
print(len(names))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 71      # every submodule was walked


NEW_IN_6C = ("repro_torch.core.batchsim_compiled", "repro_torch.kernels.batchsim_advance",
             "repro_torch.experiments", "repro_torch.experiments.specs",
             "repro_torch.experiments.evaluate", "repro_torch.experiments.aggregate",
             "repro_torch.experiments.sweep", "repro_torch.analysis.lint")

PROBE_CLIS = """
import runpy, sys
sys.argv = ["lint", "--demo"]
try:
    runpy.run_module("repro_torch.analysis.lint", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
sys.argv = ["sweep", "--help"]
try:
    runpy.run_module("repro_torch.experiments.sweep", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
"""


def test_clis_run_without_jax_or_reference():
    """The sweep and lint CLIs (and the compiled tier they load) import no
    JAX and nothing of the JAX package."""
    out = subprocess.run([sys.executable, "-c", PROBE_CLIS],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "linted" in out.stdout and "--batch-engine" in out.stdout


def test_new_modules_are_walked():
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert set(NEW_IN_6C) <= names


PROBE_TRAIN = """
import runpy, sys, tempfile, os
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.train import TrainConfig, train
sys.argv = ["train", "--help"]
try:
    runpy.run_module("repro_torch.launch.train", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "ck.msgpack")
    cfg = get_smoke_config("phi4-mini-3.8b")
    tc = TrainConfig(steps=2, batch_size=2, seq_len=16, log_every=0, checkpoint_path=path,
                     checkpoint_every=1)
    train(cfg, tc, device="cpu")
    tc.steps = 3
    assert len(train(cfg, tc, device="cpu").losses) == 1   # resumed from the file
for mod in ("jax", "msgpack"):
    assert mod not in sys.modules, mod + " imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
print("trained")
"""


def test_training_imports_no_jax_reference_or_msgpack():
    """``repro_torch.train`` and ``repro_torch.launch.train``: a checkpointed
    run and its resume load neither JAX, the JAX package nor ``msgpack``."""
    out = subprocess.run([sys.executable, "-c", PROBE_TRAIN],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "trained" in out.stdout and "--remat" in out.stdout
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert {"repro_torch.train", "repro_torch.train.checkpoint", "repro_torch.train._msgpack",
            "repro_torch.train.loop", "repro_torch.launch.train"} <= names
