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


PROBE_PAPER = """
import runpy, sys, tempfile, os
import torch
torch.set_num_threads(1)        # tiny CPU ops; the other test workers hold the cores
from repro_torch.experiments import paper
assert set(paper.SECTIONS) == {{"table2", "table3", "table4", "fig5", "fig12", "fig15", "table5",
                               "simspeed", "prescreen", "conformance", "sweep", "arrivals",
                               "faults", "roofline", "kernels"}}
small = ["--device", "cpu", "--channels", "4", "--spatial", "8"]
with tempfile.TemporaryDirectory() as d:
    os.chdir(d)                 # device_in_loop writes results/ under the working directory
    tempfile.tempdir = d        # sweep_small's run dir
    for script, argv in (("quickstart_torch", ["--device", "cpu"]),
                         ("serve_multimodel_torch", small),
                         ("device_in_loop_torch", small),
                         ("sweep_small_torch", ["--device", "cpu"])):
        sys.argv = [script] + argv
        runpy.run_path(os.path.join({root!r}, "examples", script + ".py"), run_name="__main__")
    os.chdir({root!r})
sys.argv = ["paper", "table3", "--device", "cpu"]
runpy.run_module("repro_torch.experiments.paper", run_name="__main__")
assert "jax" not in sys.modules, "jax imported"
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
print("examples ran")
"""


def test_paper_harness_and_examples_import_no_jax_or_reference():
    """``repro_torch.experiments.paper`` (its CLI run once) and the four new
    examples, each run to its end on the CPU, import neither JAX nor
    anything of the JAX package."""
    out = subprocess.run([sys.executable, "-c", PROBE_PAPER.format(root=str(ROOT))],
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "examples ran" in out.stdout and "table3.fastsam_s.NPU" in out.stdout
