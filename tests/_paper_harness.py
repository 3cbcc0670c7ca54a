"""Helpers of the paper-harness parity tests: the reference's
``benchmarks/run.py`` loaded read-only, its sections and the port's
(``repro_torch.experiments.paper``) run with the same arguments, their CSV
rows captured."""
import argparse
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def reference_harness():
    """``benchmarks/run.py`` as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location("_reference_paper_harness",
                                                  ROOT / "benchmarks" / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def section_args(section, **kw):
    """The namespace both harnesses' ``main`` would pass for ``section``
    selected explicitly; ``smoke`` unless overridden."""
    base = dict(section=section, only=None, full=False, smoke=True, json=False)
    base.update(kw)
    return argparse.Namespace(**base)


def capture(fn, *args, **kwargs):
    """(rows, return value) of a section: rows as (name, us, derived)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = fn(*args, **kwargs)
    return parse(out.getvalue()), value


def parse(text):
    rows = []
    for line in text.splitlines():
        name, us, derived = line.split(",", 2)
        rows.append((name, float(us), derived))
    return rows


def fields(derived):
    """``k=v;k=v`` → dict (parts without ``=`` are dropped)."""
    return dict(part.split("=", 1) for part in derived.split(";") if "=" in part)


def named(rows):
    return {name: (us, derived) for name, us, derived in rows}



@contextlib.contextmanager
def single_thread():
    """One intra-op thread for torch inside the block (restored after).
    These CPU paths run thousands of tiny convolutions and attention calls;
    with a test worker on every core, torch's thread pool waits on threads
    the other workers hold, and a 6 s example took over 5 minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_thread():
    with single_thread():
        yield
