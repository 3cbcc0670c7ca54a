"""The port's paper harness (``repro_torch.experiments.paper``) against the
reference's ``benchmarks/run.py``, run live on the CPU: Tables 2–5, Figs. 5,
12 and 15, the roofline and the kernels sections.

Each case runs the reference's section and the port's with the same
arguments and compares the rows: every deterministic ``derived`` field
exactly (the paper's tables, the calibrated estimates, each scenario's α*
and GA evaluations, the means, deviations and gains, the runtime's pool
counts), time-only fields by shape and sign only.
"""
import math

import pytest
import torch

from _paper_harness import CPU, capture, fields, named, reference_harness, section_args
from _paper_harness import one_thread  # noqa: F401  (autouse fixture)
from repro_torch.experiments import paper

REF = reference_harness()


def _pair(section, port_kwargs=None, **kw):
    args = section_args(section, **kw)
    ref, _ = capture(REF.SECTIONS[section], args)
    port, value = capture(paper.SECTIONS[section], args, CPU, **(port_kwargs or {}))
    return ref, port, value


@pytest.mark.parametrize("section", ["table2", "table3"])
def test_paper_tables_equal_reference(section):
    """The paper's measured tables: every row, its time included, equal."""
    ref, port, _ = _pair(section)
    assert port == ref and len(port) > 20


def test_table4_estimates_equal_reference_and_live_row_on_the_device():
    ref, port, _ = _pair("table4", dict(channels=4, spatial=8))
    assert [r for r in port if ".npu" in r[0]] == [r for r in ref if ".npu" in r[0]]
    assert len([r for r in port if ".npu" in r[0]]) == 9
    (name, us, derived), = [r for r in port if ".live_" in r[0]]
    assert name == "table4.live_cpu.selfie_seg" == [r for r in ref if ".live_" in r[0]][0][0]
    assert us > 0 and float(fields(derived)["est_ratio"]) > 0
    assert fields(derived)["spatial"] == "8"


def test_fig5_fits_host_copies():
    ref, port, _ = _pair("fig5")
    assert [r[0] for r in port] == [r[0] for r in ref]
    for name, us, derived in port:
        assert derived.endswith(";host") and us > 0
    fit = fields(named(port)["fig5.fit"][1])
    assert all(math.isfinite(float(fit[k])) for k in ("a_lo", "b_lo", "a_hi", "b_hi"))


@pytest.mark.parametrize("section", ["fig12", "fig15"])
def test_saturation_figures_equal_reference(section):
    """Puzzle's, Best Mapping's and NPU Only's α* per scenario (seeds 2025
    and the scenario index), each GA's evaluations, the capped means, the
    deviations and the frequency gains: all equal to the reference's."""
    ref, port, _ = _pair(section)
    assert [(n, d) for n, _, d in port] == [(n, d) for n, _, d in ref]
    for name in (f"{section}.mean_puzzle", f"{section}.mean_best_mapping",
                 f"{section}.mean_npu_only"):
        assert named(port)[name][0] == named(ref)[name][0]
    assert sum(n.startswith(f"{section}.scenario") for n, _, _ in port) == 3


def test_table5_pool_counts_equal_reference_at_its_sizes():
    """The runtime ablation at the reference's reduced networks (channels 4,
    spatial 8): bytes copied and staged copies equal the reference's, and so
    do the mallocs without a pool (one a request) and with the shared
    buffer (none). With the pool alone a request reuses the buffer the last
    one freed, unless the two overlapped in time: one malloc, more on a
    loaded host, in both packages. Every makespan finite."""
    ref, port, makespans = _pair("table5", dict(channels=4, spatial=8))
    assert [r[0] for r in port] == ["table5.no_opt", "table5.pool", "table5.pool+shared"]
    for (name, _, d_ref), (_, us, d_port) in zip(ref, port, strict=True):
        a, b = fields(d_ref), fields(d_port)
        assert {k: b[k] for k in ("memcpy_bytes", "staged")} == \
            {k: a[k] for k in ("memcpy_bytes", "staged")}, name
        if name == "table5.pool":
            assert 1 <= int(b["mallocs"]) <= int(fields(ref[0][2])["mallocs"])
        else:
            assert b["mallocs"] == a["mallocs"], name
        assert math.isfinite(us) and us > 0
    assert len(makespans) == 3 and all(math.isfinite(m) and m > 0 for m in makespans)


def test_table5_defaults_to_the_papers_resolutions():
    zoo = paper._zoo(("face_det", "selfie_seg", "hand_det"), CPU, 8, None)
    assert {n: m.spatial for n, m in zoo.items()} == {
        "face_det": 128, "selfie_seg": 256, "hand_det": 192}


def test_roofline_reads_the_ports_dry_run_records(tmp_path, monkeypatch):
    """A record ``run_one`` writes for one small config on the 16×16 fake
    mesh gives one row: its largest term and bottleneck. Without records
    both harnesses print ``roofline.missing``."""
    import repro_torch.launch.dryrun as dryrun
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.shapes import InputShape

    empty, _ = capture(paper.bench_roofline, section_args("roofline"), CPU,
                       results_dir=str(tmp_path))
    ref, _ = capture(REF.bench_roofline, section_args("roofline"))
    assert [r[0] for r in empty] == [r[0] for r in ref] == ["roofline.missing"]

    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    try:
        rec = dryrun.run_one("qwen3-14b", InputShape("p", 64, 32, "prefill"), "single",
                             cfg=get_smoke_config("qwen3-14b"), verbose=False)
    finally:
        mesh_mod.release()
    assert rec["ok"], rec.get("error")
    rows, _ = capture(paper.bench_roofline, section_args("roofline"), CPU,
                      results_dir=str(tmp_path))
    (name, us, derived), = rows
    assert name == "roofline.qwen3-14b.p"
    terms = {k: rec[k] for k in ("t_compute", "t_memory", "t_collective")}
    assert us == pytest.approx(max(terms.values()) * 1e6, abs=0.01)
    got = fields(derived)
    assert got["bottleneck"] == rec["bottleneck"]
    assert float(got["compute"][:-1]) == pytest.approx(rec["t_compute"], abs=1e-4)


def test_kernels_rows_hold_their_oracles_on_the_cpu():
    """K2 at the reference's row (f32 and bf16), K3 and K1 at shapes of
    ``tests/test_kernels.py``: on the CPU the plain versions against the
    oracles, within ``test_kernels.py``'s tolerances; the reference's own
    row agrees with its oracle as well."""
    ref, port, rows = _pair("kernels")
    assert float(fields(named(ref)["kernels.flash_attention"][1])["max_err_vs_ref"]) < 2e-5
    assert [r[0] for r in port] == ["kernels.flash_attention", "kernels.flash_attention.bf16",
                                    "kernels.ssd_scan", "kernels.ssd_scan.bf16",
                                    "kernels.quantize_int8"]
    limits = {"kernels.flash_attention": 2e-5, "kernels.flash_attention.bf16": 2e-2,
              "kernels.ssd_scan": 2e-4, "kernels.ssd_scan.bf16": 3e-2}
    for row in rows:
        assert row["route"] == "plain" and row["launches"] == 0
        if row["name"] in limits:
            assert row["max_err_vs_ref"] <= limits[row["name"]], row["name"]
        for got, plain in row["outputs"]:
            assert torch.equal(got, plain), row["name"]
    assert rows[-1]["q_mismatches_vs_plain"] == 0
    for _, _, derived in port:
        assert derived.endswith("oracle check only")

