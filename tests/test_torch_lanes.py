"""Slice 6d on the port: lanes of H100s (``gpu_lanes``), the lane boundary's
cost (``LANE_COMM_MODEL``) and the lane roofline backend
(``LaneRooflineBackend``), the counterparts of the reference's
``tpu_lanes``, ``TPU_COMM_MODEL`` and TPU-lane backend, on the CPU.

The template is ``tests/test_profiler_zoo.py``'s lane case (the biggest
lane is not always the best), on the node's 7 + 1 cards where the
reference splits a pod's 128 + 8 chips. The backend keeps the reference's
formula: with the reference's ramp constants, on lanes of the reference's
figures, it gives the reference's times exactly (to float rounding); its
own constants are the ramp fit to the bf16 product rates that
``chip_smoke.py``'s ``lanes`` phase measured on the card.
"""
import dataclasses

import pytest

import repro.core as ref
from repro.zoo import make_cost_graph as ref_cost_graph
from repro_torch.core import (
    LANE_COMM_MODEL,
    LaneRooflineBackend,
    PiecewiseLinearCommModel,
    Processor,
    gpu_lanes,
    whole_model_placement,
)
from repro_torch.core import processors
from repro_torch.core.profiler import fit_efficiency_ramp
from repro_torch.zoo import make_cost_graph

MODELS = ("face_det", "selfie_seg", "fastsam_s")


def test_lane_roofline_backend_biggest_not_always_best():
    lanes = gpu_lanes((7, 1))
    backend = LaneRooflineBackend(lanes)
    small = make_cost_graph("face_det")
    big = make_cost_graph("fastsam_s")
    t_small_big_lane = backend.measure(whole_model_placement(small, 0, 0, 1, 0))
    t_small_small_lane = backend.measure(whole_model_placement(small, 0, 1, 1, 0))
    # tiny model: the big lane's rate per card collapses, so the small lane
    # wins or is at least competitive
    assert t_small_small_lane < t_small_big_lane * 10
    t_big_big = backend.measure(whole_model_placement(big, 0, 0, 1, 0))
    t_big_small = backend.measure(whole_model_placement(big, 0, 1, 1, 0))
    assert t_big_big < t_big_small  # the big model wants the big lane


@pytest.mark.parametrize("dtype_ix", [0, 1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_lane_backend_equals_reference_on_equal_lanes(name, dtype_ix):
    """The port's backend with the reference's ramp (2e8, 0.55, 0.05), on
    lanes with the reference's TPU-lane figures field for field, gives the
    reference's time for the same whole-model placement on every lane."""
    ref_lanes = ref.tpu_lanes((128, 64, 32, 16))
    lanes = tuple(Processor(**{f.name: getattr(lane, f.name)
                               for f in dataclasses.fields(Processor)}) for lane in ref_lanes)
    ours = LaneRooflineBackend(lanes, min_work_per_chip=2e8, eff_scale=0.55, eff_floor=0.05)
    theirs = ref.LaneRooflineBackend(ref_lanes)
    graph, ref_graph = make_cost_graph(name), ref_cost_graph(name)
    for lane in range(len(lanes)):
        got = ours.measure(whole_model_placement(graph, 0, lane, dtype_ix, 0))
        want = theirs.measure(ref.whole_model_placement(ref_graph, 0, lane, dtype_ix, 0))
        assert got == pytest.approx(want, rel=1e-12)


def test_gpu_lanes_mirror_tpu_lanes():
    """The reference's lane record, field for field, with the card's figures:
    the datasheet's bf16 peak, the measured copy bandwidth and launches;
    lanes beyond the node's cards are refused."""
    lanes, tpu = gpu_lanes((4, 2, 1, 1)), ref.tpu_lanes((128, 64, 32, 16))
    assert [lane.pid for lane in lanes] == [lane.pid for lane in tpu]
    assert [lane.chips for lane in lanes] == [4, 2, 1, 1]
    for lane in lanes:
        assert lane.kind == "gpu-lane" and lane.name == f"lane{lane.pid}x{lane.chips}"
        assert lane.peak_flops == lane.chips * processors.H100_PEAK_FLOPS_BF16 == lane.chips * 989e12
        assert lane.hbm_bw == lane.chips * processors.H100_COPY_BW
        assert lane.thr("int8", "default") == 2 * lane.thr("fp16", "default")
        assert lane.invocation_overhead == processors.H100_GRAPH_LAUNCH_OVERHEAD
    with pytest.raises(ValueError, match="exceed"):
        gpu_lanes((8, 1))


def test_lane_comm_model_is_a_launch_plus_nvlink():
    """LANE_COMM_MODEL costs what the reference's model of the same fields
    costs (a launch plus NVLink's datasheet bandwidth), and the port's
    model with TPU_COMM_MODEL's fields costs what TPU_COMM_MODEL does."""
    m = LANE_COMM_MODEL
    theirs = ref.PiecewiseLinearCommModel(a_lo=m.a_lo, b_lo=m.b_lo, a_hi=m.a_hi, b_hi=m.b_hi,
                                          knee=m.knee, bandwidth=m.bandwidth)
    tpu = ref.TPU_COMM_MODEL
    ours_tpu = PiecewiseLinearCommModel(a_lo=tpu.a_lo, b_lo=tpu.b_lo, a_hi=tpu.a_hi,
                                        b_hi=tpu.b_hi, knee=tpu.knee, bandwidth=tpu.bandwidth)
    for n in (0, 1 << 10, (1 << 20) - 1, 1 << 20, 1 << 26):
        assert m.cost(n) == theirs.cost(n)
        assert ours_tpu.cost(n) == tpu.cost(n)
        if n:
            want = processors.H100_LAUNCH_OVERHEAD + n / processors.H100_NVLINK_BW
            assert m.cost(n) == pytest.approx(want)
    assert m.bandwidth == 450e9          # NVLink 4's datasheet figure


def test_efficiency_ramp_is_fit_from_the_measured_rates():
    """The backend's default ramp is the fit of the measured bf16 product
    rates over the datasheet peak, and follows each rate within 12%."""
    rates, peak = processors.H100_GEMM_RATES, processors.H100_PEAK_FLOPS_BF16
    knee, scale, floor = fit_efficiency_ramp(rates, peak)
    backend = LaneRooflineBackend(gpu_lanes((1,)))
    assert backend.min_work_per_chip == pytest.approx(knee, rel=1e-4)
    assert backend.eff_scale == pytest.approx(scale, rel=1e-4)
    assert backend.eff_floor == pytest.approx(floor, rel=1e-4)
    for work, rate in rates:
        eff = min(1.0, work / knee) * scale + floor
        assert eff * peak == pytest.approx(rate, rel=0.12)
    assert processors.H100_GEMM_PEAK_MEASURED == max(r for _, r in rates) < peak
    # a second run's rates on the same card, whose free fit has a floor
    # just below 0: the floor is held at 0, so no work gets a negative rate
    second = ((3.3554e7, 1.7351e12), (2.6844e8, 1.3885e13), (2.1475e9, 1.1131e14),
              (1.7180e10, 6.4429e14), (1.3744e11, 7.5412e14), (1.0995e12, 7.8238e14))
    knee2, scale2, floor2 = fit_efficiency_ramp(second, peak)
    assert floor2 == 0.0 and knee2 == pytest.approx(knee, rel=0.2)
    assert scale2 == pytest.approx(scale, rel=0.05)
