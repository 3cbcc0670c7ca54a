"""Three-scenario sweep on the port: the paper's headline comparison, in miniature.

The port of ``examples/sweep_small.py``, importing only ``repro_torch``:
generate three randomized scenarios (paper §6.1 recipe: 1-3 model groups,
1-4 models each from the nine-network zoo), run Puzzle's GA plus the NPU
Only and Best Mapping baselines on each, bisection-search every method's
saturation multiplier α*, and aggregate the frequency-gain ratios the paper
reports as 3.7×/2.2× (§6, Fig. 11).

The run directory is resumable: re-running this script reloads finished
scenarios instead of recomputing them. Same seed → same scenarios, same
numbers, on any worker count. ``--device`` is where a compiled batch
engine would run (the card unless ``--device cpu``); this demo's scalar
engine runs on the host.

Usage: PYTHONPATH=src python examples/sweep_small_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.experiments import (
    METHODS,
    SweepConfig,
    format_summary,
    generate_scenario_specs,
    run_sweep,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    specs = generate_scenario_specs(count=3, seed=7)
    for spec in specs:
        print(f"{spec.name}: " + " | ".join(
            ", ".join(g) for g in spec.groups))

    # a reduced GA budget keeps this demo fast; the real protocol uses the
    # SweepConfig defaults (pop 20 x <=30 generations, 120 BM evals)
    config = SweepConfig(pop_size=12, max_generations=12, min_generations=4,
                         bm_max_evals=60)
    run_dir = os.path.join(tempfile.gettempdir(), "puzzle_sweep_small_torch")
    # force=True: a stale run dir from an older version of this demo (with a
    # different config) is wiped instead of raising a config-mismatch error
    doc = run_sweep(specs, config, run_dir=run_dir, workers=1, force=True,
                    log=lambda m: print(m, flush=True), device=device)

    print()
    print(f"{'scenario':16s} " + " ".join(f"{m:>13s}" for m in METHODS))
    for row in doc["scenarios"]:
        stars = [
            "never" if row["alpha_star"][m] is None
            else f"{row['alpha_star'][m]:.2f}"
            for m in METHODS
        ]
        print(f"{row['spec']['name']:16s} "
              + " ".join(f"a*={s:>9s}" for s in stars))
    print()
    print(format_summary(doc))
    print(f"\nrun dir (resumable): {run_dir}")
    return doc


if __name__ == "__main__":
    main()
