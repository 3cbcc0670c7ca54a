"""Mobile model zoo: the paper's nine networks + measured profile tables
(port of ``repro.zoo``)."""
from .mobile import (
    COMPUTE_DTYPES,
    ExecutableMobileModel,
    all_cost_graphs,
    executable_zoo,
    make_cost_graph,
)
from .profiles import (
    MODEL_NAMES,
    MODEL_SPECS,
    TABLE4_RATIO,
    best_processor_times_s,
    paper_profile_tables,
)

__all__ = [k for k in dir() if not k.startswith("_")]
