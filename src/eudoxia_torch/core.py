"""``from eudoxia_torch.core import Scheduler, Failure, Assignment,
Pipeline`` (paper Listing 4)."""
from repro_torch.core import (  # noqa: F401
    Assignment,
    Failure,
    Operator,
    Pipeline,
    PipeStatus,
    Priority,
    Scheduler,
    SimParams,
    Suspension,
)
