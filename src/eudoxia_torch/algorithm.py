"""``from eudoxia_torch.algorithm import register_scheduler,
register_scheduler_init`` (paper Listing 4)."""
from repro_torch.core.algorithm import (  # noqa: F401
    register_scheduler,
    register_scheduler_init,
)
from repro_torch.core.scheduler import (  # noqa: F401
    register_vector_scheduler,
    register_vector_scheduler_init,
)
