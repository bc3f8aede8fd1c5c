"""Config registry (port of `repro/configs`): importing this package
registers every architecture the port runs. Only `wharf-stream` so far;
the LM, GNN and recsys archs wait for the port's `models/`."""
from repro_torch.configs.base import (  # noqa: F401
    ArchSpec,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    all_archs,
    all_cells,
    get_arch,
)
import repro_torch.configs.wharf_stream  # noqa: F401,E402
