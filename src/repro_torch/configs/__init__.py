"""Config registry (port of `repro/configs`): importing this package
registers every architecture the port runs: the LM family, dlrm-rm2 and
`wharf-stream`. The GNN archs wait for the port's `models/gnn.py`."""
from repro_torch.configs.base import (  # noqa: F401
    ArchSpec,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    all_archs,
    all_cells,
    get_arch,
)
import repro_torch.configs.lm_archs  # noqa: F401,E402
import repro_torch.configs.recsys_archs  # noqa: F401,E402
import repro_torch.configs.wharf_stream  # noqa: F401,E402
