"""Config registry (port of `repro/configs`): importing this package
registers every architecture of the reference: the LM family, the GNN
family, dlrm-rm2 and `wharf-stream`."""
from repro_torch.configs.base import (  # noqa: F401
    ArchSpec,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    all_archs,
    all_cells,
    get_arch,
)
import repro_torch.configs.gnn_archs  # noqa: F401,E402
import repro_torch.configs.lm_archs  # noqa: F401,E402
import repro_torch.configs.recsys_archs  # noqa: F401,E402
import repro_torch.configs.wharf_stream  # noqa: F401,E402
