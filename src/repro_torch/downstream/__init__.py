"""Downstream: streaming embedding maintenance co-scheduled with walk
updates (paper §7.6); port of `repro/downstream/`."""
from repro_torch.downstream.maintainer import (  # noqa: F401
    EmbeddingMaintainer,
    MaintainerConfig,
    MaintainerState,
    StepMetrics,
    init_maintainer,
    maintain_step,
)
