"""Paper architecture: GhostNet for acoustic scene classification (Table 4,
7 sizes I..VII), the port's copy of ``repro.configs.soi_ghostnet_asc``.
Width plans fitted so parameter counts track the published sizes (within
~15 %; exact ghost-module internals unpublished) and the S-CC placement
(block 4 of 5) lands near the paper's ~16 % MAC reduction."""

from __future__ import annotations

from repro_torch.core.soi import SOIConvCfg
from repro_torch.models.ghostnet import GhostNetConfig

# size: (in_channels, widths) — params ~ paper's 1470 .. 83432
SIZES = {
    "I": (10, (6, 8, 12, 16, 18)),
    "II": (24, (8, 12, 16, 20, 24)),
    "III": (24, (10, 16, 20, 24, 30)),
    "IV": (10, (14, 20, 28, 36, 42)),
    "V": (10, (24, 36, 48, 60, 72)),
    "VI": (10, (34, 52, 68, 84, 102)),
    "VII": (10, (44, 66, 88, 110, 132)),
}

SOI_PLACEMENT = (4,)    # ~16-21 % MAC reduction vs STMC (paper: ~16 %)


def config(size: str = "IV", soi: SOIConvCfg | None = None) -> GhostNetConfig:
    if soi is None:
        soi = SOIConvCfg(pairs=SOI_PLACEMENT)
    inc, widths = SIZES[size]
    return GhostNetConfig(in_channels=inc, n_classes=10, widths=widths,
                          soi=soi)


def smoke_config(soi: SOIConvCfg | None = None) -> GhostNetConfig:
    return GhostNetConfig(in_channels=8, n_classes=4, widths=(8, 12, 16),
                          soi=soi or SOIConvCfg(pairs=(2,)))
