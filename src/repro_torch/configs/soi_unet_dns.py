"""Paper architecture: the speech-separation U-Net (7 enc + 7 dec, STMC
lineage), the port's copy of ``repro.configs.soi_unet_dns``.

The paper gives the layer count, the topology and the total complexity
(1819.2 MMAC/s at the DNS 16 kHz / 62.5 fps frame rate) but not the channel
widths. The widths below were fitted so that the per-position
compressed-region shares r_p reproduce every published retain percentage
(Tables 1/2/6); the total lands at 1807.7 MMAC/s (-0.6 % against the
paper).
"""

from __future__ import annotations

from repro_torch.core.soi import SOIConvCfg
from repro_torch.models.unet import UNetConfig

PAPER_BASELINE_MMACS = 1819.2
FITTED_CHANNELS = (616, 712, 312, 640, 664, 1208, 1296)


def config(soi: SOIConvCfg | None = None) -> UNetConfig:
    return UNetConfig(
        in_channels=128,
        out_channels=128,
        enc_channels=FITTED_CHANNELS,
        kernel=3,
        norm="batch",
        soi=soi,
        fps=62.5,
        mask_output=True,
    )


def smoke_config(soi: SOIConvCfg | None = None) -> UNetConfig:
    """Reduced same-family config: 4+4 layers, narrow."""
    if soi is None:
        soi = SOIConvCfg(pairs=(2,))
    return UNetConfig(
        in_channels=16,
        out_channels=16,
        enc_channels=(12, 16, 20, 24),
        kernel=3,
        norm="batch",
        soi=soi,
        fps=62.5,
    )
