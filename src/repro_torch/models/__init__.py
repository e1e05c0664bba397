"""Port of ``repro.models``: the decoder-only LMs with SOI and the paper's
streaming U-Net."""
