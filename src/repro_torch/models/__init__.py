"""Port of ``repro.models``: the GQA decoder-only LM with SOI."""
