"""Port of ``repro.core``: the SOI streaming primitives the LM path needs."""
