"""Port of ``repro.core``: STMC streaming convs, the SOI primitives of
conv encoder/decoder networks, and their MAC accounting."""
