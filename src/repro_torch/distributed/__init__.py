"""Distributed substrate of the port: fault tolerance (the supervisor and
elastic restore). Sharding, collectives and pipelining are not ported yet
(ROADMAP.md)."""
