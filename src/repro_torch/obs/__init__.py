"""Observability of the port: host span timers (`spans`) and the Sophia
health probes (`probes`).  The JAX package's schema, sinks and buffers
come with a later slice."""
