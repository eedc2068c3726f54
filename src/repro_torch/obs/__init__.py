"""Observability of the port: host span timers (`spans`).  The JAX
package's schema, sinks, buffers and probes come with a later slice."""
