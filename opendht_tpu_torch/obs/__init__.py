"""Host-side observability of the port: hop-model fidelity, keyspace
density, sweep and resident-loop summaries."""
