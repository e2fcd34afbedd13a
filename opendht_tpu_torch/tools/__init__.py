"""Command-line tools over the host node: ``dhtnode``, ``dhtchat``,
``dhtscanner`` and ``http_gateway``; and the artifact checkers:
``check_trace`` (flight-recorder, cost-ledger, serve, monitor, index,
soak, auth and chunked artifacts), ``check_bench`` (a bench row against
a recorded one) and ``roofline`` (a cost ledger's roofline verdict).
Each runs as ``python -m opendht_tpu_torch.tools.<name>``."""
