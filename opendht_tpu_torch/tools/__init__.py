"""Command-line tools over the host node: ``dhtnode``, ``dhtchat``,
``dhtscanner`` and ``http_gateway``, each run as
``python -m opendht_tpu_torch.tools.<name>``."""
