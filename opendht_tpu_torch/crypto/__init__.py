"""Host-side value signing for the integrity plane's signature stage.

The port's own minimal copy of what signing a value needs: the value's
to-sign packing (:mod:`.value`), RSA keys and a self-signed identity
(:mod:`.identity`) and the sign / check / batch-verify calls
(:mod:`.signing`).  ``cryptography`` and ``msgpack`` are optional: they
are imported only where a key is made or a value packed, so every
module here imports without them, and :data:`HAVE_CRYPTO` says whether
they are present.
"""


def _have_crypto() -> bool:
    try:
        import cryptography  # noqa: F401
        import msgpack  # noqa: F401
    except ImportError:
        return False
    return True


HAVE_CRYPTO = _have_crypto()
