"""Host-side value signing for the integrity plane's signature stage.

The port's own minimal copy of what signing a value needs: RSA keys and
a self-signed identity (:mod:`.identity`) and the sign / check /
batch-verify calls (:mod:`.signing`) over the to-sign form of
:class:`~opendht_tpu_torch.core.value.Value`.  ``cryptography`` is
optional: it is imported only where a key is made, so every module here
imports without it, and :data:`HAVE_CRYPTO` says whether it is
present.
"""


def _have_crypto() -> bool:
    try:
        import cryptography  # noqa: F401
    except ImportError:
        return False
    return True


HAVE_CRYPTO = _have_crypto()
