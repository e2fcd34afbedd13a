"""The public-key crypto layer: identities, certificates and their
revocation lists, hybrid and password encryption (:mod:`.identity`),
value signing (:mod:`.signing`, shared with the integrity plane) and the
``SecureDht`` overlay (:mod:`.securedht`).  ``cryptography`` is
optional: it is imported only where a key, a certificate or a cipher is
made or used, so every module here imports without it, and
:data:`HAVE_CRYPTO` says whether it is present.
"""


def _have_crypto() -> bool:
    try:
        import cryptography  # noqa: F401
    except ImportError:
        return False
    return True


HAVE_CRYPTO = _have_crypto()
