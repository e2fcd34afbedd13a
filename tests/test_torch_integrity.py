"""The port's integrity plane against the JAX package's: content ids
(against JAX's SHA-1, run op by op, and ``hashlib``), ``forge_payloads``
from JAX's draws, the signature stage's submit / drain conservation and
its null path without ``cryptography`` and ``msgpack``, and values
signed by one package and checked by the other (the to-sign bytes
equal)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.core.value import Value as JValue
from opendht_tpu.crypto import identity as jid
from opendht_tpu.crypto import securedht as jsec
from opendht_tpu.models import integrity as ji
from opendht_tpu_torch.crypto import identity as tid
from opendht_tpu_torch.crypto import signing as tsig
from opendht_tpu_torch.core.value import Value as TValue
from opendht_tpu_torch.models import integrity as ti

from torch_port_cases import assert_same, to_torch

ROOT = Path(__file__).resolve().parent.parent
W = 8


def payloads(seed, p=32, w=W):
    return np.random.default_rng(seed).integers(
        0, 2**32, (p, w), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("w", [1, 8, 16])
def test_content_ids_vs_jax_and_hashlib(w):
    pl = payloads(w, w=w)
    with jax.disable_jit():           # JAX's SHA-1 op by op (see sha1 tests)
        want = np.asarray(ji.content_ids(jnp.asarray(pl)))
    got = ti.content_ids(to_torch(pl))
    assert_same([want], [got], "content ids")
    assert np.array_equal(ti.content_ids_host(pl), want)
    assert np.array_equal(ti.content_ids_host(to_torch(pl)),
                          ji.content_ids_host(pl))
    assert np.array_equal(ti.content_ids_host(pl[0]), want[:1])


@pytest.mark.parametrize("flip_frac", [1.0, 0.5])
def test_forge_payloads_with_jax_draws(flip_frac):
    """JAX's three draws (rows, word, bit) handed across: the same
    forged rows, and every forged row's id moves."""
    pl = payloads(3, p=64)
    key = jax.random.PRNGKey(4)
    fj, hj = ji.forge_payloads(jnp.asarray(pl), key, flip_frac)
    k1, k2, k3 = jax.random.split(key, 3)
    hit = jax.random.uniform(k1, (64,)) < flip_frac
    col = jax.random.randint(k2, (64,), 0, W)
    bit = jax.random.randint(k3, (64,), 0, 32)
    ft, ht = ti.forge_payloads(to_torch(pl), to_torch(hit), to_torch(col),
                               to_torch(bit))
    assert_same([fj, hj], [ft, ht], "forged payloads")
    h = ht.numpy()
    flips = np.unpackbits((ft.numpy().astype(np.uint32) ^ pl).view(np.uint8),
                          axis=1).sum(axis=1)
    assert (flips[h] == 1).all() and (flips[~h] == 0).all()
    ids0, ids1 = ti.content_ids_host(pl), ti.content_ids_host(ft)
    assert (ids0[h] != ids1[h]).any(axis=1).all()
    assert (ids0[~h] == ids1[~h]).all()
    # Drawn from a generator: one bit flipped in each chosen row.
    fg, hg = ti.forge_payloads(to_torch(pl), flip_frac=0.5,
                               generator=torch.Generator().manual_seed(1))
    d = np.unpackbits((fg.numpy().astype(np.uint32) ^ pl).view(np.uint8),
                      axis=1).sum(axis=1)
    assert (d == hg.numpy()).all()


def test_signature_stage_conserves():
    """Signed values (one tampered) through two batches: verified +
    failed == submitted, and a drained stage refuses more."""
    assert ti.HAVE_CRYPTO
    vals, ident = ti.make_signed_values(6, key_length=1024)
    assert ident and all(tsig.check_value_signature(v) for v in vals)
    vals[2].data = b"tampered"
    st = ti.SignatureStage()
    st.submit(vals[:4])
    st.submit(vals[4:] + ["not a value"])
    st.submit([])
    out = st.drain()
    assert out["available"] and out["submitted"] == 7 and out["batches"] == 3
    assert out["verified"] == 5 and out["failed"] == 2
    assert out["verified"] + out["failed"] == out["submitted"]
    assert st.drain()["submitted"] == 7
    with pytest.raises(RuntimeError, match="after drain"):
        st.submit(vals)


def test_null_path_without_crypto_packages():
    """With ``cryptography`` and ``msgpack`` unimportable, every port
    module still imports, the stage reports null figures and counts its
    submissions, and ``make_signed_values`` returns ``(None, None)``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("cryptography", "msgpack"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import opendht_tpu_torch
        for m in pkgutil.walk_packages(opendht_tpu_torch.__path__,
                                       "opendht_tpu_torch."):
            importlib.import_module(m.name)
        from opendht_tpu_torch.models import integrity as ti
        assert not ti.HAVE_CRYPTO
        st = ti.SignatureStage()
        assert not st.available
        st.submit([1, 2, 3])
        st.submit([4])
        out = st.drain()
        assert out == {"available": False, "submitted": 4, "batches": 2,
                       "verified": None, "failed": None,
                       "verify_wall_s": None, "verifies_per_sec": None}, out
        assert ti.make_signed_values(3) == (None, None)
        assert "cryptography" not in sys.modules
        print("null path ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "null path ok" in out.stdout


@pytest.fixture(scope="module")
def keys():
    return (tid.generate_identity("port", key_length=1024),
            jid.generate_identity("jax", key_length=1024))


def _twin(v, owner, to_jax):
    """The same value in the other package, owner key carried as DER."""
    w = (JValue if to_jax else TValue)(v.data, type_id=v.type,
                                       value_id=v.id, user_type=v.user_type)
    w.seq, w.recipient, w.signature = v.seq, v.recipient, v.signature
    mod = jid if to_jax else tid
    w.owner = mod.PublicKey.from_packed(owner.packed())
    return w


@pytest.mark.parametrize("extra", [False, True])
def test_cross_signatures(extra, keys):
    """A value signed by the port checks under JAX's
    ``check_value_signature`` and the reverse; ``get_to_sign`` and the
    wire form are the same bytes; a changed byte fails both."""
    ident_t, ident_j = keys
    vt = TValue(b"\x00payload" * 9, value_id=77)
    vj = JValue(b"\x00payload" * 9, value_id=77)
    if extra:
        for v in (vt, vj):
            v.seq, v.user_type, v.recipient = 5, "text/plain", b"\x07" * 20
    tsig.sign_value(ident_t.key, vt)
    jsec.sign_value(ident_j.key, vj)
    vt_j, vj_t = _twin(vt, vt.owner, True), _twin(vj, vj.owner, False)
    assert vt_j.get_to_sign() == vt.get_to_sign()
    assert vj_t.get_to_sign() == vj.get_to_sign()
    assert vt_j.packed() == vt.packed() and vj_t.packed() == vj.packed()
    assert jsec.check_value_signature(vt_j)
    assert tsig.check_value_signature(vj_t)
    assert jsec.verify_values_batch([vt_j]) == tsig.verify_values_batch(
        [vj_t]) == [True]
    vt_j.data = vj_t.data = b"changed"
    assert not jsec.check_value_signature(vt_j)
    assert not tsig.check_value_signature(vj_t)
    assert ident_t.certificate.get_name() == "port"
    assert ident_t.certificate.get_public_key() == ident_t.key.get_public_key()
    assert ident_t.certificate.packed()[:1] == b"\x30"
    enc = TValue(b"x")
    enc.cypher = b"sealed"
    with pytest.raises(tid.CryptoException):
        tsig.sign_value(ident_t.key, enc)
