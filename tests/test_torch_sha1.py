"""The port's batched SHA-1 against ``hashlib`` and the JAX package's, bit
for bit, at every byte length from 0 to 200 (the 55/56/64-byte padding
edges included), in each entry shape: variable-length rows
(``sha1_bytes``), one padded block (``sha1_pad_le55`` +
``sha1_one_block``) and fixed-width word rows (``sha1_words``).  The JAX
functions run op by op (``jax.disable_jit``): compiling their unrolled
four-block compression takes minutes on the CPU, and op by op they
compute the same words."""

import hashlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from opendht_tpu.ops import sha1 as jsha
from opendht_tpu_torch.ops import sha1 as tsha

from torch_port_cases import assert_same, to_torch

MAX_BYTES = 200
C_WORDS = MAX_BYTES // 4 + 1


def _pack(msg: bytes, c_words: int) -> np.ndarray:
    """Big-endian packed words, zero past the message."""
    return np.frombuffer(msg + bytes(4 * c_words - len(msg)), ">u4").astype(
        np.uint32)


def _digest(msg: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha1(msg).digest(), ">u4").astype(np.uint32)


@pytest.fixture(autouse=True)
def _jax_op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def messages():
    r = np.random.default_rng(0)
    return [bytes(r.integers(0, 256, n, dtype=np.uint8))
            for n in range(MAX_BYTES + 1)]


def test_sha1_bytes_every_length(messages):
    content = np.stack([_pack(m, C_WORDS) for m in messages])
    n_bytes = np.array([len(m) for m in messages], np.int32)
    want = np.stack([_digest(m) for m in messages])
    got = tsha.sha1_bytes(to_torch(content), torch.from_numpy(n_bytes))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert_same([jsha.sha1_bytes(jnp.asarray(content), jnp.asarray(n_bytes))],
                [got], "sha1_bytes vs JAX")
    blocks_t, nb_t = tsha.sha1_pad_blocks(to_torch(content),
                                          torch.from_numpy(n_bytes))
    blocks_j, nb_j = jsha.sha1_pad_blocks(jnp.asarray(content),
                                          jnp.asarray(n_bytes))
    assert_same([blocks_j, nb_j], [blocks_t, nb_t], "sha1_pad_blocks")
    assert [tsha.n_blocks_for(n) for n in (0, 55, 56, 64, 119, 120)] == [
        jsha.n_blocks_for(n) for n in (0, 55, 56, 64, 119, 120)] == [
        1, 1, 2, 2, 2, 3]


def test_sha1_one_block_le55(messages):
    short = messages[:56]
    content = np.stack([_pack(m, 14) for m in short])
    n_bytes = np.array([len(m) for m in short], np.int32)
    block = tsha.sha1_pad_le55(to_torch(content), torch.from_numpy(n_bytes))
    assert_same([jsha.sha1_pad_le55(jnp.asarray(content),
                                    jnp.asarray(n_bytes))], [block],
                "sha1_pad_le55")
    got = tsha.sha1_one_block(block)
    assert np.array_equal(got.numpy(), np.stack(
        [_digest(m) for m in short]).astype(np.int64))


@pytest.mark.parametrize("w", [0, 1, 4, 8, 13, 14, 15, 16, 30, 50])
def test_sha1_words_fixed_width(w):
    """Rows of ``4·w`` bytes: 13 words = 52 B (one block), 14 = 56 B
    (two), 16 = 64 B, 30 = 120 B (three)."""
    pl = np.random.default_rng(w).integers(0, 2**32, (9, w), dtype=np.uint32)
    want = np.stack([_digest(r.astype(">u4").tobytes()) for r in pl])
    got = tsha.sha1_words(to_torch(pl))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert_same([jsha.sha1_words(jnp.asarray(pl))], [got], "sha1_words")
