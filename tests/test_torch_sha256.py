"""The port's batched SHA-256 on the CPU: ``pad_messages`` bit-equal to
the JAX package's, the plain version ``sha256_blocks_ref`` against the
JAX ``sha256_blocks_jit`` and against ``hashlib`` (every length 0-300,
the padding boundaries, ragged batches with padding blocks past a
message's count), and ``sha256_host(device="cpu")`` against the JAX
``sha256_host``.  Bit-exact throughout."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fabric_tpu.ops import sha256 as jsha
from fabric_tpu_torch.ops import sha256 as psha

BOUNDARIES = (0, 55, 56, 63, 64, 119, 120)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msgs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.bytes(int(n)) for n in lengths]


def _plain(blocks, nb):
    out = psha.sha256_blocks(torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nb))
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("max_blocks", [None, 8])
def test_pad_messages_matches_reference(max_blocks):
    msgs = _msgs(list(range(0, 301, 7)) + list(BOUNDARIES))
    pb, pn = psha.pad_messages(msgs, max_blocks=max_blocks)
    jb, jn = jsha.pad_messages(msgs, max_blocks=max_blocks)
    assert pb.dtype == jb.dtype and np.array_equal(pb, jb)
    assert pn.dtype == jn.dtype and np.array_equal(pn, jn)
    with pytest.raises(ValueError):
        psha.pad_messages([b"x" * 200], max_blocks=2)


@pytest.mark.parametrize("lengths", [list(range(0, 301)), list(BOUNDARIES)],
                         ids=["0-300", "boundaries"])
def test_plain_matches_reference_and_hashlib(lengths):
    msgs = _msgs(lengths, seed=len(lengths))
    blocks, nb = psha.pad_messages(msgs)
    got = _plain(blocks, nb)
    want = np.asarray(jsha.sha256_blocks_jit(jnp.asarray(blocks), jnp.asarray(nb)))
    assert np.array_equal(got, want)
    assert psha.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]


def test_ragged_batch_masks_padding_blocks():
    """Messages of 1-8 blocks in one M = 8 batch, plus counts below a
    message's own (the blocks past the count leave the state as it is)."""
    msgs = _msgs(np.random.default_rng(3).integers(0, 8 * 64 - 9, 64))
    blocks, nb = psha.pad_messages(msgs, max_blocks=8)
    assert nb.min() == 1 and nb.max() == 8
    got = _plain(blocks, nb)
    want = np.asarray(jsha.sha256_blocks_jit(jnp.asarray(blocks), jnp.asarray(nb)))
    assert np.array_equal(got, want)
    assert psha.digests_to_bytes(got) == [hashlib.sha256(m).digest() for m in msgs]
    short = np.maximum(nb - 1, 0).astype(np.int32)
    assert np.array_equal(
        _plain(blocks, short),
        np.asarray(jsha.sha256_blocks_jit(jnp.asarray(blocks), jnp.asarray(short))))


def test_sha256_host_matches_reference():
    msgs = _msgs([0, 1, 55, 56, 200, 200, 119, 120, 300, 64])
    got = psha.sha256_host(msgs, device="cpu")
    assert got == jsha.sha256_host(msgs)
    assert got == [hashlib.sha256(m).digest() for m in msgs]
    assert psha.sha256_host([], device="cpu") == []
    assert psha.sha256_host(msgs[:3], max_blocks=4, device="cpu") == got[:3]


def test_wrapper_checks_operands():
    with pytest.raises(ValueError):
        psha.sha256_blocks(torch.zeros((2, 1, 15), dtype=torch.int32),
                           torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        psha.sha256_blocks(torch.zeros((2, 1, 16), dtype=torch.int64),
                           torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        psha.sha256_blocks(torch.zeros((2, 1, 16), dtype=torch.int32),
                           torch.ones(3, dtype=torch.int32))
