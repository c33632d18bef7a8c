"""The port's ``entry()`` twin (``diagon_tpu_torch.entry``) against
``__graft_entry__.entry()``: the same tiny corpus flushed into an equal
segment, and the same fused rows (top-k docids, score bits, hits) from the
port's row kernel (its plain version on the CPU) and the JAX step."""

import numpy as np
import pytest

import __graft_entry__ as graft
from diagon_tpu_torch import entry as twin

from test_torch_memory_index import assert_segments_equal


def test_tiny_corpus_equals_jax():
    assert_segments_equal(twin._tiny_corpus(400), graft._tiny_corpus(400))


@pytest.mark.parametrize("n_docs,seed", [(40, 100), (90, 103)])
def test_sharded_corpora_equal_jax(n_docs, seed):
    """The corpora of ``dryrun_multichip``'s shards too."""
    assert_segments_equal(twin._tiny_corpus(n_docs, seed),
                          graft._tiny_corpus(n_docs, seed))


def test_entry_step_equals_jax():
    fn, args = twin.entry(device="cpu")
    jfn, jargs = graft.entry()
    assert len(args) == len(jargs) == 10
    for i, (a, j) in enumerate(zip(args, jargs)):
        a, j = a.numpy(), np.asarray(j)
        if i == 1:
            # the light bank: the JAX package pads its rows to a bucket
            # (a TPU mechanism the port leaves out); the rows are equal
            assert (j[len(a):] == 0).all()
            j = j[:len(a)]
        np.testing.assert_array_equal(a, j)
    got = fn(*args).numpy()
    want = np.asarray(jfn(*jargs))
    assert got.shape == want.shape == (8, 21)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    hits = got[:, -1]
    assert (hits == hits[0]).all() and hits[0] > 0
    docs = got[0, 10:20]
    assert (docs >= 0).all()
