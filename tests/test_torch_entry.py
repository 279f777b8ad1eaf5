"""``parallel.dryrun.entry`` against ``__graft_entry__.entry`` of the JAX
package: the same two tiny full-u32 batches (seeds 1 and 2) through the
fast ``call_batch`` with no joint priors.  Every field is an integer and
must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as graft  # noqa: E402

from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.parallel import dryrun  # noqa: E402


def test_entry_batches_equal_the_jax_ones():
    _, (tb, nb) = dryrun.entry("cpu")
    _, (jtb, jnb) = graft.entry()
    for got, want in ((tb, jtb), (nb, jnb)):
        assert got.n_keep is None and got.slots.device.type == "cpu"
        np.testing.assert_array_equal(
            got.slots.numpy().view(np.uint32), np.asarray(want.slots))
        np.testing.assert_array_equal(got.depth.numpy(),
                                      np.asarray(want.depth))
        np.testing.assert_array_equal(got.ref16.numpy(),
                                      np.asarray(want.ref16))


def test_entry_on_cpu_matches_the_jax_entry():
    fn, args = dryrun.entry("cpu")
    gk.reset_launches()
    got = fn(*args)
    assert not any(gk.LAUNCHES.values())  # the CPU launches no kernel
    jfn, jargs = graft.entry()
    want = jfn(*jargs)
    assert got._fields[:len(want._fields)] == want._fields or \
        set(want._fields) <= set(got._fields)
    assert int(got.emit.sum()) > 0
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(
            a.numpy().astype(np.int64), np.asarray(b).astype(np.int64), name)
    # a second call gives the same result
    again = fn(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
