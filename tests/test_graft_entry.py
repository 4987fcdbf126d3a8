"""The driver entry contract: entry() jits single-chip; dryrun_multichip
compiles+executes the sharded step on an 8-device mesh."""

import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_jits_and_runs():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out[0].shape == args[0].shape


@pytest.mark.slow
def test_dryrun_multichip_8():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)
