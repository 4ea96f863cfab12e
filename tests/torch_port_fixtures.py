"""Fixtures the port's tests (``tests/test_torch_*.py``) share.

``_no_leaked_children_or_shm`` takes the place of the suite-wide leak audit
of ``tests/conftest.py`` (same name) in each port test module that imports
it. That audit compares the machine's whole ``/dev/shm`` before and after a
test. Under ``pytest -n``, a ``tdl_etl_*`` ring that ``test_etl_service.py``
creates in another worker process while a port test runs is then reported
as the port test's leak (an ERROR at its teardown, though its body passed),
and unlinked under the ETL service that still uses it. This audit checks
the same two things for what this process can leak: its own live child
processes, and the ``tdl_*`` segments named after this process's pid (the
ETL service names its rings ``tdl_etl_<pid>_<id>``) or after no pid.

``tf32``, ``truncate_tf32``, ``split`` and ``product`` model the float32
kernels' products on the TF32 tensor cores (3xTF32, ``csrc/attention_tiles.cuh``
``split_tf32``) for the CPU numerics models of the forward and backward
kernels.
"""

import multiprocessing as mp
import os
import re
import time

import pytest
import torch

_SHM_DIR = "/dev/shm"
_CREATOR_PID = re.compile(r"^tdl_[a-z]+_(\d+)_")


def _own_tdl_shm_segments():
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:  # non-Linux: no visible shm namespace to audit
        return set()
    pid = str(os.getpid())
    own = set()
    for name in names:
        if not name.startswith("tdl_"):
            continue
        m = _CREATOR_PID.match(name)
        if m is None or m.group(1) == pid:
            own.add(name)
    return own


@pytest.fixture(autouse=True)
def _no_leaked_children_or_shm():
    """Fail a test that leaves live child processes of this process, or
    shared-memory segments this process created, behind; clean them up
    after the failure is recorded."""
    before = _own_tdl_shm_segments()
    yield
    leaked_procs = []
    children = mp.active_children()  # also reaps finished children
    if children:
        deadline = time.monotonic() + 3.0  # grace: normal teardown in flight
        for p in children:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        leaked_procs = [p.name for p in children if p.is_alive()]
        for p in children:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)
    leaked_shm = _own_tdl_shm_segments() - before
    for name in leaked_shm:
        try:
            os.unlink(os.path.join(_SHM_DIR, name))
        except OSError:
            pass
    assert not leaked_procs and not leaked_shm, (
        f"test leaked live child processes {leaked_procs} and/or "
        f"shared-memory segments {sorted(leaked_shm)}")


def tf32(x):
    """x rounded to TF32 as the kernels' ``split_tf32`` does: add half of
    the 13 dropped mantissa bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x):
    """x as the tensor core reads a float32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) as the products see them: hi rounded, lo = x - hi
    truncated."""
    hi = tf32(x)
    return hi, truncate_tf32(x - hi)


def product(a, b, terms):
    """a @ b as the kernels compute it: 3xTF32, or one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread: the NLP trainers' many small
    ops on the default pool of one thread per core spin against the other
    busy test processes of a parallel run (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
