"""The intra-op thread pin that every port test module imports.

    from torch_threads import one_intra_op_thread  # noqa: F401

An autouse fixture imported into a test module applies to every test in it.
This module is not collected (its name does not start with ``test_``) and
imports only pytest and torch, so the card's test runs (``--noconftest``, no
JAX) can import it too. It is imported by its own name, from ``tests/``, which
pytest puts on ``sys.path`` for the test modules there: an installed
regular package named ``tests`` would shadow ``tests.torch_threads``.
``tests/test_torch_threads.py`` checks that every ``tests/test_torch_*.py``
imports it and defines no pin of its own.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module: the suite runs in several worker
    processes on shared cores, where each torch process's full thread pool
    makes small ops wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
