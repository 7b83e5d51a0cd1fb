"""The port's tests' thread policy, shared by name.

The tier runs several test processes on the machine's cores, and each
would otherwise start a torch, BLAS and OpenMP thread pool of them all:
the many small operations of these tests then wait on each other's pools.
A test module takes the policy with

    from torch_port_threads import _one_thread  # noqa: F401

(or ``_one_thread_tsne`` where it runs the port's t-SNE, whose native
library is loaded first so that its OpenMP team is limited too).
"""

import pytest
import torch


def _limited():
  from threadpoolctl import threadpool_limits
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  with threadpool_limits(1):
    yield
  torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
  """One torch, BLAS and OpenMP thread for the module's tests."""
  yield from _limited()


@pytest.fixture(autouse=True, scope="module")
def _one_thread_tsne():
  """``_one_thread`` with the port's t-SNE library loaded first."""
  from sisua_tpu_torch import native
  native.load("tsne")
  yield from _limited()
