"""One intra-op thread a process for the port's CPU tests.

The tests run under pytest-xdist: several worker processes share the
host's cores, and each worker imports every test module. PyTorch's
default intra-op pool takes a thread per core in every worker, so the
pools oversubscribe the cores and spin waiting on each other. On an
8-core host, six concurrent runs of tests/test_torch_flash_bwd.py took
172 s with the default pools and 20 s with one thread each. Every port
test module imports this one, so the setting holds in each worker
whatever files it runs; the JAX package's tests do not use torch.
"""
import torch

torch.set_num_threads(1)
