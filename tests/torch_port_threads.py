"""One torch intra-op thread for the port's CPU tests, set once at import.

Every CPU test file of the port (tests/test_torch_port_*.py but the card
tests, test_torch_port_cuda.py) imports this module, and so does
tests/torch_port_ddp.py, whose spawned ranks import it when they unpickle
their entry. pytest and each of its xdist workers collect every file before
running a test, so a process is on one thread before its first test,
whatever the order of the files. Two reasons:

  * the tier-1 run starts six xdist workers on the host's cores; with
    torch's default of one thread a core they oversubscribe it many times
    over, and the port's tiny graphs lose far more to that than they gain
    from threads;
  * one thread gives the same sums whether a file runs alone or under
    xdist, and from run to run: multithreaded CPU GEMMs and backward passes
    are not bitwise reproducible, and the data-parallel tests hold their
    ranks to one process's result at 1e-5 and to each other bitwise.

Numpy's BLAS keeps its own threads; only torch's are set here.
"""
import torch

torch.set_num_threads(1)
