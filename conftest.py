"""Under pytest-xdist, each worker gets its share of the host's cores for
torch's intra-op threads: n = max(1, cores // workers).  Torch's default
of a thread a core, in each of the workers at once, puts several times
more threads on the cores than there are, and the in-process torch tests
then spend most of their time waiting for one.  OMP_NUM_THREADS is set
(unless the environment sets it) so that the subprocesses the tests start
inherit the share.  Outside xdist this file does nothing."""
import os

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    _N = max(1, (os.cpu_count() or 1) // int(_WORKERS))
    os.environ.setdefault("OMP_NUM_THREADS", str(_N))

    import torch

    torch.set_num_threads(_N)
