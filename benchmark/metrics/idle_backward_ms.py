"""idle_backward_ms: device idle milliseconds a traced step while the host
waits in autograd's backward (train/step.py: jt.step.backward around
torch.autograd.grad), by time interval (benchmark/attribution.py): the
backward's launches run on autograd's own thread, inside that interval."""
from benchmark import attribution


def read(ctx):
    return attribution.idle_ms(ctx, "backward")
