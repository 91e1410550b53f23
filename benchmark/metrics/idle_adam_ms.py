"""idle_adam_ms: device idle milliseconds a traced step while the host
runs the field's and the poses' Adam updates (train/optim.py, called in
train/step.py's jt.step.adam), by time interval
(benchmark/attribution.py)."""
from benchmark import attribution


def read(ctx):
    return attribution.idle_ms(ctx, "adam")
