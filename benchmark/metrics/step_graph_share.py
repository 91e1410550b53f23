"""step_graph_share: the share of the traced steps replayed from a CUDA
graph (joint_tensorf_tpu_torch/train/graph_step.py), in percent: the
program's ``jt.step.graph`` ranges, one around each replay, over the
traced steps.  A program without the range (no step replayed) has
nothing to read."""
from torch.autograd import DeviceType

RANGE = "jt.step.graph"


def read(ctx):
    n = sum(1 for e in ctx.span.events
            if e.device_type == DeviceType.CPU and e.name == RANGE)
    if n == 0 or ctx.steps == 0:
        return None
    return 100.0 * n / ctx.steps
