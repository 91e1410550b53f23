"""barf_step_mfu: a BARF step's share of one H100's peak, in percent, by
step_mfu.py's reader: the census's ``step_floor_s`` (census/barf_counts.py)
over the traced window's mean step time."""
from benchmark.metrics.step_mfu import read  # noqa: F401
