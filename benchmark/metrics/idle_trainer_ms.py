"""idle_trainer_ms: device idle milliseconds a traced step while the host
is inside the Trainer's own spans (train/trainer.py: jt.trainer.schedule,
.upload, .update_schedule, .blur_cache, .blur_mask, .log_point), by time
interval (benchmark/attribution.py).  Prints the whole idle split of the
window on standard error: the four idle metrics, any jt. span, and the
idle time outside every one."""
import sys

from benchmark import attribution


def read(ctx):
    value = attribution.idle_ms(ctx, "trainer")
    if value is not None:
        print(attribution.idle_split(ctx), file=sys.stderr, flush=True)
    return value
