"""idle_render_ms: device idle milliseconds a traced step while the host
is inside the renderer (render/renderer.py render_rays: jt.render and
jt.render.sample, .density, .appearance), by time interval
(benchmark/attribution.py)."""
from benchmark import attribution


def read(ctx):
    return attribution.idle_ms(ctx, "render")
