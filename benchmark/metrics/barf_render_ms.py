"""barf_render_ms: device milliseconds a step under the span ``jt.render``
of BARF's step (train/barf_trainer.py render_mlp_rays): the forward from
the rays to the composite, the MLP's forward included.  A program without
the span has nothing to read."""

RANGES = ("jt.render",)


def read(ctx):
    total = ctx.span.under(RANGES)
    return 1e3 * total / ctx.steps if total > 0 else None
