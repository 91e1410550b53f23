"""kept_slot_use: the share of the sample slots the renderer keeps that
hold a live sample, valid_frac / kept_frac of the step's statistics
(render/renderer.py), in percent, averaged over the traced steps."""


def read(ctx):
    use = [s["valid_frac"] / s["kept_frac"] for s in ctx.stats
           if s.get("kept_frac")]
    return 100.0 * sum(use) / len(use) if use else None
