"""Milliseconds per fit iteration: the synchronised wall of each
``single_view_fit`` call of the traced window over its iterations."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("fit")
    if not spans:
        return None
    return 1e3 * sum(spans) / (len(spans) * ctx["iters"])
