"""Milliseconds per frame of the pipeline's ``predict`` stage, from its
synchronised stage times over the traced window."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("predict")
    if not spans:
        return None
    return 1e3 * sum(spans) / ctx["units"]
