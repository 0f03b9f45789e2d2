"""Milliseconds per frame of the pipeline's ``roi_align`` stage, from its
synchronised stage times over the traced window."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("roi_align")
    if not spans:
        return None
    return 1e3 * sum(spans) / ctx["units"]
