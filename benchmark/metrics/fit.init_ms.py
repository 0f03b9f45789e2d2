"""Milliseconds per batch of the regressor initialisation
(``predict_smpl``), synchronised, over the traced window's batches."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("predict")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
