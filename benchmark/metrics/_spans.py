"""The port's own spans and counters (``utils/profiling.py``), read from
its process recorder. In a run only the profiled stretch of a ``--trace
1`` run records there (the profiler turns the port's recording on), so
these are that stretch's. Under the profiler each operation costs more on
the host, so the times read higher than in an unprofiled call: compare
them between commits, not with the window's times. A package without the
recorder, or without the span, gives None."""


def summary():
    """The port's ``profiling.summary()``, or None without one."""
    from soccerplayershapepose_torch.utils import profiling
    read = getattr(profiling, "summary", None)
    return None if read is None else read()


def _matches(path: str, leaf, under: str) -> bool:
    names = path.split("/")
    return names[-1] in leaf and (under is None or under in names[:-1])


def total_ms(summ: dict, leaf, under: str = None) -> float:
    """Total host ms of the spans whose name is in ``leaf`` (inside a span
    named ``under``, where given)."""
    return sum(r["total_ns"] for p, r in summ["spans"].items()
               if _matches(p, leaf, under)) / 1e6


def count(summ: dict, leaf) -> int:
    return sum(r["count"] for p, r in summ["spans"].items()
               if _matches(p, leaf, None))


def per_fit_iter(parts):
    """``parts(summ)`` in ms over the profiled batch's ``fit.iter`` spans,
    or None where the port records none."""
    summ = summary()
    if not summ:
        return None
    n = count(summ, ("fit.iter",))
    return parts(summ) / n if n else None


SMPL = ("smpl.forward",)
RASTER = ("raster.fwd", "raster.bwd")
