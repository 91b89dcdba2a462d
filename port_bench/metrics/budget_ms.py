"""The ranked feature budget's card time, mean milliseconds a batch: the
union of the card operations launched inside the program's
``sift.describe.budget`` range, from a profiled staged stretch of the
traced run (``runners/photos.py``). Nothing where the program has no such
range."""


def read(summary):
    busy = summary.get("budget_s")
    if not busy:
        return None
    return 1e3 * sum(busy) / len(busy)
