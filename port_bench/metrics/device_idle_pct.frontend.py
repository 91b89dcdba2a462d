"""The card's idle share of the traced stretch that runs the loop as an
untraced run does (no syncs between layers), in per cent: 100 minus the
union of its operations' intervals over the stretch. Nothing where the
card recorded no operation."""


def read(summary):
    loop = summary.get("loop")
    if not loop or loop["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - loop["busy_s"] / loop["window_s"])
