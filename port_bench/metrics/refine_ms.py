"""The refine layer's span, mean milliseconds a batch: called from the
benchmark in a span of its own that ends in a synchronise (traced run)."""


def read(summary):
    spans = summary.get("spans", {}).get("refine")
    if not spans:
        return None
    return 1e3 * sum(host for host, _ in spans) / len(spans)
