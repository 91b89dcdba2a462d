"""The describe layer's share of its roofline, in per cent: its least time at
the published peaks (``work.py::describe_least_s``, from shapes and slots)
over the card's busy time (union of its operations) inside the layer's
spans (traced run). Nothing where the layer ran no span or the card
recorded no operation in them."""


def read(summary):
    spans = summary.get("spans", {}).get("describe")
    least = summary.get("least", {}).get("describe")
    if not spans or not least:
        return None
    device = sum(dev for _, dev in spans)
    if device <= 0:
        return None
    return 100.0 * sum(least) / device
