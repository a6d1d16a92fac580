"""Share of K1's metric evaluations that greedy NMS needs, from the
kernels' own counters over the traced calls: `k1.useful_pairs` (the scan:
n_valid - 1 - i a kept row i < n_valid) over `k1.pairs` (the mask kernel:
64 evaluations a suppression word it builds). Work the mask kernel spends
on rows greedy NMS removes lowers it."""

from portbench import spans


def read(ctx):
    if ctx.driver != "detect":
        return None
    r = spans.reading()
    if r is None or not r.counters.get("k1.pairs") or "k1.useful_pairs" not in r.counters:
        return None
    return 100.0 * r.counters["k1.useful_pairs"] / r.counters["k1.pairs"]
