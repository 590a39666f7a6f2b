"""``fallbacks_per_query.read``: the lookup engine's re-resolved escapes
(``QueryEngine.stats["fallbacks"]`` over the window) per query sent."""


def read(run):
    lay = run.layer
    if "fallbacks" not in lay or not lay.get("queries"):
        return None
    return lay["fallbacks"] / lay["queries"]
