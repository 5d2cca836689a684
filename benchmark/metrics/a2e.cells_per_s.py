"""Cells a second of the emission stage (A2E): the leaf cells over the
stage's seconds (timings["a2e"], which ends with the emission on the
host)."""


def read(view):
    vals = [r["leaves"] / t["a2e"] for r in view["runs"]
            for t in r["timings"] if t.get("a2e")]
    return sum(vals) / len(vals) if vals else None
