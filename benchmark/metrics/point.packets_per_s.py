"""The external point sources' packets a second: the `ps` source
passes' packets over their seconds (each pass ends after the host has
read its totals), in the cells with a star."""

from benchmark.metrics._rates import pass_rate


def read(view):
    return pass_rate(view["runs"], "source_passes", "ps")
