"""The background passes' packets a second (_rates.background_rate) in
the `rt` cells, where they move packets_per_s."""

from benchmark.metrics._rates import background_rate as read  # noqa: F401
