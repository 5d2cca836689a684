"""The background passes' packets a second (_rates.background_rate) in
the `pipeline` cells' absorption run, where they move run_s."""

from benchmark.metrics._rates import background_rate as read  # noqa: F401
